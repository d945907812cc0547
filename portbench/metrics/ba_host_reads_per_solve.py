"""CUDA synchronizations inside the program's `ba` spans (window BA, one a
solve) over the solves (layer: window BA)."""

from portbench import program


def read(ctx):
    solves = program.named(program.spans(ctx), "ba")
    return sum(s.syncs for s in solves) / len(solves) if solves else None
