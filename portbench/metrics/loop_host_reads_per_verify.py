"""CUDA synchronizations inside the program's `loop_verify` spans over the
verifications (layer: loop closer): the uploads of the two records and the
`loop_verify` reads."""

from portbench import program


def read(ctx):
    spans = program.named(program.spans(ctx), "loop_verify")
    return sum(s.syncs for s in spans) / len(spans) if spans else None
