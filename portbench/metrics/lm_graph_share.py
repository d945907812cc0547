"""The share of window BA's LM attempts (the program's `lm_attempt` spans
under a `ba` span) that were one replay of a CUDA graph, by the spans'
`graph` attribute; nothing where the spans have no such attribute, as a
program from before the graphs has not (layer: window BA)."""

from portbench import program


def read(ctx):
    attempts = program.under(program.spans(ctx), "lm_attempt", "ba")
    if not any("graph" in a.attrs for a in attempts):
        return None
    return sum(a.attrs.get("graph") == 1 for a in attempts) / len(attempts)
