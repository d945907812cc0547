"""CUDA synchronizations inside the program's tracking `frame` spans
(utils/timer.py's count, by CUDA sync debug mode) over the traced tracking
frames (layer: driver)."""

from portbench import program


def read(ctx):
    frames = program.named(program.spans(ctx), "frame", branch="track")
    return sum(s.syncs for s in frames) / len(frames) if frames else None
