"""The share of the keyframe branch's stereo matches (the program's `stereo`
spans) that were one launch of csrc/stereo.cu, by the spans' `kernel`
attribute: 1 for scanline stereo on a card, 0 for KLT stereo; nothing where
the spans have no such attribute, as a program from before the kernel has
not (layer: keyframe branch)."""

from portbench import program


def read(ctx):
    matches = program.named(program.spans(ctx), "stereo")
    if not any("kernel" in s.attrs for s in matches):
        return None
    return sum(s.attrs.get("kernel") == 1 for s in matches) / len(matches)
