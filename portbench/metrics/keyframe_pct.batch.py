"""keyframe_pct, read in the batch cells (readers.keyframe_pct)."""

from portbench import readers


def read(run):
    return readers.keyframe_pct(run)
