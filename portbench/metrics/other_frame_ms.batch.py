"""other_frame_ms, read in the batch cells (readers.other_frame_ms)."""

from portbench import readers


def read(run):
    return readers.other_frame_ms(run)
