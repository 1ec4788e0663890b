"""kf_frame_ms, read in the batch cells (readers.kf_frame_ms)."""

from portbench import readers


def read(run):
    return readers.kf_frame_ms(run)
