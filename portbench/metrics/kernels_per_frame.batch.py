"""kernels_per_frame, read in the batch cells (readers.kernels_per_frame)."""

from portbench import readers


def read(run):
    return readers.kernels_per_frame(run)
