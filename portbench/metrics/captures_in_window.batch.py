"""captures_in_window, read in the batch cells (readers.captures_in_window)."""

from portbench import readers


def read(run):
    return readers.captures_in_window(run)
