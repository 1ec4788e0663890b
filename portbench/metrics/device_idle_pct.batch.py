"""device_idle_pct, read in the batch cells (readers.device_idle_pct)."""

from portbench import readers


def read(run):
    return readers.device_idle_pct(run)
