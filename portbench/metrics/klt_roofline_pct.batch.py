"""klt_roofline_pct, read in the batch cells (readers.klt_roofline_pct)."""

from portbench import readers


def read(run):
    return readers.klt_roofline_pct(run)
