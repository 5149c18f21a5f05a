"""idle_share.dgr (%): the share of the traced window in which the device
ran nothing on DGR's pair path: 1 - (the union of every kernel, copy and
set interval in the window) / the window's wall time, overlapping
operations counted once. Moves pairs_per_s."""
from benchlib import readers


def read(run):
    return readers.idle_share(run)
