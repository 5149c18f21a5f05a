"""idle_share.kitti (%): the share of the traced window in which the device
ran nothing on eval-kitti's pair path: 1 - (the union of every kernel, copy and set
interval in the window) / the window's wall time, overlapping operations
counted once. Moves kitti_pairs_per_s."""
from benchlib import readers


def read(run):
    return readers.idle_share(run)
