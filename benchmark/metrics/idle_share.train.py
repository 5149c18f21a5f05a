"""idle_share.train (%): the share of the traced window in which the device
ran nothing on the training step: 1 - (the union of every kernel, copy and set
interval in the window) / the window's wall time, overlapping operations
counted once. Moves train_steps_per_s."""
from benchlib import readers


def read(run):
    return readers.idle_share(run)
