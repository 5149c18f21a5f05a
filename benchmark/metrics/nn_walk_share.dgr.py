"""nn_walk_share.dgr (%): the query x reference rows kernel B's walked
tiles cover, over the padded N x M of its calls (the program's counters
``nn.rows_walked`` and ``nn.rows_full``, tallied on the card by each launch
and read after each traced replay), summed over the traced DGR pairs: the
share of the padded one-way search the kernel does. None where the program
keeps no such counters. Moves pairs_per_s."""
from benchlib import dgr_arith


def read(run):
    return dgr_arith.counter_share("nn.rows_walked", "nn.rows_full")
