"""a_walk_share.dgr (%): the live entries of the maps kernel A's wide-K
variant walked over the row slots of its walk (``conv.entries_live`` over
``conv.slots_walked``: a (row tile × live offset) step covers 128 row
slots; both tallied on the card by each launch and read after each traced
replay), summed over the traced DGR pairs: the share of the gathers that
fetch a live row. None where the program keeps no such counters. Moves
pairs_per_s."""
from benchlib import dgr_arith


def read(run):
    return dgr_arith.counter_share("conv.entries_live", "conv.slots_walked")
