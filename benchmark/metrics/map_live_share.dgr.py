"""map_live_share.dgr (%): the live entries of the 6-D maps kernel A's
wide-K variant reads, over their slots (``conv.entries_live`` over
``conv.map_slots``: N × 729 a conv's map, padding rows included; the live
entries tallied on the card by each launch, read after each traced
replay), summed over the 20 k3 convs of the traced DGR pairs. None where
the program keeps no such counters. Moves pairs_per_s."""
from benchlib import dgr_arith


def read(run):
    return dgr_arith.counter_share("conv.entries_live", "conv.map_slots")
