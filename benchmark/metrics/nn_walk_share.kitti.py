"""nn_walk_share.kitti (%): the query x reference rows kernel B's walked
tiles cover, over the padded N x M of its calls (the program's counters
``nn.rows_walked`` and ``nn.rows_full``, tallied on the card by each launch
and read after each traced replay), summed over the traced KITTI pairs: the
share of the padded search the kernel still does once it walks only the
valid spans. None where the program keeps no such counters. Moves
kitti_pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    full = 0 if rec is None else rec["counters"].get("nn.rows_full", 0)
    return 100.0 * rec["counters"].get("nn.rows_walked", 0) / full if full else None
