"""nn_walk_share.pair (%): the query x reference rows kernel B's walked
tiles cover, over the N x M of its calls (the program's counters
``nn.rows_walked`` and ``nn.rows_full``, tallied on the card by each launch
and read after each traced replay), summed over the traced 3DMatch pairs:
100 where every keypoint is valid and the walk is the whole one. None where
the program keeps no such counters. Moves pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    full = 0 if rec is None else rec["counters"].get("nn.rows_full", 0)
    return 100.0 * rec["counters"].get("nn.rows_walked", 0) / full if full else None
