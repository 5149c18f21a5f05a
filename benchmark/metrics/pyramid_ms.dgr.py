"""pyramid_ms.dgr (ms): the device ms of the stage ``dgr.pyramid`` (the
6-D tables and maps) in a replay of DGR's pair graph, from the graph's
timing events, the median over the traced replays; profiler-inflated, as
every stage metric. Moves pairs_per_s."""
from benchlib import dgr_arith


def read(run):
    return dgr_arith.stage_ms(run, "dgr.pyramid")
