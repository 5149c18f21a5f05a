"""host_ms.pair (ms): the median, over the pairs of the untraced window, of
the time from a pair's start, host arrays in hand, until the program's call
returns (the ``call`` span): the host side of a pair (prepare, quantize and
its voxel-count read, draws, the graph's copy-in and launch). Moves
pairs_per_s."""


def read(run):
    return run.median_ms("call")
