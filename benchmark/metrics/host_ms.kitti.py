"""host_ms.kitti (ms): the median, over the pairs of the untraced window, of
the time from a pair's start, its collated host batch in hand, until the
program's call returns (the ``call`` span): ``batch_to_device``'s staging,
the registration's draws, the graph's copy-in and launch. Moves
kitti_pairs_per_s."""


def read(run):
    return run.median_ms("call")
