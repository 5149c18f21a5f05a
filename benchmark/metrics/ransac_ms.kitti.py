"""ransac_ms.kitti (ms): the device ms of the stage ``registration.ransac``
(RANSAC over every voxel and the metrics) in a replay of eval-kitti's pair
graph, from the graph's timing events, the median over the traced
replays. Moves kitti_pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    return None if rec is None else program_trace.stage_ms(run, rec, "registration.ransac")
