"""ransac_ms.pair (ms): the device ms of the stage ``registration.ransac``
(RANSAC's 50 000 hypotheses and the metrics) in a replay of the pair's
CUDA graph, from the graph's timing events, the median over the traced
replays. Moves pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    return None if rec is None else program_trace.stage_ms(run, rec, "registration.ransac")
