"""forward_ms.pair (ms): the device ms of the stage ``pipeline.forward``
(the model's forward over both fragments) in a replay of the pair's CUDA
graph, from the timing events the graph records at its stage boundaries,
the median over the traced replays. Moves pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    return None if rec is None else program_trace.stage_ms(run, rec, "pipeline.forward")
