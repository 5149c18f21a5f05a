"""backward_ms.train (ms): the device ms of the stage ``step.backward`` (the
loss's backward: dX through kernel A, dW's products) in a replay of the
training step's CUDA graph, from the graph's timing events, the median
over the traced steps. Moves train_steps_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    return None if rec is None else program_trace.stage_ms(run, rec, "step.backward")
