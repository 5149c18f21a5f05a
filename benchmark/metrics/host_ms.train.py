"""host_ms.train (ms): the median, over the steps of the untraced window,
of the time from a step's start until the program's call returns (the
``call`` span): the batch's staging, the loss draws, the schedule, the
graph's copy-in and launch. Moves train_steps_per_s."""


def read(run):
    return run.median_ms("call")
