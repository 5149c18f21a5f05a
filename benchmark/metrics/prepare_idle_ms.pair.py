"""prepare_idle_ms.pair (ms): the device-idle ms of a 3DMatch pair under the
program's span ``pipeline.prepare`` (``PairRegistrar.prepare``: padding,
the extent bucket, the moves to the card), the median over the traced
pairs: the idle stretches of the traced window (``benchlib.trace.gaps``)
that fall inside each prepare span. Also notes the window's idle time by
the innermost span open over it. Moves pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None:
        return None
    program_trace.note_idle(run, rec)
    return program_trace.idle_ms_under(run, rec, "pipeline.prepare")
