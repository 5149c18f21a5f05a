"""read_wait_ms.pair (ms): the ms a 3DMatch pair's call spends inside the
program's ``*.read`` spans, where the host waits for a value from the card
(``pipeline.quantize.read``: the voxel count that picks the bucket), the
median over the traced pairs. Moves pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None:
        return None
    return program_trace.median_ms_in_units(run, rec, lambda n: n.endswith(".read"))
