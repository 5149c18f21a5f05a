"""read_wait_ms.extract (ms): the ms a fragment's call spends inside the
program's ``extract.read`` spans, where the host waits for the voxel count
and for ``coarse_levels_fit`` from the card, the median over the traced
fragments. Also notes the window's idle time by the innermost span open
over it. Moves fragments_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None:
        return None
    program_trace.note_idle(run, rec)
    return program_trace.median_ms_in_units(run, rec, lambda n: n == "extract.read")
