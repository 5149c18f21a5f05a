"""copy_out_ms.extract (ms): the ms a fragment's call spends inside the
program's ``extract.copy_out`` span (the points and descriptors copied to
host arrays), the median over the traced fragments. Moves
fragments_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None:
        return None
    return program_trace.median_ms_in_units(run, rec, lambda n: n == "extract.copy_out")
