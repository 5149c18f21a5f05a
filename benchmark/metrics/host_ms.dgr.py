"""host_ms.dgr (ms): the ms a DGR pair's call spends inside the program's
span ``dgr.pad``, the host's work before the graph's replay (both scans
padded to 131 072 rows, pinned and copied to the card), the median over
the traced pairs. None where the program keeps no such span. Moves
pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None:
        return None
    return program_trace.median_ms_in_units(run, rec, lambda n: n == "dgr.pad")
