"""pad_share.extract (%): 1 - the voxels over the rows of the bucket the
bucketed extractor picked for them (its counters ``extract.rows_valid`` and
``rows_padded``), summed over the traced fragments: the share of the
forward graph's rows that are padding. Moves fragments_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    return None if rec is None else program_trace.pad_share(rec, "extract")
