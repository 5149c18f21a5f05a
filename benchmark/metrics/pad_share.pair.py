"""pad_share.pair (%): 1 - the voxels over the rows of the 2-batch bucket
``PairRegistrar.quantize`` picked for them (its counters
``pipeline.quantize.rows_valid`` and ``rows_padded``), summed over the
traced pairs: the share of the graph's rows that are padding. Moves
pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    return None if rec is None else program_trace.pad_share(rec, "pipeline.quantize")
