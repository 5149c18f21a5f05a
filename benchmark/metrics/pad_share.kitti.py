"""pad_share.kitti (%): 1 - the valid rows over the padded rows of the scan
pairs' batches as ``batch_to_device`` moves them (its counters
``trainer.stage.rows_valid`` and ``rows_padded``: both sides, padded to
``max_points``), summed over the traced pairs: the share of the rows kernel
B and the forwards run that are padding. Moves kitti_pairs_per_s."""
from benchlib import program_trace


def read(run):
    rec = program_trace.record()
    return None if rec is None else program_trace.pad_share(rec, "trainer.stage")
