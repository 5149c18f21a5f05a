"""Data parallelism over ``torch.distributed``: ranks (``mesh``) and the
data-parallel step, sharded extraction and evaluation (``dp``)."""
