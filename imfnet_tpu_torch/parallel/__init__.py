"""Data parallelism over ``torch.distributed``: ranks (``mesh``) and the
data-parallel step, sharded extraction and evaluation (``dp``).

The names of ``dp`` load with their first use: ``dp`` imports
``train.step``, which imports ``parallel.mesh``, so importing ``dp`` here
would close a cycle."""
from imfnet_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: F401

_DP_NAMES = (
    "make_emulated_dp_step",
    "make_parallel_eval_forward",
    "make_parallel_registration",
    "make_parallel_train_step",
    "put_stacked",
    "replicate",
    "shard_pair_batches",
    "stack_batches",
)


def __getattr__(name):
    if name in _DP_NAMES:
        from imfnet_tpu_torch.parallel import dp

        return getattr(dp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_DP_NAMES))
