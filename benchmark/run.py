"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration; ``benchmark/workloads/<cell>.json`` names its driver
(``benchmark/drivers/<driver>.py``), its traffic and its limits;
``benchmark/configs/<config>.json`` holds the configuration as it is run;
each per-layer metric is read by ``benchmark/metrics/<metric>.py``. See
``benchmark/README.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "imfnet_tpu")


def _env() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    library may load JAX behind the program's back."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from benchlib import harness

    cell = harness.Cell.load(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), t_start=T_START, device="cuda")
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
