"""Shared set-up of the benchmark's own tests: the harness's folders on the
path, cells cut to sizes a CPU test run can hold, and the ``cuda`` fixture
(a test that needs the card skips without one)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the cells at CPU-test sizes: the same model at its published widths, few
# and small clouds, fewer RANSAC hypotheses
SMALL = {
    "3dmatch-pair": {"workload.traffic": {"slots": [8192, 8192], "points": 20000, "fill": 0.3,
                                          "overlap": [0.3, 0.9], "image_hw": [120, 160]},
                     "workload.check": {"pairs": 2}},
    "3dmatch-extract": {"workload.traffic": {"slots": [8192, 8192], "points": 20000,
                                             "fill": 0.3, "overlap": [0.3, 0.9],
                                             "image_hw": [120, 160]},
                        "workload.check": {"fragments": 2}},
    "kitti-pair": {"workload.traffic": {"pool": 1, "world_points": 60000, "radius_m": 12.0,
                                        "baseline_m": [10.0, 12.0], "yaw_deg": 10.0,
                                        "points": 12000, "noise_m": 0.01,
                                        "image_hw": [120, 160]},
                   "workload.program_overrides": {"max_points": 8192,
                                                  "ransac_max_iteration": 12500},
                   "workload.check": {"pairs": 1}},
    "3dmatch-train": {"workload.program_overrides": {"level_capacity_divisors": [1, 2, 4, 8],
                                                     "max_points": 8192},
                      "workload.traffic": {"slots": [8192] * 6, "points": 8000, "fill": 0.15,
                                           "overlap": [0.3, 0.9], "image_hw": [120, 160],
                                           "steps_per_epoch": 1000}},
}


def small_cell(name):
    """The cell ``name`` with its files as the harness finds them, cut to
    the sizes of ``SMALL``."""
    from benchlib import harness

    cell = harness.Cell.load(ROOT, name)
    for key, value in SMALL[name].items():
        part, field = key.split(".", 1)
        getattr(cell, part)[field] = value
    if "workload.program_overrides" in SMALL[name]:
        cell.config["program"]["overrides"].update(SMALL[name]["workload.program_overrides"])
    return cell


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
