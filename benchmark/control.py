"""Readings that the limits of a cell's check are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 ...

For each seed: the cell's set-up, every pair of its pool through the
program's timed path, judged as a run judges it (the program's readings);
then the control, the reference computed in float8 e4m3 (the precision
below the configurations' bfloat16) in the program's place, judged the same
way (the control's readings); in a training cell also the fault "half of
the batch left out" (the loss over the first pair of each batch, the
forwards whole). Prints one JSON line a seed with the widest value of
each number on each side. The benchmark's runs do not run this.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def readings(cell, seed: int, device: str, prec: str = "fp8"):
    import torch

    from benchlib import regcheck
    from reference.precision import Precision

    drv = cell.driver(seed, torch.device(device))
    drv.setup()
    if hasattr(drv, "reference_steps"):
        return train_readings(drv, prec)
    port = []
    for p in drv.items():
        port.append((p, drv.snapshot_of(p, drv.run_one(p))))
    drv.release()
    P = regcheck.ref_params(drv.P)
    rows_port, rows_ctl = [], []
    for p, snap in port:
        ref = drv.reference_of(p, P, Precision("f32"))
        rows_port.append(drv.judge_of(p, snap, ref))
        ctl = drv.control(p, Precision(prec))
        rows_ctl.append(drv.judge_of(p, ctl, ref))
    names = list(cell.workload["limits"])
    return ({n: max(r[n] for r in rows_port) for n in names},
            {n: max(r[n] for r in rows_ctl) for n in names})


def train_readings(drv, prec: str):
    """A training cell's readings: the program's first steps, the control's,
    and the fault "half of the batch left out, the mean over the rest" (the
    reference with the fault put in the program's place), each against the
    f32 reference, and the fault "a state left unchanged" (the reference
    with no update and no optimizer state), which reads 1 by the
    grad_gap's and delta_gap's measure."""
    from reference.precision import Precision

    got = drv.program_steps()
    drv.release()
    ref = drv.reference_steps(Precision("f32"))
    port = drv.compare(got, ref)
    ctl = drv.compare(drv.reference_steps(Precision(prec)), ref)
    half = drv.compare(drv.reference_steps(Precision("f32"), fault="half"), ref)
    unchanged = drv.compare(drv.reference_steps(Precision("f32"), fault="unchanged"), ref)
    return port, ctl, half, unchanged


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="fp8")
    args = ap.parse_args()
    from benchlib import harness

    cell = harness.Cell.load(HERE.parent, args.workload)
    for seed in args.seeds:
        out = readings(cell, seed, args.device, args.precision)
        names = ("program", "control", "fault_half_batch", "fault_unchanged")
        print(json.dumps({"seed": seed, **dict(zip(names, out))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
