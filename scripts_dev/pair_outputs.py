"""Every pool item of a benchmark cell through the program once, the
outputs saved: for a bit-for-bit comparison of two trees of the port on
the same seed (``--compare A B``).

    python3 scripts_dev/pair_outputs.py --workload kitti-pair --seed N --out FILE
    python3 scripts_dev/pair_outputs.py --compare A B

from the root of the tree whose program runs (its ``benchmark/`` drives it).
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        for p in sorted(a):
            diff = [k for k in a[p] if not torch.equal(a[p][k], b[p][k])]
            print(json.dumps({"item": p, "keys": len(a[p]), "differ": diff}))
        return 0
    sys.path.insert(0, str(ROOT / "benchmark"))
    sys.path.insert(1, str(ROOT))
    from benchlib import harness

    cell = harness.Cell.load(ROOT, args.workload)
    drv = cell.driver(args.seed, torch.device("cuda"))
    drv.setup()
    out = {}
    for p in drv.items():
        got = drv.run_one(p)
        out[int(p)] = {k: v.detach().cpu().clone() for k, v in got.items()}
    torch.save(out, args.out)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "items": len(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
