"""Kernel B's time at the shapes and masks of the port's callers, each call
captured alone in a CUDA graph and timed over its replays (CUDA events),
printed as one JSON line a case, with the card's name and power limit.

    python3 scripts_dev/nn_spans_bench.py [--out FILE] [--dump DIR]

Runs on the tree it sits in (any tree of the port): a tree whose
kernel B takes no query mask searches every query there (``"query_mask":
false`` in its line). ``--dump`` saves each case's (index, d²) for a
comparison of two trees (``--compare A B``).
"""
import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def unit_rows(gen, k, d):
    x = torch.randn((k, d), generator=gen, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


def cases():
    """(name, n, m, d, queries valid or None, references valid or None)."""
    out = []
    k = 131072
    j = torch.arange(k, device="cuda")
    out.append(("kitti.all_valid", k, k, 32, None, None))
    for nq in (50688, 63360, 67000, 76032):
        out.append((f"kitti.prefix_{nq}", k, k, 32, j < nq, j < 67010))
    out.append(("kitti.prefix_67000.refs_only", k, k, 32, None, j < 67010))
    j = torch.arange(65536, device="cuda")
    out.append(("train.segment", 65536, 65536, 3, None, (j >= 27111) & (j < 27111 + 26980)))
    out.append(("train.all_valid", 65536, 65536, 3, None, None))
    j = torch.arange(5000, device="cuda")
    out.append(("pair.all_valid", 5000, 5000, 32, j >= 0, j >= 0))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--dump")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        a, b = args.compare
        for name in sorted(os.listdir(a)):
            x, y = torch.load(os.path.join(a, name)), torch.load(os.path.join(b, name))
            ok = x["query_valid"]
            same = (torch.equal(x["idx"][ok], y["idx"][ok])
                    and torch.equal(x["d2"][ok], y["d2"][ok]))
            print(json.dumps({"case": name, "valid_queries_bit_equal": same,
                              "valid_queries": int(ok.sum())}))
        return 0
    from imfnet_tpu_torch.match.nn_kernel import flash_nn
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for name, n, m, d, q_ok, r_ok in cases():
        q, r = unit_rows(gen, n, d), unit_rows(gen, m, d)
        try:
            flash_nn(q, r, r_ok, q_ok)
            masked = True

            def call():
                return flash_nn(q, r, r_ok, q_ok)
        except TypeError:
            masked = False

            def call():
                return flash_nn(q, r, r_ok)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            call()
            with torch.cuda.graph(g, stream=s):
                out = call()
        torch.cuda.current_stream().wait_stream(s)
        g.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ms = []
        for _ in range(args.iters):
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        ms.sort()
        line = {"case": name, "n": n, "m": m, "d": d, "query_mask": masked,
                "ms_median": ms[len(ms) // 2], "ms_min": ms[0], "ms_max": ms[-1],
                "card": card()}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            qv = (torch.ones(n, dtype=torch.bool, device="cuda") if q_ok is None else q_ok)
            torch.save({"idx": out[0].cpu(), "d2": out[1].cpu(), "query_valid": qv.cpu()},
                       os.path.join(args.dump, f"{name}.pt"))
        del g, out
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
