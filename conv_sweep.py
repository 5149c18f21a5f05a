#!/usr/bin/env python3
"""Kernel A (sparse-conv gather-GEMM) at every tile, step and split, on
one GPU.

    python3 conv_sweep.py        # needs one card

Builds ``csrc/sparse_conv.cu`` (prints the compiler's register and spill
report), builds the bench-scale pair's pyramid as ``chip_smoke.py`` does,
and at each distinct conv shape of the main path runs the tensor-core
variant at every instance the kernel has (tile, input step) and every
split, and the scalar variant: each against the plain version (1e-4 ·
max|ref|, dead rows exactly 0, two calls bit-equal) and timed with CUDA
events over CUDA-graph replays (no host time between launches). One JSON
line per shape, with every result, the plan ``conv_plan`` takes and the
fastest. ``conv_plan``'s rule is chosen from these tables.
"""
import sys
from collections import Counter

import torch

from chip_smoke import (CONV_TOL_REL, MAIN_PATH_CONVS, bench_pair, conv_inputs,
                        emit, graph_ms, phase_device)
from imfnet_tpu_torch.pipeline import PairRegistrar
from imfnet_tpu_torch.sparse.conv_kernel import (TC_TILES, ConvPlan, conv_plan,
                                                 gather_gemm_plain, run_plan)
from imfnet_tpu_torch.utils import cuda_build


def check(x, nbr, w, plan, ref, tol):
    out = run_plan(x, nbr, w, plan)
    again = run_plan(x, nbr, w, plan)
    torch.cuda.synchronize()
    dead = (nbr < 0).all(dim=1)
    err = float((out - ref).abs().max())
    ok = err <= tol and bool((out[dead] == 0).all()) and torch.equal(out, again)
    return ok, err


def main():
    if not torch.cuda.is_available():
        print("conv_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_device()
    report = cuda_build.build(["sparse_conv"])
    emit({"phase": "build", "ptxas": report["sparse_conv"]["ptxas"].splitlines()})

    reg = PairRegistrar()
    pair = bench_pair(reg.config)
    pb = reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1)
    pyr = reg.pyramid(reg.quantize(pb))
    gen = torch.Generator(device="cuda").manual_seed(0)

    calls = Counter((lv, wh, ci, co) for _, lv, wh, ci, co in MAIN_PATH_CONVS)
    rows, seen, failed = [], set(), []
    for name, level, which, cin, cout in MAIN_PATH_CONVS:
        if (level, which, cin, cout) in seen:
            continue
        seen.add((level, which, cin, cout))
        x, nbr, w = conv_inputs(pyr, level, which, cin, cout, gen)
        n_out = nbr.shape[0]
        ref = gather_gemm_plain(x, nbr, w)
        tol = CONV_TOL_REL * max(1.0, float(ref.abs().max()))
        plans = [ConvPlan("tc", bm, bn, bk, s) for bm, bn, bk in sorted(TC_TILES)
                 for s in (1, 2, 4, 8) if bn <= max(32, cout) and bk <= cin]
        plans.append(ConvPlan("scalar", 64, 64, 32, 1))
        chosen = conv_plan(n_out, cin, cout, nbr.shape[1], x.dtype)
        results = []
        for plan in plans:
            try:
                ok, err = check(x, nbr, w, plan, ref, tol)
            except RuntimeError as e:     # a refused launch is a result here
                ok, err = False, str(e)
            if not ok:
                failed.append((name, plan, err))
            results.append({"plan": list(plan), "blocks": plan.blocks(n_out, cout),
                            "ok": ok, "max_abs_err": err,
                            "ms": graph_ms(lambda: run_plan(x, nbr, w, plan))
                            if ok else None})
        best = min((r for r in results if r["ok"]), key=lambda r: r["ms"],
                   default={"plan": None, "ms": float("nan")})
        entry = {"phase": "sweep", "conv": name, "level": level, "map": which,
                 "cin": cin, "cout": cout, "calls": calls[(level, which, cin, cout)],
                 "n_in": x.shape[0], "n_out": n_out,
                 "live_rows": int((nbr >= 0).any(dim=1).sum()),
                 "plan": list(chosen), "best": best["plan"], "best_ms": best["ms"],
                 "plan_ms": next((r["ms"] for r in results if r["plan"] == list(chosen)
                                  and r["ok"]), float("nan")),
                 "plain_ms": graph_ms(lambda: gather_gemm_plain(x, nbr, w), 5),
                 "results": results}
        emit(entry)
        rows.append(entry)
    emit({"phase": "summary",
          "plan_ms_per_pair": sum(r["plan_ms"] * r["calls"] for r in rows),
          "best_ms_per_pair": sum(r["best_ms"] * r["calls"] for r in rows),
          "failed": [[n, list(p), e] for n, p, e in failed]})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
