#!/usr/bin/env python3
"""Kernel A (sparse-conv gather-GEMM) at every tile, step and split, on
one GPU.

    python3 conv_sweep.py        # needs one card
    python3 conv_sweep.py --dgr  # the wide-K walk at DGR's 6-D convs

Builds ``csrc/sparse_conv.cu`` (prints the compiler's register and spill
report), builds the bench-scale pair's pyramid as ``chip_smoke.py`` does,
and at each distinct conv shape of the main path runs the tensor-core
variant at every instance the kernel has (tile, input step) and every
split, and the scalar variant: each against the plain version (1e-4 ·
max|ref|, dead rows exactly 0, two calls bit-equal) and timed with CUDA
events over CUDA-graph replays (no host time between launches). One JSON
line per shape, with every result, the plan ``conv_plan`` takes and the
fastest. ``conv_plan``'s rule is chosen from these tables.

``--dgr`` does the same for the wide-K walk on a KITTI-sized DGR pair's own
6-D pyramid (``chip_smoke.dgr_pair``, 729 offsets): at each distinct conv of
the network, the plan's ms against its roofline bound (bytes: the map once,
the rows it names, the live weight offsets, the output), the list build
alone and the walk, then every output tile and pass size of the walk, each
bit-equal to the plan's output, which is held to the plain version.
"""
import sys
from collections import Counter

import torch

from chip_smoke import (CONV_TOL_REL, DGR_K, MAIN_PATH_CONVS, bench_pair, conv_inputs,
                        dgr_conv_entry, dgr_pair, emit, graph_ms, phase_device)
from imfnet_tpu_torch.config import dgr_kitti_config
from imfnet_tpu_torch.eval.dgr import DGRRegistrar
from imfnet_tpu_torch.pipeline import PairRegistrar
from imfnet_tpu_torch.sparse.conv_kernel import (TC_TILES, TCW_BNS, ConvPlan, conv_plan,
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


def sweep_dgr():
    """The wide-K walk at each distinct 6-D conv of DGR's network."""
    reg = DGRRegistrar(dgr_kitti_config(), device="cuda", seed=0)
    seen = []
    reg.model.register_forward_hook(lambda mod, inputs, out: seen.append(inputs))
    reg(*dgr_pair())
    pyr = seen[-1][1]
    del reg, seen
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = Counter((lv, wh, ci, co) for _, lv, wh, ci, co in MAIN_PATH_CONVS)
    rows, seen, failed = [], set(), []
    for name, level, which, cin, cout in MAIN_PATH_CONVS:
        key = (level, which, cin, cout)
        if key in seen:
            continue
        seen.add(key)
        src = {"k3_same": level, "down": level - 1, "up": level + 1}[which]
        nbr = getattr(pyr.levels[level], which)
        x = torch.randn((pyr.levels[src].coords.shape[0], cin), generator=gen,
                        device="cuda").to(torch.bfloat16)
        w = (torch.randn((DGR_K, cin, cout), generator=gen, device="cuda")
             * (DGR_K * cin) ** -0.5).to(torch.bfloat16)
        plan = conv_plan(nbr.shape[0], cin, cout, DGR_K, x.dtype)
        entry = dgr_conv_entry(name, x, nbr, w, plan)   # held to the plain version
        want = run_plan(x, nbr, w, plan)
        results = []
        for bn in TCW_BNS:
            for ob in sorted({plan.split, DGR_K, -(-DGR_K // 2), -(-DGR_K // 4)}):
                p = plan._replace(bn=bn, split=ob)
                ok = torch.equal(run_plan(x, nbr, w, p), want)
                if not ok:
                    failed.append((name, p))
                results.append({"plan": list(p), "ok": ok,
                                "ms": graph_ms(lambda: run_plan(x, nbr, w, p), 5)})
        best = min(results, key=lambda r: r["ms"])
        entry.update({"phase": "sweep_dgr", "calls": calls[key], "plan": list(plan),
                      "best": best["plan"], "best_ms": best["ms"], "results": results})
        emit(entry)
        rows.append(entry)
    emit({"phase": "summary_dgr",
          "plan_ms_per_pair": sum(r["ms"] * r["calls"] for r in rows),
          "best_ms_per_pair": sum(r["best_ms"] * r["calls"] for r in rows),
          "bound_ms_per_pair": sum(r["bound_ms"] * r["calls"] for r in rows),
          "lists_ms_per_pair": sum(r["lists_ms"] * r["calls"] for r in rows),
          "failed": [[n, list(p)] for n, p in failed]})
    return 1 if failed else 0


def main():
    if not torch.cuda.is_available():
        print("conv_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_device()
    report = cuda_build.build(["sparse_conv"])
    emit({"phase": "build", "ptxas": report["sparse_conv"]["ptxas"].splitlines()})
    if "--dgr" in sys.argv[1:]:
        return sweep_dgr()

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
