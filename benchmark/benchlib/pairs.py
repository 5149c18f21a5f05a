"""What the drivers of units drawn from a pool share: the pool's seeded
order, the timed unit, the sample the check keeps, and the check's loop.

A subclass sets, in ``setup``, ``self.order`` (the pool's order, from the
seed), ``self.sample`` (a ``harness.Reservoir``) and, where the check
should always see one particular item of the pool, ``self.always``; and
defines ``run_one(p)`` (the program's call on item p), ``snapshot_of(p,
out)`` (copies of what the check compares of that call),
``reference_of(p, P, prec)`` and ``judge_of(p, snapshot, reference)``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from benchlib import regcheck
from reference.precision import Precision


class PoolDriver:
    always: Optional[int] = None

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.m = cell.config["model"]
        self.tr = dict(cell.workload["traffic"])
        self.always_kept = None

    def item_of(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def unit(self, i: int, spans) -> float:
        """The call with host arrays in hand (span ``call``), then its result
        copied to the host (span ``result``)."""
        p = self.item_of(i)
        t0 = time.perf_counter()
        with spans("call"):
            out = self.run_one(p)
        with spans("result"):
            torch.cat([v.reshape(-1).float() for v in out.values()]).cpu()
        self.last = (p, out)
        return time.perf_counter() - t0

    def keep(self, i: int) -> None:
        """A reservoir of the window's units drawn from the seed, and the
        first instance of ``always``."""
        p, out = self.last
        if p == self.always and self.always_kept is None:
            self.always_kept = {"p": p, **self.snapshot_of(p, out)}
        self.sample.offer(i, lambda: {"p": p, **self.snapshot_of(p, out)})

    def check(self):
        P = regcheck.ref_params(self.P)
        rows, seen = [], set()
        for kept in self.sample.kept + [self.always_kept]:
            if kept is None or kept["p"] in seen:    # an item's result repeats exactly
                continue
            seen.add(kept["p"])
            rows.append(self.judge_of(kept["p"], kept,
                                      self.reference_of(kept["p"], P, Precision("f32"))))
        return regcheck.worst(rows, self.cell.workload["limits"])

    def judge_of(self, p: int, snap: Dict, ref) -> Dict[str, float]:
        raise NotImplementedError
