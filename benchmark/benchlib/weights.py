"""Weights from the seed, made on the device in one draw.

One ``torch.randn`` on a ``torch.Generator`` of the target device fills a
single float32 buffer; each parameter or buffer of ``reference.model
.param_specs`` is a view of it, shaped by its kind:

- ``weight``: normal, clipped at two standard deviations, scaled by
  fan_in^-1/2 (variance scaling, as the published initializers);
- ``scale``: 1 + 0.1 n (norm gains); ``shift``: 0.1 n (biases, running
  means); ``variance``: exp(0.25 n) (running variances, positive);
- ``count``: an int64 zero (batch norms' step counters).

Norm buffers are drawn too, so that every batch norm of the inference path
does work and the reference meets non-trivial statistics.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, int]


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from a seed of any size."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return g


def make(specs: Sequence[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    floats = [s for s in specs if s[2] != "count"]
    total = sum(math.prod(s[1]) for s in floats)
    buf = torch.randn(total, generator=generator(seed, device, salt=1), device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind, fan_in in specs:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        v = buf[at:at + n].view(shape)
        at += n
        if kind == "weight":
            v.clamp_(-2.0, 2.0).mul_(fan_in ** -0.5)
        elif kind == "scale":
            v.mul_(0.1).add_(1.0)
        elif kind == "shift":
            v.mul_(0.1)
        elif kind == "variance":
            v.mul_(0.25).exp_()
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
        out[name] = v
    return out
