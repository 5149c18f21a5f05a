"""Carry ``ResUNetIMF`` weights over from the JAX package's flax variables.

``state_dict_from_flax(variables)`` takes the flax tree
``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, variables)``) and returns the
port's ``state_dict``; ``flax_from_state_dict`` is its inverse. A flax
gradient tree has the shape of ``params``, so
``state_dict_from_flax({"params": grads})`` lays it beside ``param.grad``.
Nothing here imports flax or jax.

Layout changes:
- flax ``nn.Dense`` kernels are [in, out]; ``nn.Linear.weight`` is [out, in].
- flax ``nn.Conv`` kernels are HWIO; ``nn.Conv2d.weight`` is OIHW.
- norms: ``scale`` → ``weight``, batch_stats ``mean``/``var`` →
  ``running_mean``/``running_var`` (the trunk's ``BatchNorm2d`` also gets a
  zero ``num_batches_tracked``).
- sparse-conv kernels stay [K, Cin, Cout] (1x1 ones [Cin, Cout]), K in
  ``kernel_offsets`` order on both sides.
Module names: ``SparseConv_i`` → ``conv{i}``, ``SparseNorm_i`` → ``norm{i}``,
``MaskedBatchNorm_0`` → ``bn``; every other name is kept.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "kernel": "weight"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_name(part: str) -> str:
    for flax_prefix, torch_prefix in (("SparseConv_", "conv"), ("SparseNorm_", "norm")):
        if part.startswith(flax_prefix):
            return torch_prefix + part[len(flax_prefix):]
    return "bn" if part == "MaskedBatchNorm_0" else part


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``ResUNetIMF`` state_dict from flax ``variables``."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            *mods, leaf = path
            arr = np.asarray(value, np.float32)
            if leaf == "kernel" and arr.ndim == 4:          # nn.Conv, HWIO
                arr = arr.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and mods[0] == "attention_fusion":
                arr = arr.T                                  # nn.Dense, [in,out]
            name = ".".join([_module_name(m) for m in mods] + [_LEAF[leaf]])
            out[name] = torch.tensor(arr)   # a copy: flax arrays are read-only
            if mods[0] == "img_encoder" and leaf == "mean":
                out[".".join(mods + ["num_batches_tracked"])] = torch.zeros(
                    (), dtype=torch.long)
    return out


_LEAF_BACK = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var"),
              "bias": ("params", "bias")}


def _flax_module_name(part: str, in_block: bool, in_trunk: bool) -> str:
    """The flax name of a port module: inside a residual block ``conv{i}`` /
    ``norm{i}`` are flax's auto-named ``SparseConv_i`` / ``SparseNorm_i``
    (the model's own convs and norms keep their given names), and a sparse
    norm's ``bn`` is ``MaskedBatchNorm_0``."""
    m = re.fullmatch(r"(conv|norm)(\d+)", part)
    if in_block and m:
        return ("SparseConv_" if m.group(1) == "conv" else "SparseNorm_") + m.group(2)
    return "MaskedBatchNorm_0" if part == "bn" and not in_trunk else part


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The flax ``{"params": ..., "batch_stats": ...}`` tree (nested dicts of
    numpy arrays) of a port ``ResUNetIMF`` state_dict: the inverse of
    ``state_dict_from_flax`` (``num_batches_tracked`` has no counterpart)."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, value in state_dict.items():
        *mods, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = value.detach().cpu().numpy()
        if leaf == "weight":                       # a norm's scale or a kernel
            collection, flax_leaf = "params", "scale" if arr.ndim == 1 else "kernel"
            if arr.ndim == 4:                      # OIHW → HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2 and mods[0] == "attention_fusion":
                arr = arr.T
        else:
            collection, flax_leaf = _LEAF_BACK[leaf]
        in_block = mods[0].startswith("block")
        in_trunk = mods[0] == "img_encoder"
        node = out[collection]
        for i, part in enumerate(mods):
            node = node.setdefault(_flax_module_name(part, in_block and i > 0, in_trunk), {})
        node[flax_leaf] = arr
    return out
