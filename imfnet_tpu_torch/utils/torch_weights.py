"""Reference-weight conversion (``imfnet_tpu.utils.torch_weights``): a
released IMFNet ``state_dict`` and torchvision's ResNet-34 loaded straight
into the port's modules, with no flax tree in between.

The reference's layout differs from the port's in three ways:
- sparse-conv kernels are ``[K, Cin, Cout]`` in MinkowskiEngine 0.5.4's
  offset order; the port's K axis is ``kernel_offsets`` order
  (``me_offset_permutation``), and a transpose conv's offsets are negated;
- the image trunk's blocks are ``img_encoder.backbone.layer{l}.{b}.*``, the
  port's ``img_encoder.layer{l}_block{b}.*``; the downsample pair
  ``downsample.0``/``.1`` is ``down_conv``/``down_bn``;
- the fusion block is ``perceiver_io.*`` in the released checkpoint (the
  reference renames it on load, `lib/Test.py:5-26`) or
  ``attention_fusion.*``, with PerceiverIO's nesting
  (``cross_attend_blocks.0.fn.to_q``) where the port names the layer
  (``cross_attn.to_q``).
Linear and 2-D conv weights are PyTorch's own layout on both sides and are
copied as they are. Renaming the keys of a port checkpoint is
``migrate_checkpoint_keys`` (``train.checkpoint``'s, re-exported here where
the JAX package has it).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from imfnet_tpu_torch.train.checkpoint import migrate_checkpoint_keys  # noqa: F401

TRUNK_BLOCKS = ((1, 3), (2, 4))   # (layer, blocks) kept by the truncated trunk


def me_kernel_region_offsets(kernel_size: int, dimension: int = 3) -> np.ndarray:
    """int64[K, dimension] kernel offsets in MinkowskiEngine 0.5.4's
    enumeration order, the `kernel_region` HYPER_CUBE iterator (ME
    `src/kernel_region.hpp`): an odometer over the spatial axes that starts
    every axis at -(k//2) and steps the first axis fastest. IMFNet uses odd
    sizes only (1/3/5, `model/resunet.py:42-158`).

    ``MinkowskiConvolution`` gathers ``out[u] = Σ_k W[k] · in[u + δ_k]``;
    ``MinkowskiConvolutionTranspose`` scatters, ``out[u] = Σ_k W[k] ·
    in[u − δ_k]``."""
    r = (kernel_size - 1) // 2
    cur = [-r] * dimension
    out = []
    for _ in range(kernel_size ** dimension):
        out.append(tuple(cur))
        for axis in range(dimension):   # first axis fastest (odometer)
            cur[axis] += 1
            if cur[axis] <= r:
                break
            cur[axis] = -r
    return np.array(out, np.int64)


def me_offset_permutation(kernel_size: int, reverse: bool = False) -> np.ndarray:
    """perm[k_port] = k_me: the port's offset enumeration (dx slowest, dz
    fastest, ``sparse.kernel_map.kernel_offsets``) onto MinkowskiEngine's.
    ``reverse=True`` also maps δ → −δ: the port's transpose-conv maps index
    by the offset from the output (fine) coordinate, ME's transpose kernels
    by the offset from the input."""
    me_index = {tuple(o): i for i, o in enumerate(me_kernel_region_offsets(kernel_size))}
    r = kernel_size // 2
    perm = np.zeros(kernel_size ** 3, np.int64)
    i = 0
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dz in range(-r, r + 1):
                perm[i] = me_index[(-dx, -dy, -dz) if reverse else (dx, dy, dz)]
                i += 1
    return perm


def _f32(t) -> torch.Tensor:
    """A float32 CPU copy of a tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(t, np.float32))


def _bn2d(out: Dict[str, torch.Tensor], dst: str, src: Mapping, key: str) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{leaf}"] = _f32(src[f"{key}.{leaf}"])
    # the count only steers a momentum-free BatchNorm2d; zero, as
    # ``flax_weights.state_dict_from_flax`` writes it
    out[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def convert_resnet34_torch(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision ``resnet34`` state_dict (tensors or numpy arrays) → the
    ``state_dict`` of ``models.resnet.ResNetTrunk``: conv1/bn1 and the 3 + 4
    blocks of layer1 and layer2; the deeper layers fall at the truncation
    point (`model/resnet.py:195-216`)."""
    out: Dict[str, torch.Tensor] = {"conv1.weight": _f32(state_dict["conv1.weight"])}
    _bn2d(out, "bn1", state_dict, "bn1")
    for layer, n_blocks in TRUNK_BLOCKS:
        for b in range(n_blocks):
            src, dst = f"layer{layer}.{b}", f"layer{layer}_block{b}"
            for i in (1, 2):
                out[f"{dst}.conv{i}.weight"] = _f32(state_dict[f"{src}.conv{i}.weight"])
                _bn2d(out, f"{dst}.bn{i}", state_dict, f"{src}.bn{i}")
            if f"{src}.downsample.0.weight" in state_dict:
                out[f"{dst}.down_conv.weight"] = _f32(state_dict[f"{src}.downsample.0.weight"])
                _bn2d(out, f"{dst}.down_bn", state_dict, f"{src}.downsample.1")
    return out


def load_pretrained_resnet34(model: torch.nn.Module, pth_path: str,
                             trunk_name: str = "img_encoder") -> torch.nn.Module:
    """Loads torchvision's ImageNet ResNet-34 weights (a local ``.pth``; the
    reference downloads them, `model/resnet.py:219-224`) into the model's
    image trunk, in place, and returns the model."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    getattr(model, trunk_name).load_state_dict(convert_resnet34_torch(sd), strict=True)
    return model


def convert_imfnet_torch(state_dict: Mapping, *, conv1_kernel_size: int = 5,
                         depth: int = 0) -> Dict[str, torch.Tensor]:
    """A reference IMFNet ``state_dict`` (the ``'state_dict'`` entry of the
    released ``.pth``; tensors or numpy arrays) → the port's ``ResUNetIMF``
    ``state_dict`` (module map of `model/resunet.py:25-161`; ``depth`` is the
    fusion's self-attention depth, 0 in IMFNet). A missing key raises."""
    sd = {("attention_fusion" + k[len("perceiver_io"):]
           if k.startswith("perceiver_io.") else k): v for k, v in state_dict.items()}

    def get(key):
        if key not in sd:
            raise KeyError(f"missing checkpoint key: {key}")
        return sd[key]

    out: Dict[str, torch.Tensor] = {}

    def sconv(dst, src, kernel_size, transpose=False):
        w = _f32(get(src + ".kernel"))
        if w.dim() == 3:   # [K, Cin, Cout] in ME's order; k = 1 is [Cin, Cout]
            w = w[torch.from_numpy(me_offset_permutation(kernel_size, reverse=transpose))]
        out[dst + ".weight"] = w

    def bn(dst, src):
        # ME.MinkowskiBatchNorm wraps a BatchNorm1d as `.bn`
        p = src + ".bn" if (src + ".bn.weight") in sd else src
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.bn.{leaf}"] = _f32(get(f"{p}.{leaf}"))

    def block(name):
        for i in (0, 1):
            sconv(f"{name}.conv{i}", f"{name}.conv{i + 1}", 3)
            bn(f"{name}.norm{i}", f"{name}.norm{i + 1}")

    sconv("conv1", "conv1", conv1_kernel_size)
    bn("norm1", "norm1")
    for i in (1, 2, 3, 4):
        if i > 1:
            sconv(f"conv{i}", f"conv{i}", 3)
            bn(f"norm{i}", f"norm{i}")
        block(f"block{i}")
    for i in (4, 3, 2):
        sconv(f"conv{i}_tr", f"conv{i}_tr", 3, transpose=True)
        bn(f"norm{i}_tr", f"norm{i}_tr")
        block(f"block{i}_tr")
    sconv("conv1_tr", "conv1_tr", 1)
    out["final.weight"] = _f32(get("final.kernel"))
    out["final.bias"] = _f32(get("final.bias"))

    trunk = {k[len("img_encoder.backbone."):]: v for k, v in sd.items()
             if k.startswith("img_encoder.backbone.")}
    for k, v in convert_resnet34_torch(trunk).items():
        out["img_encoder." + k] = v

    # attention fusion (`model/attention_fusion.py:98-154`)
    af = "attention_fusion"
    pairs = [("cross_norm_q", "cross_attend_blocks.0.norm"),
             ("cross_norm_ctx", "cross_attend_blocks.0.norm_context"),
             ("cross_attn", "cross_attend_blocks.0.fn"),
             ("cross_ff_norm", "cross_attend_blocks.1.norm"),
             ("cross_ff", "cross_attend_blocks.1.fn")]
    for i in range(depth):
        pairs += [(f"self_norm_{i}", f"layers.{i}.0.norm"), (f"self_attn_{i}", f"layers.{i}.0.fn"),
                  (f"self_ff_norm_{i}", f"layers.{i}.1.norm"), (f"self_ff_{i}", f"layers.{i}.1.fn")]
    leaves = {"norm": ("weight", "bias"), "attn": ("to_q.weight", "to_kv.weight",
                                                   "to_out.weight", "to_out.bias"),
              "ff": ("net.0.weight", "net.0.bias", "net.2.weight", "net.2.bias")}
    ff_names = {"net.0": "wi", "net.2": "wo"}
    for dst, src in pairs:
        kind = "norm" if "norm" in dst else "attn" if "attn" in dst else "ff"
        for leaf in leaves[kind]:
            mod, _, param = leaf.rpartition(".")
            port_leaf = f"{ff_names.get(mod, mod)}.{param}" if mod else param
            out[f"{af}.{dst}.{port_leaf}"] = _f32(get(f"{af}.{src}.{leaf}"))
    return out


def load_imfnet_checkpoint(pth_path: str, **kwargs) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a released IMFNet ``.pth``: the reference
    stores the model under ``'state_dict'`` beside its ``'config'``
    (`lib/trainer.py:183-198`); keyword arguments go to
    ``convert_imfnet_torch``."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    return convert_imfnet_torch(ckpt.get("state_dict", ckpt), **kwargs)
