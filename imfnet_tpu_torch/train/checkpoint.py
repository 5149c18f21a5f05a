"""Checkpoint save/resume with embedded config (``imfnet_tpu.train.checkpoint``).

Mirrors the reference contract (`lib/trainer.py:183-198`, resume at
`:103-117`; eval-time model reconstruction from checkpoint-embedded config at
`scripts/generate_desc.py:160-173`): full state written per epoch and for the
best validation metric, the directory name embedding the metric value.

Format: a directory ``<name>_epoch_<e>_<metric>_<value>`` holding ``meta.json``
(config and bookkeeping: the JAX package's keys and ``format_version``, so
either package reads the other's) and ``state.pt``, a ``torch.save`` of

    {"model": module.state_dict(), "optimizer": ..., "scheduler": ...,
     "step": int, "extra": {...}}

where the JAX package writes ``state.msgpack`` (flax serialization). The
keys of ``model`` are the module's dotted names (``block1.conv0.weight``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.train.state import TrainState, load_optimizer_state

STATE_FILE = "state.pt"


def save_checkpoint(
    directory: str,
    name: str,
    state: TrainState,
    config: Config,
    epoch: int,
    best_val: float,
    best_val_epoch: int,
    best_val_metric: str,
    val_value: Optional[float] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Writes the checkpoint directory and returns its path. ``extra`` (plain
    numbers, strings, tensors and containers of them) rides along in
    ``state.pt`` for the caller: the trainer keeps its random streams there."""
    if val_value is not None:
        name = f"{name}_epoch_{epoch}_{best_val_metric}_{val_value}"
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    torch.save(
        dict(model=state.model.state_dict(),
             optimizer=state.optimizer.state_dict(),
             scheduler=(state.scheduler.state_dict()
                        if state.scheduler is not None else None),
             step=int(state.step), extra=extra or {}),
        os.path.join(path, STATE_FILE))
    meta = dict(
        epoch=epoch,
        best_val=best_val,
        best_val_epoch=best_val_epoch,
        best_val_metric=best_val_metric,
        config=json.loads(config.to_json()),
        format_version=1,
    )
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def last_checkpoint(run_dir: str) -> Optional[str]:
    """The last ``checkpoint*`` directory of a run directory in sorted
    order (``train --resume-dir``), or None."""
    names = sorted(d for d in os.listdir(run_dir)
                   if d.startswith("checkpoint") and os.path.isdir(os.path.join(run_dir, d)))
    return os.path.join(run_dir, names[-1]) if names else None


def _load_state_file(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Restores the module, optimizer, scheduler and step count of ``state``
    in place, on the device its parameters live on, and returns (state,
    meta): ``meta.json``'s content plus, under ``"extra"``, what the saver
    passed as ``extra``."""
    device = next(state.model.parameters()).device
    blob = _load_state_file(path, map_location=device)
    state.model.load_state_dict(blob["model"], strict=True)
    # Optimizer.load_state_dict casts each per-parameter tensor (the
    # momentum buffers) to its parameter's device and dtype
    load_optimizer_state(state.optimizer, blob["optimizer"])
    if state.scheduler is not None and blob["scheduler"] is not None:
        state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    meta["extra"] = blob.get("extra", {})
    return state, meta


def load_config_from_checkpoint(path: str) -> Config:
    """The config embedded in ``meta.json``; reads nothing else, so it takes
    a checkpoint directory written by either package."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return Config.from_json(json.dumps(meta["config"]))


def migrate_checkpoint_keys(
    path: str,
    out_path: str,
    renames: Dict[str, str],
) -> int:
    """Rename module keys in a saved checkpoint (module renames between
    versions). The analogue of the reference's checkpoint key-migration shim
    (`lib/Test.py:5-26`, which rewrites `perceiver_io.*` →
    `attention_fusion.*` in a .pth).

    ``renames`` maps old key prefixes of ``state.pt``'s ``model`` entry to
    new ones, dot-joined as ``state_dict`` keys are (e.g.
    ``{"perceiver_io": "attention_fusion"}``); a prefix matches whole name
    components only. The optimizer's state is indexed by parameter position
    and needs no rename. Returns the number of tensors moved.
    """
    blob = _load_state_file(path)
    moved = 0
    model: Dict[str, Any] = {}
    for key, value in blob["model"].items():
        new_key = key
        for old, new in renames.items():
            if key == old or key.startswith(old + "."):
                new_key = new + key[len(old):]
                moved += 1
                break
        model[new_key] = value
    blob["model"] = model
    os.makedirs(out_path, exist_ok=True)
    torch.save(blob, os.path.join(out_path, STATE_FILE))
    meta_src = os.path.join(path, "meta.json")
    if os.path.exists(meta_src):
        with open(meta_src) as f:
            meta = json.load(f)
        with open(os.path.join(out_path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    return moved


def load_model_from_checkpoint(path: str, device) -> Tuple[torch.nn.Module, Config]:
    """(model, config): the module a checkpoint's embedded config names,
    with the checkpoint's weights, in ``eval()`` on ``device``, built for
    inference (``build_model_from_config(eval_fast=True)``: the occupancy
    conv1, same parameters)."""
    from imfnet_tpu_torch.train.trainer import build_model_from_config

    config = load_config_from_checkpoint(path)
    model = build_model_from_config(config, eval_fast=True)
    model.load_state_dict(_load_state_file(path)["model"], strict=True)
    return model.to(device).eval(), config
