"""Model registry (`model/__init__.py:5-30`): ``load_model(name)`` returns a
factory; call it with keyword overrides to build the module. The SimpleNet
family waits for a later slice of the port."""
from __future__ import annotations

import functools
from typing import Callable, Dict

from imfnet_tpu_torch.models.resunet import ResUNetIMF

# Channel plans from `model/resunet.py:276-326`.
_RESUNET_VARIANTS = {
    "ResUNetBN2":   dict(channels=(32, 64, 128, 256), tr_channels=(32, 64, 64, 128), norm_type="BN", block_norm_type="BN"),
    "ResUNetBN2B":  dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 64, 64), norm_type="BN", block_norm_type="BN"),
    "ResUNetBN2C":  dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 64, 128), norm_type="BN", block_norm_type="BN"),
    "ResUNetBN2D":  dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 128, 128), norm_type="BN", block_norm_type="BN"),
    "ResUNetBN2E":  dict(channels=(128, 128, 128, 256), tr_channels=(64, 128, 128, 128), norm_type="BN", block_norm_type="BN"),
    "ResUNetIN2":   dict(channels=(32, 64, 128, 256), tr_channels=(32, 64, 64, 128), norm_type="BN", block_norm_type="IN"),
    "ResUNetIN2B":  dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 64, 64), norm_type="BN", block_norm_type="IN"),
    "ResUNetIN2C":  dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 64, 128), norm_type="BN", block_norm_type="IN"),
    "ResUNetIN2D":  dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 128, 128), norm_type="BN", block_norm_type="IN"),
    "ResUNetIN2E":  dict(channels=(128, 128, 128, 256), tr_channels=(64, 128, 128, 128), norm_type="BN", block_norm_type="IN"),
}

MODELS: Dict[str, Callable] = {
    name: functools.partial(ResUNetIMF, **plan)
    for name, plan in _RESUNET_VARIANTS.items()
}


def load_model(name: str) -> Callable:
    """Name → module factory (`model/__init__.py:16-24`)."""
    if name not in MODELS:
        raise ValueError(f"Model {name} not defined; known: {sorted(MODELS)}")
    return MODELS[name]
