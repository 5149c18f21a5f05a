"""Model registry (`model/__init__.py:5-30`): ``load_model(name)`` returns a
factory; call it with keyword overrides to build the module: the ten
``ResUNet*`` plans, the three SimpleNet depths and their 18 variants."""
from __future__ import annotations

import functools
from typing import Callable, Dict

from imfnet_tpu_torch.models.resunet import ResUNetIMF
from imfnet_tpu_torch.models.simpleunet import SimpleNet, SimpleNet2, SimpleNet3

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

# SimpleNet norm/channel variants (`model/simpleunet.py:135-192,304-360,
# 508-541`). The reference's SimpleNetBN2D repeats BN2C's plan verbatim.
_SIMPLENET_VARIANTS = {
    "SimpleNetBN":   (SimpleNet, dict(norm_type="BN")),
    "SimpleNetIN":   (SimpleNet, dict(norm_type="IN")),
    "SimpleNetBNE":  (SimpleNet, dict(norm_type="BN", channels=(16, 32, 32), tr_channels=(16, 16, 32))),
    "SimpleNetINE":  (SimpleNet, dict(norm_type="IN", channels=(16, 32, 32), tr_channels=(16, 16, 32))),
    "SimpleNetBN2":  (SimpleNet2, dict(norm_type="BN")),
    "SimpleNetIN2":  (SimpleNet2, dict(norm_type="IN")),
    "SimpleNetBN2B": (SimpleNet2, dict(norm_type="BN", tr_channels=(64, 64, 64, 64))),
    "SimpleNetBN2C": (SimpleNet2, dict(norm_type="BN", tr_channels=(32, 64, 64, 128))),
    "SimpleNetBN2D": (SimpleNet2, dict(norm_type="BN", tr_channels=(32, 64, 64, 128))),
    "SimpleNetBN2E": (SimpleNet2, dict(norm_type="BN", channels=(16, 32, 64, 128), tr_channels=(16, 32, 32, 64))),
    "SimpleNetIN2E": (SimpleNet2, dict(norm_type="IN", channels=(16, 32, 64, 128), tr_channels=(16, 32, 32, 64))),
    "SimpleNetBN3":  (SimpleNet3, dict(norm_type="BN")),
    "SimpleNetIN3":  (SimpleNet3, dict(norm_type="IN")),
    "SimpleNetBN3B": (SimpleNet3, dict(norm_type="BN", tr_channels=(32, 64, 64, 64, 128))),
    "SimpleNetBN3C": (SimpleNet3, dict(norm_type="BN", tr_channels=(32, 32, 64, 128, 128))),
    "SimpleNetBN3D": (SimpleNet3, dict(norm_type="BN", tr_channels=(32, 64, 64, 128, 128))),
    "SimpleNetBN3E": (SimpleNet3, dict(norm_type="BN", channels=(16, 32, 64, 128, 256), tr_channels=(16, 32, 32, 64, 128))),
    "SimpleNetIN3E": (SimpleNet3, dict(norm_type="IN", channels=(16, 32, 64, 128, 256), tr_channels=(16, 32, 32, 64, 128))),
}

MODELS: Dict[str, Callable] = {
    **{name: functools.partial(ResUNetIMF, **plan)
       for name, plan in _RESUNET_VARIANTS.items()},
    **{cls.__name__: cls for cls in (SimpleNet, SimpleNet2, SimpleNet3)},
    **{name: functools.partial(base, **plan)
       for name, (base, plan) in _SIMPLENET_VARIANTS.items()},
}


def load_model(name: str) -> Callable:
    """Name → module factory (`model/__init__.py:16-24`)."""
    if name not in MODELS:
        raise ValueError(f"Model {name} not defined; known: {sorted(MODELS)}")
    return MODELS[name]
