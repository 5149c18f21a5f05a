"""Device choice for the port's entry points: the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a torch.device, defaulting to ``cuda``.

    Raises when a CUDA device is asked for (explicitly or by default) and no
    card is present: the port never falls back to the CPU quietly. Callers
    that want the CPU pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "imfnet_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev

