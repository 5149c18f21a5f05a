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


def require_one_device(num_devices: int) -> None:
    """The port runs on one device: any other ``num_devices`` raises until
    data parallelism is ported."""
    if num_devices != 1:
        raise NotImplementedError(
            f"num_devices={num_devices}: the port runs on one device until data "
            f"parallelism is ported (ROADMAP 1.12)")
