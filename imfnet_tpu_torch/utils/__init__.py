"""Timers, device choice, CUDA kernel builds, weight conversion, the
native host library, visualization."""
from imfnet_tpu_torch.utils.timer import AverageMeter, MinTimer, Timer  # noqa: F401
