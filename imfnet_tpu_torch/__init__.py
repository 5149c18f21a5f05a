"""PyTorch/CUDA port of the imfnet_tpu registration system.

The JAX package ``imfnet_tpu`` is the reference; this package computes the
same functions with plain PyTorch tensor code and hand-written Hopper
kernels (``csrc/``) where the JAX package has a Pallas kernel. Public
functions keep the JAX layouts: ``coords int32[N,4]`` as (batch, x, y, z),
``nbr int32[N_out,K]`` with -1 for a missing neighbour, sparse-conv weights
``[K,Cin,Cout]`` and images NHWC.

Entry points (``pipeline.PairRegistrar``) run on the card unless the caller
passes ``device="cpu"``; kernel wrappers launch their kernel for a CUDA
tensor and run the kernel's plain PyTorch version for a CPU tensor.
"""

__version__ = "0.1.0"

from imfnet_tpu_torch.config import Config, kitti_config, threedmatch_config  # noqa: F401,E402
