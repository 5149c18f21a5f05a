"""Descriptor extraction, pair registration and the 3DMatch and KITTI
evaluators."""
from imfnet_tpu_torch.eval.extract import make_extractor, pad_points  # noqa: F401
from imfnet_tpu_torch.eval.registration import make_pair_registration  # noqa: F401
