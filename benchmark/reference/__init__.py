"""The benchmark's plain reference of IMFNet pair registration.

Plain PyTorch, written from the published model (IMFNet's ResUNetBN2C with
the ResNet-34 trunk and the attention fusion, `model/resunet.py`,
`model/resnet.py`, `model/attention_fusion.py`) and from the registration
semantics of `scripts/evaluation_3dmatch.py` and `scripts/benchmark_util.py`.
It imports nothing of the program under test: every voxel table, kernel
map, descriptor, correspondence and pose is worked out here again from the
raw inputs and the weights the benchmark made.

Products run in the precision a ``precision.Precision`` names: "f32" (the
reference, TF32 off) or "fp8" (the control: operands rounded to float8
e4m3 with one scale a tensor, sums in f32).
"""
