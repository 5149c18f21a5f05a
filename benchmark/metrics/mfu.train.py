"""mfu.train (%): the training step's operations in the traced window over
the window's seconds times 989 TFLOP/s: the model's forward of both sides
(every sparse conv at 2 · live map entries · cin · cout, the 1x1
products, the ResNet-34 trunk, the fusion) taken three times for forward
and backward, and the positive search at 2·N·M·3 a pair
(``benchlib.arith.unit_flops``). Moves train_steps_per_s."""
from benchlib import readers

PEAK_FLOPS_S = 989e12      # H100 SXM data sheet: dense bf16


def read(run):
    return readers.mfu(run, PEAK_FLOPS_S)
