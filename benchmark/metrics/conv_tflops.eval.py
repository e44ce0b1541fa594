"""conv_tflops.eval: the trunk's convolutions' achieved rate.

The forward FLOPs of the traced pass's trunk inputs (counted on the
reference) over the device time of every kernel that ``aten::convolution``
launched in the traced pass (whatever cuDNN picks: implicit GEMM, FFT,
Winograd), in TFLOP/s."""
from harness import layers

OP = "aten::convolution"


def read(ctx):
    seconds = ctx["op_device_s"].get(OP, 0.0)
    if seconds <= 0:
        return None
    return layers.pass_flops(ctx) / seconds / 1e12
