"""conv_tflops.train: the trunk's convolutions' achieved rate in training.

The traced sub-window's convolution FLOPs (the mining's forwards, and three
times the forwards of the traced steps' images), counted on the reference,
over the device time of every kernel that ``aten::convolution`` and
``aten::convolution_backward`` launched there, in TFLOP/s."""
from reference import flops

OPS = ("aten::convolution", "aten::convolution_backward")


def read(ctx):
    seconds = sum(ctx["op_device_s"].get(op, 0.0) for op in OPS)
    if seconds <= 0:
        return None
    ref = ctx["reference"]

    def count(shapes):
        return sum(flops.trunk_flops(ref["trunk"], ref["trunk_cfg"], hw)
                   for hw in shapes)

    total = count(ctx["traced_forward"]) + 3 * count(ctx["traced_step"])
    return total / seconds / 1e12
