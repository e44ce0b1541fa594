"""mfu.train: the training window's share of the card's float32 peak.

The FLOPs of the trunk's convolutions over the window's epochs, counted on
the reference at each image's own size: every mined image's forward, and
three times the forward of every image of every step (forward, and a
backward at twice its cost), over the epochs' wall time (less the
profiler's collection of the trace) and 67 TFLOP/s,
one H100 SXM's float32 rate outside the tensor cores."""
from reference import flops

PEAK_FLOP_PER_S = 67e12


def read(ctx):
    ref = ctx["reference"]

    def count(shapes):
        return sum(flops.trunk_flops(ref["trunk"], ref["trunk_cfg"], hw)
                   for hw in shapes)

    total = count(ctx["window_forward"]) + 3 * count(ctx["window_step"])
    return 100.0 * total / ctx["epochs_s"] / PEAK_FLOP_PER_S
