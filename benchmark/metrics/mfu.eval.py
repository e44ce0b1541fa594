"""mfu.eval: the eval window's share of the card's float32 peak.

The forward FLOPs of the trunk's convolutions, counted on the reference at
each image's own size at each scale, over every pass of the window, divided
by the passes' wall time (not the profiler's start and collection around
the traced one) and by 67 TFLOP/s, one H100 SXM's float32 rate outside the
tensor cores (the port runs float32 with TF32 off)."""
from harness import layers

PEAK_FLOP_PER_S = 67e12


def read(ctx):
    flops = layers.pass_flops(ctx) * ctx["passes"]
    return 100.0 * flops / ctx["passes_s"] / PEAK_FLOP_PER_S
