"""What the per-layer readers share: the work of one traced pass, counted
on the reference from the images' sizes."""
import math

from reference import flops, nets


def scaled(side, scale):
    """torch's floor size of ``side`` at ``scale``."""
    return side if scale == 1 else int(math.floor(side * scale))


def scaled_shapes(ctx):
    """(h, w) of every trunk input of one pass: each image at each
    scale."""
    return [(scaled(h, s), scaled(w, s)) for h, w in ctx["shapes"]
            for s in ctx["reference"]["scales"]]


def pass_flops(ctx):
    """Forward FLOPs of the trunk over one pass."""
    ref = ctx["reference"]
    return sum(flops.trunk_flops(ref["trunk"], ref["trunk_cfg"], hw)
               for hw in scaled_shapes(ctx))


def feature_maps(ctx):
    """(channels, h, w) of the trunk's output for every trunk input of
    one pass."""
    ref = ctx["reference"]
    c = nets.out_channels(ref["trunk"], ref["trunk_cfg"])
    return [(c,) + nets.feature_hw(ref["trunk"], ref["trunk_cfg"], hw)
            for hw in scaled_shapes(ctx)]
