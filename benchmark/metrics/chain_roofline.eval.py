"""chain_roofline.eval: the lab CLAHE chain kernels' share of their
roofline.

The least times of ``lab_n_kernel``, ``tile_luts_kernel`` and
``interp_kernel`` on the traced pass's images at their own sizes
(``harness/bounds.py``) over the three kernels' device time, in %. Nothing
to read where the chain does not run."""
from harness import bounds, trace

KERNELS = ("lab_n_kernel", "tile_luts_kernel", "interp_kernel")


def read(ctx):
    runs = [trace.device_seconds(ctx["kernels"],
                                 lambda name, k=k: k in name)
            for k in KERNELS]
    if not all(launches for _, launches in runs):
        return None
    grid = ctx["reference"]["chain_args"]["grid"]
    shapes = ctx["shapes"]
    least = bounds.lab_n_s(shapes, runs[0][1]) \
        + bounds.tile_luts_s(shapes, grid) + bounds.interp_s(shapes, grid)
    return 100.0 * least / sum(seconds for seconds, _ in runs)
