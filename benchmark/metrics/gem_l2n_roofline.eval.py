"""gem_l2n_roofline.eval: ``gem_l2n_kernel``'s share of its roofline.

The least time of masked GeM + L2N on the traced pass's feature maps
(``harness/bounds.py``: every valid cell read once) over the kernel's
device time in the traced pass, in %."""
from harness import bounds, layers, trace

KERNEL = "gem_l2n_kernel"


def read(ctx):
    seconds, launches = trace.device_seconds(ctx["kernels"],
                                             lambda name: KERNEL in name)
    if not launches:
        return None
    return 100.0 * bounds.gem_l2n_s(layers.feature_maps(ctx),
                                    launches) / seconds
