"""Floating-point operations of the reference trunks, counted by
``torch.utils.flop_counter`` on meta tensors (no memory, no compute).

``trunk_flops(arch, cfg, (H, W))`` counts one forward of the trunk at an
input size: its convolutions (2 per multiply-add; ResNet's BatchNorm, the
ReLUs and pools are not counted). The backward of a convolution costs twice
its forward. Counts are cached per size.
"""
import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import nets


@functools.lru_cache(maxsize=None)
def _meta_params(arch, cfg):
    return {name: torch.empty(shape, device="meta")
            for name, shape, _ in nets.param_shapes(arch, list(cfg))}


@functools.lru_cache(maxsize=4096)
def _count(arch, cfg, hw):
    params = _meta_params(arch, cfg)
    x = torch.empty((1, 3) + tuple(hw), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        nets.features(arch, list(cfg), params, x)
    return int(counter.get_total_flops())


def trunk_flops(arch, cfg, hw):
    """Forward FLOPs of the trunk on one (H, W) image."""
    return _count(arch, tuple(cfg), (int(hw[0]), int(hw[1])))
