"""Seeded images, made on the device: smooth colour fields (one per
template, bilinear from a 6 x 8 grid of uniform colours) with Gaussian
noise, cut at each image's offset and size, as uint8 (H, W, 3) arrays on
the host, where a loader serves them from memory."""
import numpy as np
import torch
import torch.nn.functional as F


def fields(templates, side, generator, device):
    """(T, 3, side, side) float32 colour fields in [0, 1]."""
    grid = torch.rand((templates, 3, 6, 8), generator=generator,
                      device=device)
    return F.interpolate(grid, size=(side, side), mode="bilinear",
                         align_corners=False)


def render(specs, colour, noise, generator):
    """{name: (H, W, 3) uint8 numpy} of the specs (``name``, ``hw``,
    ``template``, ``offset``), cut from ``colour`` with noise of std
    ``noise`` grey levels."""
    out = {}
    for spec in specs:
        (h, w), (y, x) = spec["hw"], spec["offset"]
        img = colour[spec["template"], :, y:y + h, x:x + w] * 255.0 \
            + noise * torch.randn((3, h, w), generator=generator,
                                  device=colour.device)
        out[spec["name"]] = np.ascontiguousarray(
            img.clamp(0, 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy())
    return out
