"""Global descriptor pooling and normalisation in PyTorch (NCHW layout).

The same formulas as ``mdir_tpu/ops/pooling.py`` (cirtorch's functional
layers): MAC = global max, SPoC = global mean, GeM =
(mean(clamp(x, eps)^p))^(1/p), L2N with eps added to the norm. Every pool
takes an optional (N, H, W) validity mask so that images padded into shape
buckets pool as they would at their own size. RMAC (regional MAC) and the
region vectors of Rpool come in two forms: static, over cirtorch's region
grid of an unpadded map (``rmac``, ``roipool``), and batched, over
host-computed boxes inside each image's valid extent (``rmac_masked``,
``region_vectors``, the boxes from ``rmac_region_boxes``).

These are also the plain versions of the GeM+L2N kernel
(``pooling_kernel.gem_l2n``): ``gem_l2n_plain`` is what the kernel computes.
"""
import math

import numpy as np
import torch


def feature_mask(shape_hw, valid_hw, dtype=torch.float32):
    """(N, H, W) mask of the cells inside each image's valid extent.

    valid_hw: (N, 2) integer tensor of per-image (rows, cols).
    """
    h, w = shape_hw
    rows = torch.arange(h, device=valid_hw.device)[None, :, None]
    cols = torch.arange(w, device=valid_hw.device)[None, None, :]
    mask = (rows < valid_hw[:, 0, None, None]) \
        & (cols < valid_hw[:, 1, None, None])
    return mask.to(dtype)


def l2n(x, eps=1e-6, dim=-1):
    """x / (||x||_2 + eps) along ``dim``."""
    return x / (torch.linalg.vector_norm(x, 2, dim=dim, keepdim=True) + eps)


def mac(x, mask=None):
    """Global max pool: (N, C, H, W) -> (N, C)."""
    if mask is not None:
        x = torch.where(mask[:, None] > 0, x,
                        torch.finfo(x.dtype).min)
    return x.amax(dim=(-2, -1))


def spoc(x, mask=None):
    """Global average pool: (N, C, H, W) -> (N, C)."""
    if mask is None:
        return x.mean(dim=(-2, -1))
    m = mask[:, None].to(x.dtype)
    total = (x * m).sum(dim=(-2, -1))
    count = m.sum(dim=(-2, -1)).clamp(min=1.0)
    return total / count


def gem(x, p=3.0, eps=1e-6, mask=None):
    """Generalized-mean pool (mean(clamp(x, eps)^p))^(1/p): (N,C,H,W)->(N,C).

    ``p`` is a float or a one-element tensor (the learnable GeM parameter).
    """
    if torch.is_tensor(p):
        p = p.reshape(())
    pooled = spoc(x.clamp(min=eps) ** p, mask=mask)
    return pooled ** (1.0 / p)


def gem_l2n_plain(x, valid_hw, p, eps=1e-6):
    """Masked GeM then L2N: (N, C, H, W), (N, 2) valid extents -> (N, C).

    The plain PyTorch version of the CUDA kernel in ``pooling_kernel``.
    """
    mask = feature_mask(x.shape[-2:], valid_hw, dtype=x.dtype)
    return l2n(gem(x, p=p, eps=eps, mask=mask), eps=eps)


def _rmac_region_grid(h, w, levels=3):
    """Static RMAC region list [(y, x, size), ...] of an (h, w) map
    (cirtorch ``functional.py:26-75``).

    The arithmetic is cirtorch's float32 tensor math, as in the JAX
    package: float64 centres diverge at many extents (at (4, 33) the
    level-2 x-offsets end in 31 in float64 and 30 in torch's float32),
    which would shift regional descriptors off published-model parity.
    """
    f32 = np.float32
    ovr = f32(0.4)
    steps = np.array([2, 3, 4, 5, 6, 7], np.float32)
    mindim = min(h, w)
    # torch divides a scalar by a tensor as a reciprocal multiply (36/5
    # gives 7.2000003, not 7.1999998): the same here, or idx diverges
    bsteps = f32(max(h, w) - mindim) * (f32(1) / (steps - f32(1)))
    diffs = np.abs((f32(mindim) ** 2 - f32(mindim) * bsteps)
                   / f32(mindim) ** 2 - ovr)
    idx = int(np.argmin(diffs))  # the first minimum, as torch.min
    wd, hd = 0, 0
    if h < w:
        wd = idx + 1
    elif h > w:
        hd = idx + 1

    regions = []
    for level in range(1, levels + 1):
        region = int(math.floor(2 * mindim / (level + 1)))
        if region == 0:
            continue
        region2 = math.floor(region / 2 - 1)
        b = f32(0.0) if level + wd == 1 \
            else f32((w - region) / (level + wd - 1))
        cen_w = np.floor(
            f32(region2)
            + np.arange(level - 1 + wd + 1, dtype=np.float32) * b) - region2
        b = f32(0.0) if level + hd == 1 \
            else f32((h - region) / (level + hd - 1))
        cen_h = np.floor(
            f32(region2)
            + np.arange(level - 1 + hd + 1, dtype=np.float32) * b) - region2
        for i in cen_h:
            for j in cen_w:
                regions.append((int(i), int(j), region))
    return regions


def rmac(x, levels=3, eps=1e-6):
    """Regional MAC of unpadded maps: (N, C, H, W) -> (N, C), the global MAC
    and each grid region's MAC, each L2-normalised, summed."""
    h, w = x.shape[-2:]
    v = l2n(mac(x), eps=eps)
    for (i, j, size) in _rmac_region_grid(h, w, levels):
        v = v + l2n(mac(x[..., i:i + size, j:j + size]), eps=eps)
    return v


def roipool(x, pool_fn, levels=3):
    """Region vectors of unpadded maps for Rpool: (N, C, H, W) -> (N, R, C),
    the whole map first, then the grid's regions."""
    h, w = x.shape[-2:]
    vecs = [pool_fn(x)]
    for (i, j, size) in _rmac_region_grid(h, w, levels):
        vecs.append(pool_fn(x[..., i:i + size, j:j + size]))
    return torch.stack(vecs, dim=-2)


def _box_mask(shape_hw, box):
    """(B, H, W) mask of one region per image; box (B, 4) = [y0, x0, bh,
    bw]."""
    h, w = shape_hw
    rows = torch.arange(h, device=box.device)[None, :, None]
    cols = torch.arange(w, device=box.device)[None, None, :]
    y0 = box[:, 0, None, None]
    x0 = box[:, 1, None, None]
    return ((rows >= y0) & (rows < y0 + box[:, 2, None, None])
            & (cols >= x0) & (cols < x0 + box[:, 3, None, None]))


def region_vectors(x, boxes, pool_fn):
    """Every region of every image: (B, C, H, W), (B, R, 4) -> (B, R, C).

    ``pool_fn(x, mask)`` pools under a (B, H, W) mask. The boxes lie inside
    each image's valid feature extent (``rmac_region_boxes``); a zero-size
    box is padding. One region at a time, as the JAX package's ``lax.map``
    does, so no (B, R, C, H, W) tensor is made.
    """
    shape_hw = x.shape[-2:]
    vecs = [pool_fn(x, _box_mask(shape_hw, boxes[:, r]))
            for r in range(boxes.shape[1])]
    return torch.stack(vecs, dim=1)


def rmac_masked(x, boxes, eps=1e-6):
    """Regional MAC of a padded batch: each box's masked MAC, L2N, the
    padded slots zeroed, summed over the boxes. ``boxes`` holds the whole
    valid extent as region 0 (``rmac`` pools the whole map first).

    A padded slot's MAC is ``finfo.min`` in every channel and its L2N is
    finite (zero when the norm overflows); it is zeroed only after that,
    so no ``-inf * 0`` makes a NaN.
    """
    vecs = l2n(region_vectors(x, boxes, lambda f, m: mac(f, mask=m)),
               eps=eps)
    real = (boxes[..., 2] > 0)[..., None].to(vecs.dtype)
    return (vecs * real).sum(dim=-2)


def rmac_region_boxes(h, w, levels=3):
    """Host: [y0, x0, bh, bw] boxes of the RMAC grid of an (h, w) feature
    extent, the whole extent first (the reference's region order)."""
    boxes = [(0, 0, h, w)]
    for (i, j, size) in _rmac_region_grid(h, w, levels):
        boxes.append((i, j, size, size))
    return boxes


def powerlaw(x, eps=1e-6):
    """Signed square-root power law (cirtorch ``functional.py:133-135``, as
    documented: the reference's own version is never called)."""
    x = x + eps
    return torch.sign(x) * torch.sqrt(torch.abs(x))


POOLING = {
    "mac": mac,
    "spoc": spoc,
    "gem": gem,
    "rmac": rmac,
}
