"""Plain PyTorch photometric chains of one image: uint8 RGB -> normalised
float32 (H, W, 3).

``normalize``: ``u8 / 255``, then ``(x - mean) / std``.

``lab_clahe``: the ``apply_clahe:<clip>:lab:<grid> | totensor | normalize``
chain as OpenCV computes it on 8-bit RGB:

1. Lab by OpenCV's fixed-point trilinear lattice: per channel
   ``cx = rint(f32(v / 255) * 2^14)``, corner ``cx >> 9``, weight
   ``(cx & 511) >> 5``, the 8 corners of the 33^3 lattice blended with
   integer weights, ``n = (blend + 2048) >> 12``. The lattice is a frozen
   copy of OpenCV's node table (``lab_nodes.npy``), the constant of its
   algorithm. L as 8 bits is ``(n_L * 255) >> 14``; a and b normalised are
   ``n / 64 / 255``.
2. CLAHE of the 8-bit L plane, OpenCV's algorithm: reflect-101 padding of
   both sides by ``grid - size % grid`` when either is not divisible, a
   256-bin histogram per tile clipped at ``max(int(clip * area / 256), 1)``
   with the excess spread evenly and the remainder on every
   ``max(256 // remainder, 1)``-th bin, the LUT ``round(f32(cdf) *
   f32(255 / area))``, and each pixel blending its four tiles' LUTs at
   ``y * (1 / tile) - 0.5``, x then y, in float32, rounded half to even.
3. Lab back to RGB with OpenCV's float formulas, then normalise.

Each image alone, at its own size, on whatever device its tensor is on.
"""
import os

import numpy as np
import torch

LAB_NODES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "lab_nodes.npy")
LAB_SHIFT = (0.0, 128.0, 128.0)
LAB_SCALE = (100.0, 255.0, 255.0)
RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                    [0.212671, 0.715160, 0.072169],
                    [0.019334, 0.119193, 0.950227]], dtype=np.float32)
XYZ2RGB = np.linalg.inv(RGB2XYZ).astype(np.float32)
WHITE = (0.950456, 1.0, 1.088754)
BINS = 256


def _f32(values, like):
    return torch.as_tensor(np.asarray(values, np.float32), device=like.device)


def normalize(x, mean, std):
    """(H, W, C) float32 -> (x - mean) / std."""
    return (x - _f32(mean, x)) / _f32(std, x)


def lab_lattice(rgb_u8):
    """(H, W, 3) uint8 -> (H, W, 3) int64 lattice values n of L, a, b."""
    nodes = torch.from_numpy(np.load(LAB_NODES).astype(np.int64)).to(
        rgb_u8.device).reshape(-1, 3)
    v32 = np.arange(256, dtype=np.float32) / np.float32(255.0)
    cx = np.rint(v32.astype(np.float64) * 16384).astype(np.int64)
    corner = torch.from_numpy(cx >> 9).to(rgb_u8.device)
    weight = torch.from_numpy((cx & 511) >> 5).to(rgb_u8.device)
    v = rgb_u8.to(torch.int64)
    t = [corner[v[..., c]] for c in range(3)]
    f = [weight[v[..., c]] for c in range(3)]
    blend = torch.zeros(rgb_u8.shape, dtype=torch.int64,
                        device=rgb_u8.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (f[0] if dx else 16 - f[0]) * (f[1] if dy else 16 - f[1]) \
                    * (f[2] if dz else 16 - f[2])
                ix, iy, iz = (torch.clamp(t[i] + d, max=32)
                              for i, d in enumerate((dx, dy, dz)))
                blend += nodes[(ix * 33 + iy) * 33 + iz] * w[..., None]
    return (blend + 2048) >> 12


def clahe(plane, clip, grid):
    """OpenCV's CLAHE of an (H, W) int64 plane of 8-bit values; returns
    the float32 result (whole numbers in [0, 255])."""
    h, w = plane.shape
    if h % grid or w % grid:
        padded = torch.nn.functional.pad(
            plane[None, None].to(torch.float64),
            (0, grid - w % grid, 0, grid - h % grid),
            mode="reflect")[0, 0].to(torch.int64)
    else:
        padded = plane
    ph, pw = padded.shape
    th, tw = ph // grid, pw // grid
    area = th * tw
    tiles = padded.reshape(grid, th, grid, tw).permute(0, 2, 1, 3).reshape(
        grid * grid, area)
    offsets = torch.arange(grid * grid, device=plane.device)[:, None] * BINS
    hist = torch.bincount((tiles + offsets).reshape(-1),
                          minlength=grid * grid * BINS).reshape(-1, BINS)
    limit = max(int(clip * area / BINS), 1)
    excess = (hist - limit).clamp(min=0).sum(1, keepdim=True)
    hist = hist.clamp(max=limit) + excess // BINS
    residual = excess % BINS
    step = torch.clamp(BINS // residual.clamp(min=1), min=1)
    bins = torch.arange(BINS, device=plane.device)[None]
    hist = hist + ((residual > 0) & (bins % step == 0)
                   & (bins // step < residual)).to(hist.dtype)
    scale = torch.tensor(np.float32(255.0) / np.float32(area),
                         device=plane.device)
    luts = torch.clamp(torch.round(torch.cumsum(hist, 1).to(torch.float32)
                                   * scale), 0, 255)

    def axis(size, tile):
        inv = torch.tensor(np.float32(1.0) / np.float32(tile),
                           device=plane.device)
        pos = torch.arange(size, device=plane.device, dtype=torch.float32) \
            * inv - 0.5
        first = torch.floor(pos)
        frac = pos - first
        first = first.to(torch.int64)
        return (first.clamp(min=0), (first + 1).clamp(max=grid - 1), frac,
                1.0 - frac)

    ty1, ty2, ya, ya1 = axis(h, th)
    tx1, tx2, xa, xa1 = axis(w, tw)

    def lut(ty, tx):
        return luts[ty[:, None] * grid + tx[None, :], plane]

    xa, xa1, ya, ya1 = xa[None], xa1[None], ya[:, None], ya1[:, None]
    res = (lut(ty1, tx1) * xa1 + lut(ty1, tx2) * xa) * ya1 \
        + (lut(ty2, tx1) * xa1 + lut(ty2, tx2) * xa) * ya
    return torch.clamp(torch.round(res), 0, 255)


def _linear_to_srgb(c):
    return torch.where(c > 0.0031308, 1.055 * c ** (1 / 2.4) - 0.055,
                       12.92 * c)


def lab_to_rgb(lab):
    """(..., 3) Lab, L in [0, 100] -> RGB in [0, 1], OpenCV's float
    formulas (the linear segment below L = 8)."""
    lum, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = torch.where(lum > 8.0, ((lum + 16.0) / 116.0) ** 3, lum / 903.3)
    fy = torch.where(lum > 8.0, (lum + 16.0) / 116.0,
                     7.787 * (lum / 903.3) + 16.0 / 116.0)
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    thresh = 7.787 * 0.008856 + 16.0 / 116.0

    def finv(f):
        return torch.where(f > thresh, f ** 3, (f - 16.0 / 116.0) / 7.787)

    xyz = torch.stack([finv(fx) * WHITE[0], y * WHITE[1],
                       finv(fz) * WHITE[2]], dim=-1)
    rgb = xyz @ _f32(XYZ2RGB, xyz).T
    return torch.clamp(_linear_to_srgb(rgb), 0.0, 1.0)


def lab_clahe(rgb_u8, clip, grid, mean, std):
    """(H, W, 3) uint8 -> the normalised (H, W, 3) float32 of the lab
    CLAHE chain."""
    n = lab_lattice(rgb_u8)
    l_u8 = (n[..., 0] * 255) >> 14
    ab = (n[..., 1:].to(torch.float32) * (1.0 / 64.0)) / 255.0
    chan = clahe(l_u8, clip, grid) / 255.0
    spc = torch.cat([chan[..., None], ab], dim=-1)
    lab = spc * _f32(LAB_SCALE, spc) - _f32(LAB_SHIFT, spc)
    return normalize(lab_to_rgb(lab), mean, std)


def run_chain(name, rgb_u8, mean, std, clip=4.0, grid=8):
    """The named chain of one (H, W, 3) uint8 image tensor."""
    if name == "lab_clahe":
        return lab_clahe(rgb_u8, clip, grid, mean, std)
    if name == "normalize":
        return normalize(rgb_u8.to(torch.float32) / 255.0, mean, std)
    raise ValueError("unknown chain %r" % name)
