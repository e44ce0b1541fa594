"""Image resizing with torch ``F.interpolate`` bilinear semantics, and the
host-side max-side load resize.

* Multi-scale resize (``align_corners=False`` with a scale factor): output
  size floor(in * s), source coordinate (i + 0.5) / s - 0.5 -- not the
  in/out size ratio. ``torch_resize_grid`` computes the gather indices and
  weights on the host, so one batched gather/lerp serves images of every
  native size in a shape bucket (``parallel/extract.py``).
* Max-side load resize: PIL ``thumbnail((s, s), LANCZOS)``, only when the
  image is larger (cirtorch ``imresize``). PIL is imported inside the
  function that uses it.
"""
import math

import numpy as np
import torch


def scale_output_size(size, scale):
    """Output spatial size for a torch-style scale_factor resize."""
    return tuple(int(math.floor(d * scale)) for d in size)


def torch_resize_grid(in_size, out_size, scale=None):
    """Sampling indices/weights of torch bilinear ``align_corners=False``.

    With ``scale`` (``F.interpolate(scale_factor=s)``,
    ``recompute_scale_factor=False``) coordinates use 1/s directly:
    src = (dst + 0.5) / s - 0.5. Without it, the in/out size ratio is used.
    Returns (i0, i1, w): int64 indices and float32 weights of length
    ``out_size``.
    """
    step = (1.0 / scale) if scale is not None else (in_size / out_size)
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * step - 0.5
    src = np.clip(src, 0.0, None)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0).astype(np.float32)
    return i0, i1, w


def gather_resize(x, y0, y1, wy, x0, x1, wx):
    """Separable bilinear gather resize of a batch, per-image grids.

    x: (N, C, H, W); y0/y1: (N, OH) int64, wy: (N, OH) float32; x0/x1/wx the
    same over OW. Returns (N, C, OH, OW). Rows are blended first, then
    columns, as ``mdir_tpu/parallel/extract.py::_resize_one`` does.
    """
    n, c, h, w = x.shape
    oh, ow = y0.shape[1], x0.shape[1]

    def take_rows(idx):
        return torch.gather(x, 2, idx[:, None, :, None].expand(n, c, oh, w))

    wy = wy[:, None, :, None]
    rows = take_rows(y0) * (1.0 - wy) + take_rows(y1) * wy

    def take_cols(idx):
        idx = idx[:, None, None, :].expand(n, c, oh, ow)
        return torch.gather(rows, 3, idx)

    wx = wx[:, None, None, :]
    return take_cols(x0) * (1.0 - wx) + take_cols(x1) * wx


def resize_bilinear(x, scale):
    """Bilinear resize of an (N, C, H, W) tensor by ``scale``, with exact
    ``F.interpolate(scale_factor=scale, align_corners=False)`` semantics."""
    n = x.shape[0]
    h, w = x.shape[-2:]
    oh, ow = scale_output_size((h, w), scale)
    grids = []
    for size, out in ((h, oh), (w, ow)):
        i0, i1, wt = torch_resize_grid(size, out, scale)
        grids += [torch.from_numpy(a).to(x.device)[None].expand(n, out)
                  for a in (i0, i1, wt)]
    return gather_resize(x, *grids)


def max_side_resize_pil(img, imsize):
    """PIL thumbnail to max side ``imsize`` on a copy, as cirtorch imresize."""
    from PIL import Image

    img = img.copy()
    img.thumbnail((imsize, imsize), Image.LANCZOS)
    return img


def bucket_shape(h, w, multiple=32, max_side=None):
    """Round spatial dims up to ``multiple`` (optionally capped at
    max_side)."""
    round_up = lambda v: -(-v // multiple) * multiple
    bh, bw = round_up(h), round_up(w)
    if max_side:
        bh, bw = min(bh, round_up(max_side)), min(bw, round_up(max_side))
    return bh, bw
