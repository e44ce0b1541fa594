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
* The host augmentations' resizes without PIL or cv2 (the card's machine
  has neither): ``pil_bilinear_u8`` is PIL's ``Image.resize(size,
  BILINEAR)`` of a uint8 image bit for bit (Pillow's ``Resample.c``: a
  triangle filter whose support is scaled by the downscale factor, weights
  normalised in double and rounded to 22-bit fixed point, a horizontal
  pass then a vertical one, each rounded to uint8), and
  ``cv2_linear_f32`` is ``cv2.resize(img, (w, h))`` with ``INTER_LINEAR``
  on float32 (samples at ``(i + 0.5) * in / out - 0.5``, clamped at the
  borders, the fraction taken in double and the weights in float32, a
  horizontal pass then a vertical one; no antialiasing).
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


def gather_crop(x, ys, xs):
    """Rows ``ys`` (N, OH) then columns ``xs`` (N, OW) of each image of x
    (N, C, H, W): a pure gather, (N, C, OH, OW)."""
    n, c, _, w = x.shape
    oh, ow = ys.shape[1], xs.shape[1]
    rows = torch.gather(x, 2, ys[:, None, :, None].expand(n, c, oh, w))
    return torch.gather(rows, 3, xs[:, None, None, :].expand(n, c, oh, ow))


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


_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def _pil_bilinear_coeffs(in_size, out_size):
    """Pillow ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter: each output's first input and its fixed-point weights,
    (out,) int64 and (out, taps) int64 (zero past an output's own taps).
    Every output's sums run in Pillow's order, in double."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    first = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                       in_size) - first
    w = np.zeros((out_size, taps))
    total = np.zeros(out_size)
    for k in range(taps):
        w[:, k] = np.where(k < count, np.maximum(
            0.0, 1.0 - np.abs((k + first - center + 0.5) * ss)), 0.0)
        total += w[:, k]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = w * (1 << _PRECISION_BITS)
    weights = np.where(fixed < 0, (-0.5 + fixed).astype(np.int64),
                       (0.5 + fixed).astype(np.int64))
    return first, weights


def _pil_pass(img, coeffs, axis):
    """One fixed-point pass along ``axis`` (0 or 1) of an (H, W, C) image
    of uint8 values; int32 holds its sums (255 * 2^22 + rounding)."""
    first, weights = coeffs
    shape = [1, 1, 1]
    shape[axis] = -1
    acc = np.full(img.shape[:axis] + (len(first),) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(weights.shape[1]):
        taken = np.take(img, np.minimum(first + k, img.shape[axis] - 1),
                        axis=axis)
        acc += taken * weights[:, k].astype(np.int32).reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def pil_bilinear_u8(img, size):
    """PIL ``Image.fromarray(img).resize(size, BILINEAR)`` as an array:
    ``img`` (H, W, 3) or (H, W) uint8, ``size`` (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError("PIL's bilinear resize is copied for (H, W, 3) and "
                         "(H, W) uint8 images (PIL's RGB and L), not %s %s"
                         % (img.dtype, img.shape))
    h, w = img.shape[:2]
    out_w, out_h = (int(v) for v in size)
    if (out_w, out_h) == (w, h):
        return img.copy()
    x = img.reshape(h, w, -1).astype(np.int32)
    if out_w != w:
        x = _pil_pass(x, _pil_bilinear_coeffs(w, out_w), 1)
    if out_h != h:
        x = _pil_pass(x, _pil_bilinear_coeffs(h, out_h), 0)
    return x.astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])


def _cv2_linear_taps(in_size, out_size):
    """cv2 ``resize`` INTER_LINEAR taps of one axis: (i0, i1, w0, w1)."""
    scale = 1.0 / (out_size / in_size)
    f = (np.arange(out_size) + 0.5) * scale - 0.5  # double, as cv2 5
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    low = i0 < 0
    f[low], i0[low] = 0, 0
    high = i0 >= in_size - 1
    f[high], i0[high] = 0, in_size - 1
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, np.float32(1) - f, f


def cv2_linear_f32(img, size):
    """``cv2.resize(img, size)`` (INTER_LINEAR) of a float32 (H, W) or
    (H, W, C) image; ``size`` (width, height)."""
    img = np.asarray(img, np.float32)
    out_w, out_h = (int(v) for v in size)
    if (out_h, out_w) == img.shape[:2]:
        return img.copy()
    x0, x1, a0, a1 = _cv2_linear_taps(img.shape[1], out_w)
    y0, y1, b0, b1 = _cv2_linear_taps(img.shape[0], out_h)
    extra = (1,) * (img.ndim - 2)
    cols, lines = (1, -1) + extra, (-1, 1) + extra
    rows = img[:, x0] * a0.reshape(cols) + img[:, x1] * a1.reshape(cols)
    return rows[y0] * b0.reshape(lines) + rows[y1] * b1.reshape(lines)


def bucket_shape(h, w, multiple=32, max_side=None):
    """Round spatial dims up to ``multiple`` (optionally capped at
    max_side)."""
    round_up = lambda v: -(-v // multiple) * multiple
    bh, bw = round_up(h), round_up(w)
    if max_side:
        bh, bw = min(bh, round_up(max_side)), min(bw, round_up(max_side))
    return bh, bw
