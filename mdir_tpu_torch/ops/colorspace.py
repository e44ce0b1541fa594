"""Colorspace conversions in PyTorch with OpenCV's float32 semantics.

The port of ``mdir_tpu/ops/colorspace.py``: RGB in [0, 1] to and from XYZ,
Lab, Luv, HLS and gray, and the reference's normalized spaces
(``rgb2normspace`` / ``normspace2rgb``: L over 100, a/b shifted by 128 over
255, Luv's u/v by (134, 140) over (354, 262); lsh is HLS reordered to
(L, S, H / 360); gray goes one way only). "hls" is not a normspace: both
packages raise on it.

cv2's float Lab path linearizes sRGB through a spline; ``srgb_to_linear``
interpolates the same calibrated 4097-entry table as the JAX package
(``_gamma_lut.npy``, this package's own copy of the JAX package's file, byte
for byte). The uint8-origin paths build their (3 * 256,) tables on the host
as the JAX package does and index them; the JAX package contracts a one-hot
with them instead, which is a TPU way round slow gathers and not part of the
semantics. The indexing sums a pixel's three entries as ``(r + g) + b``;
XLA's contraction sums them in an order of its own, so a sum may differ
from the JAX package's by up to two float32 ulps, one a rounding
(``tests/test_torch_colorspace.py`` measures it; the uint8 planes it feeds
are equal).

The host transforms convert Luv as cv2 does, both ways (``rgb_to_luv_cv2``
on the analytic curve, ``luv_to_rgb_cv2`` with cv2's clamp); ``rgb_to_luv``
and ``luv_to_rgb`` are the JAX package's device conversions, which the
device chain keeps.

``rgb_u8_to_luv_l`` is the L plane of cv2's float Luv: cv2 converts Luv with
the analytic sRGB curve, not the Lab spline, so its Y comes from an analytic
table (float64 on the host, then float32).
"""
import functools
import os

import numpy as np
import torch

# D65 sRGB -> XYZ matrix and white point, as used by OpenCV.
RGB2XYZ = np.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], dtype=np.float32)
XYZ2RGB = np.linalg.inv(RGB2XYZ).astype(np.float32)
WHITE = (0.950456, 1.0, 1.088754)

# the reference's normalization constants
LAB_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)
LAB_SCALE = np.array([100.0, 255.0, 255.0], np.float32)
LUV_SHIFT = np.array([0.0, 134.0, 140.0], np.float32)
LUV_SCALE = np.array([100.0, 354.0, 262.0], np.float32)

NORMSPACES = ("lab", "luv", "lsh", "gray")

_GAMMA_LUT_PATH = os.path.join(os.path.dirname(__file__), "_gamma_lut.npy")
_GAMMA_LUT_SIZE = 4096


def _const(array, like):
    """A host constant as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(array, np.float32), device=like.device)


def _unsupported(colorspace):
    return NotImplementedError("Colorspace %s is not supported" % colorspace)


@functools.lru_cache(maxsize=1)
def _gamma_lut():
    """(4097,) float32: the calibrated sRGB -> linear curve of cv2's Lab."""
    return np.load(_GAMMA_LUT_PATH)


def srgb_to_linear_exact(c):
    """The analytic sRGB transfer function."""
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def linear_to_srgb_exact(c):
    """Linear -> sRGB transfer function."""
    return torch.where(c > 0.0031308, 1.055 * c ** (1 / 2.4) - 0.055,
                       12.92 * c)


def srgb_to_linear(c):
    """sRGB -> linear through the calibrated table (cv2's Lab spline)."""
    table = _const(_gamma_lut(), c)
    x = torch.clamp(c, 0.0, 1.0) * _GAMMA_LUT_SIZE
    i0 = torch.clamp(torch.floor(x), 0, _GAMMA_LUT_SIZE - 1)
    frac = x - i0
    i0 = i0.to(torch.int64)
    return table[i0] * (1 - frac) + table[i0 + 1] * frac


def _cbrt(t):
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


def _f_lab(t):
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _lightness(y):
    return torch.where(y > 0.008856, 116.0 * _cbrt(y) - 16.0, 903.3 * y)


def _mat(x, matrix):
    """(..., 3) @ matrix.T."""
    return x @ _const(matrix, x).T


def rgb_to_xyz(rgb, gamma=True):
    lin = srgb_to_linear(rgb) if gamma else rgb
    return _mat(lin, RGB2XYZ)


def _lab_from_xyz(xyz):
    xn = xyz / _const(WHITE, xyz)
    fx, fy, fz = _f_lab(xn[..., 0]), _f_lab(xn[..., 1]), _f_lab(xn[..., 2])
    lum = _lightness(xn[..., 1])
    return torch.stack([lum, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def rgb_to_lab(rgb):
    """RGB [0, 1] -> Lab, L in [0, 100] (cv2 float)."""
    return _lab_from_xyz(rgb_to_xyz(rgb))


def lab_to_rgb(lab):
    """(..., 3) Lab (L in [0, 100]) -> (..., 3) RGB in [0, 1], cv2 float
    semantics: for L <= 8 both y and fy come from the linear segment, and
    the x/z inverse thresholds on f itself."""
    lum, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = torch.where(lum > 8.0, ((lum + 16.0) / 116.0) ** 3, lum / 903.3)
    fy = torch.where(lum > 8.0, (lum + 16.0) / 116.0,
                     7.787 * (lum / 903.3) + 16.0 / 116.0)
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    f_thresh = 7.787 * 0.008856 + 16.0 / 116.0

    def finv(f):
        return torch.where(f > f_thresh, f ** 3, (f - 16.0 / 116.0) / 7.787)

    xyz = torch.stack([finv(fx) * WHITE[0], y * WHITE[1],
                       finv(fz) * WHITE[2]], dim=-1)
    return torch.clamp(linear_to_srgb_exact(_mat(xyz, XYZ2RGB)), 0.0, 1.0)


def _white_uv():
    xn, yn, zn = WHITE
    dn = xn + 15.0 * yn + 3.0 * zn
    return 4.0 * xn / dn, 9.0 * yn / dn


def _luv_from_xyz(xyz):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lum = _lightness(y)
    d = x + 15.0 * y + 3.0 * z
    d = torch.where(d == 0, torch.full_like(d, 1e-30), d)
    u_p, v_p = 4.0 * x / d, 9.0 * y / d
    un, vn = _white_uv()
    return torch.stack(
        [lum, 13.0 * lum * (u_p - un), 13.0 * lum * (v_p - vn)], dim=-1)


def rgb_to_luv(rgb):
    """RGB [0, 1] -> Luv (cv2 float semantics, the calibrated curve)."""
    return _luv_from_xyz(rgb_to_xyz(rgb))


def rgb_to_luv_cv2(rgb):
    """RGB [0, 1] -> Luv as cv2's float RGB2Luv computes it, on the
    analytic sRGB curve (50x closer to cv2 than ``rgb_to_luv``)."""
    return _luv_from_xyz(_mat(srgb_to_linear_exact(rgb), RGB2XYZ))


def luv_to_rgb(luv):
    lum, u, v = luv[..., 0], luv[..., 1], luv[..., 2]
    un, vn = _white_uv()
    safe_l = torch.where(lum == 0, torch.full_like(lum, 1e-30), lum)
    u_p = u / (13.0 * safe_l) + un
    v_p = v / (13.0 * safe_l) + vn
    y = torch.where(lum > 8.0, ((lum + 16.0) / 116.0) ** 3, lum / 903.3)
    v_p = torch.where(v_p == 0, torch.full_like(v_p, 1e-30), v_p)
    x = y * 9.0 * u_p / (4.0 * v_p)
    z = y * (12.0 - 3.0 * u_p - 20.0 * v_p) / (4.0 * v_p)
    lin = _mat(torch.stack([x, y, z], dim=-1), XYZ2RGB)
    return torch.clamp(linear_to_srgb_exact(lin), 0.0, 1.0)


def luv_to_rgb_cv2(luv):
    """Luv -> RGB as cv2's float Luv2RGB forms it: 3 u' and 1 / (4 v')
    from L and the white point, the latter clamped to [-0.25, 0.25], and
    linear RGB clamped to [0, 1]. ``luv_to_rgb`` (the JAX package's) has no
    clamp and leaves the gamut where v' nears zero."""
    lum, u, v = luv[..., 0], luv[..., 1], luv[..., 2]
    xn, yn, zn = WHITE
    d = 1.0 / (xn + 15.0 * yn + 3.0 * zn)
    un, vn = 4.0 * 13.0 * xn * d, 9.0 * 13.0 * yn * d
    y = torch.where(lum >= 8.0, ((lum + 16.0) / 116.0) ** 3, lum / 903.3)
    up = 3.0 * (lum * un + u)
    vp = torch.clamp(0.25 / (lum * vn + v), -0.25, 0.25)
    x = 3.0 * y * up * vp
    z = y * ((12.0 * 13.0 * lum - up) * vp - 5.0)
    lin = torch.clamp(_mat(torch.stack([x, y, z], dim=-1), XYZ2RGB), 0.0, 1.0)
    return torch.clamp(linear_to_srgb_exact(lin), 0.0, 1.0)


def rgb_to_hls(rgb):
    """RGB [0, 1] -> HLS, H in degrees [0, 360) (cv2 float semantics)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb[..., :3], dim=-1)
    mn = torch.amin(rgb[..., :3], dim=-1)
    lum = (mx + mn) / 2.0
    c = mx - mn
    zero = torch.zeros_like(c)
    safe_c = torch.where(c == 0, torch.full_like(c, 1e-30), c)
    s = torch.where(
        c == 0, zero,
        torch.where(lum < 0.5, c / torch.clamp(mx + mn, min=1e-30),
                    c / torch.clamp(2.0 - (mx + mn), min=1e-30)))
    h = torch.where(mx == r, 60.0 * (g - b) / safe_c,
                    torch.where(mx == g, 120.0 + 60.0 * (b - r) / safe_c,
                                240.0 + 60.0 * (r - g) / safe_c))
    h = torch.where(c == 0, zero, torch.where(h < 0, h + 360.0, h))
    return torch.stack([h, lum, s], dim=-1)


def hls_to_rgb(hls):
    h, lum, s = hls[..., 0], hls[..., 1], hls[..., 2]
    q = torch.where(lum < 0.5, lum * (1 + s), lum + s - lum * s)
    p = 2 * lum - q
    hk = (h / 360.0) % 1.0

    def channel(t):
        t = t % 1.0
        return torch.where(
            t < 1 / 6, p + (q - p) * 6 * t,
            torch.where(t < 0.5, q,
                        torch.where(t < 2 / 3, p + (q - p) * (2 / 3 - t) * 6,
                                    p)))

    return torch.stack(
        [channel(hk + 1 / 3), channel(hk), channel(hk - 1 / 3)], dim=-1)


def rgb_to_gray(rgb):
    return rgb[..., :3] @ _const([0.299, 0.587, 0.114], rgb)


def rgb2normspace(img, colorspace, cv2_luv=False):
    """RGB -> the reference's normalized colorspace; luv through
    ``rgb_to_luv_cv2`` with ``cv2_luv`` (the host transforms')."""
    colorspace = colorspace.lower()
    if colorspace == "lab":
        return (rgb_to_lab(img) + _const(LAB_SHIFT, img)) \
            / _const(LAB_SCALE, img)
    if colorspace == "luv":
        luv = rgb_to_luv_cv2(img) if cv2_luv else rgb_to_luv(img)
        return (luv + _const(LUV_SHIFT, img)) / _const(LUV_SCALE, img)
    if colorspace == "lsh":
        hls = rgb_to_hls(img) / _const([360.0, 1.0, 1.0], img)
        return torch.stack([hls[..., 1], hls[..., 2], hls[..., 0]], dim=-1)
    if colorspace == "gray":
        return rgb_to_gray(img)[..., None]
    raise _unsupported(colorspace)


def normspace2rgb(img, colorspace, cv2_luv=False):
    """The reference's normalized colorspace -> RGB (not gray); luv through
    ``luv_to_rgb_cv2`` with ``cv2_luv`` (the host transforms')."""
    colorspace = colorspace.lower()
    if colorspace == "lab":
        return lab_to_rgb(img * _const(LAB_SCALE, img)
                          - _const(LAB_SHIFT, img))
    if colorspace == "luv":
        luv = img * _const(LUV_SCALE, img) - _const(LUV_SHIFT, img)
        return luv_to_rgb_cv2(luv) if cv2_luv else luv_to_rgb(luv)
    if colorspace == "lsh":
        hls = torch.stack([img[..., 2], img[..., 0], img[..., 1]], dim=-1)
        return hls_to_rgb(hls * _const([360.0, 1.0, 1.0], img))
    raise _unsupported(colorspace)


# ---------------------------------------------------------------------------
# uint8-origin paths: per-(channel, level) tables built on the host
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _u8_linear_table():
    """(256,) float32: the calibrated curve at every uint8 level, with the
    arithmetic of ``srgb_to_linear``."""
    lut = _gamma_lut()
    levels = np.arange(256, dtype=np.float32) / np.float32(255.0)
    x = levels * _GAMMA_LUT_SIZE
    i0 = np.clip(np.floor(x).astype(np.int32), 0, _GAMMA_LUT_SIZE - 1)
    frac = (x - i0).astype(np.float32)
    return lut[i0] * (np.float32(1.0) - frac) + lut[i0 + 1] * frac


@functools.lru_cache(maxsize=1)
def _u8_xyz_table():
    """(3 * 256, 3) float32: entry (c * 256 + v, k) = RGB2XYZ[k, c] *
    linear(v), on the calibrated curve."""
    table = RGB2XYZ.T[:, None, :] * _u8_linear_table()[None, :, None]
    return table.reshape(3 * 256, 3).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _u8_xyz_analytic_table():
    """(3 * 256, 3) float32: ``_u8_xyz_table`` on the analytic curve,
    computed in float64; its Y column is ``rgb_u8_to_luv_l``'s table."""
    k = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(k > 0.04045, ((k + 0.055) / 1.055) ** 2.4, k / 12.92)
    table = np.asarray(RGB2XYZ, np.float64).T[:, None, :] \
        * lin[None, :, None]
    return table.reshape(3 * 256, 3).astype(np.float32)


def _table_sum(u8, table):
    """(..., 3) uint8 -> table[r] + table[256 + g] + table[512 + b]."""
    t = torch.as_tensor(table, device=u8.device)
    v = u8[..., :3].to(torch.int64)
    return (t[v[..., 0]] + t[v[..., 1] + 256]) + t[v[..., 2] + 512]


def rgb_u8_to_xyz(u8):
    """(..., 3) uint8 -> XYZ float32 on the calibrated curve."""
    return _table_sum(u8, _u8_xyz_table())


def rgb_u8_to_luv_l(u8):
    """(..., 3) uint8 -> float32 L of cv2's float Luv (analytic-Y table)."""
    y = _table_sum(u8, np.ascontiguousarray(_u8_xyz_analytic_table()[:, 1]))
    return _lightness(y / WHITE[1])


def rgb_u8_to_normspace(u8, colorspace):
    """uint8 RGB -> normalized colorspace: lab and luv from the calibrated
    XYZ table, lsh and gray through the float conversions of u8 / 255."""
    colorspace = colorspace.lower()
    if colorspace == "lab":
        lab = _lab_from_xyz(rgb_u8_to_xyz(u8))
        return (lab + _const(LAB_SHIFT, lab)) / _const(LAB_SCALE, lab)
    if colorspace == "luv":
        luv = _luv_from_xyz(rgb_u8_to_xyz(u8))
        return (luv + _const(LUV_SHIFT, luv)) / _const(LUV_SCALE, luv)
    return rgb2normspace(u8[..., :3].to(torch.float32) / 255.0, colorspace)


def rgb_u8_to_luv_analytic(u8):
    """uint8 RGB -> normalized Luv on the analytic curve, cv2's float Luv
    on u8 / 255; its L channel is ``rgb_u8_to_luv_l`` / 100."""
    luv = _luv_from_xyz(_table_sum(u8, _u8_xyz_analytic_table()))
    return (luv + _const(LUV_SHIFT, luv)) / _const(LUV_SCALE, luv)
