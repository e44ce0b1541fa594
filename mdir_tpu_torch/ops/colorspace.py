"""The float lab -> RGB conversion of the lab CLAHE chain, in PyTorch.

What ``mdir_tpu/ops/colorspace.py`` computes for lab, with OpenCV's float
semantics and the reference's normalization constants (the L channel over
100, a/b shifted by 128 over 255). The forward conversion of the chain is
the exact lattice of ``ops/lab_trilinear.py``, so only the inverse is float
math here. The luv, hls and gray conversions are not ported (ROADMAP §1.3).
"""
import numpy as np
import torch

# D65 sRGB -> XYZ matrix and white point, as used by OpenCV.
RGB2XYZ = np.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], dtype=np.float32)
XYZ2RGB = np.linalg.inv(RGB2XYZ).astype(np.float32)
WHITE = (0.950456, 1.0, 1.088754)

LAB_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)
LAB_SCALE = np.array([100.0, 255.0, 255.0], np.float32)


def linear_to_srgb_exact(c):
    """Linear -> sRGB transfer function."""
    return torch.where(c > 0.0031308, 1.055 * c ** (1 / 2.4) - 0.055,
                       12.92 * c)


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
    lin = xyz @ torch.from_numpy(XYZ2RGB.T.copy()).to(xyz.device)
    return torch.clamp(linear_to_srgb_exact(lin), 0.0, 1.0)


def normspace2rgb(img, colorspace):
    """Normalized colorspace -> RGB; lab only in this port."""
    if colorspace.lower() != "lab":
        raise NotImplementedError(
            "colorspace %r is not ported (ROADMAP §1.3)" % colorspace)
    scale = torch.from_numpy(LAB_SCALE).to(img.device)
    shift = torch.from_numpy(LAB_SHIFT).to(img.device)
    return lab_to_rgb(img * scale - shift)
