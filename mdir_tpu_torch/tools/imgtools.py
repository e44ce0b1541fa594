"""Network output -> displayable uint8 RGB, undoing the normalisation of the
input transform (``mdir_tpu/tools/imgtools.py``, reference
``mdir/tools/imgtools.py``), for HWC float arrays.

The port has the transform chains of its registry
(``data/transforms.py``): RGB outputs are denormalised with mean/std,
optionally stretched, then clipped to uint8, in the JAX package's order of
operations. Inverting a colorspace (``tospace:lab`` and the like) needs
cv2's colorspace conversions, which the port does not have: it raises,
naming ROADMAP queue 1 item 4, where the host colorspace path is queued.
The comparison grid (``makegrid``) comes with the html report (queue 1
item 7).
"""
import numpy as np

NOT_PORTED = "ROADMAP queue 1 item 4"


def _transforms_to_colorspace(transforms):
    if "tospace:lab" in transforms or "tolab" in transforms:
        return "lab"
    if "tospace:luv" in transforms or "toluv" in transforms:
        return "luv"
    if "tospace:lsh" in transforms or "tolsh" in transforms:
        return "lsh"
    return None


def _tensor_to_image(img, mean_std, transforms, stretch_by=False):
    """Undo the normalisation of an HWC float output -> uint8 RGB."""
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    colorspace = _transforms_to_colorspace(transforms)
    if colorspace:
        raise NotImplementedError(
            "inverting the %s colorspace needs the host colorspace path "
            "(%s)" % (colorspace, NOT_PORTED))
    mean = np.asarray(mean_std[0], np.float32)
    std = np.asarray(mean_std[1], np.float32)
    out = img[..., :3] * std[:3] + mean[:3]
    if stretch_by:
        if stretch_by == "auto":
            out = out - np.min(out)
            out = out / max(np.max(out), 1e-12)
        else:
            out = out / stretch_by + 1 / 2.0 / stretch_by
    return np.clip(out * 255, 0, 255).astype(np.uint8)


def get_image(imgs, mean_std, colortransforms, stretch_by=False):
    """[input, output] HWC arrays -> displayable uint8 RGB of the output."""
    return _tensor_to_image(np.asarray(imgs[1]), mean_std, colortransforms,
                            stretch_by)
