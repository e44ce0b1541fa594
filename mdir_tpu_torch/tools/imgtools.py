"""Network output -> displayable uint8 RGB, undoing the normalisation and
the colorspace of the input transform (``mdir_tpu/tools/imgtools.py``,
reference ``mdir/tools/imgtools.py``), for HWC float arrays.

RGB outputs are denormalised with mean/std, optionally stretched, then
clipped to uint8. An output in lab, luv or lsh (a ``tospace`` transform) is
denormalised, clipped to the space's range and converted back to RGB with
the float conversions of ``ops/colorspace.py`` (the JAX package calls cv2's)
on the host's CPU, in the JAX package's order of operations. ``makegrid``
lays [input, ground truth, output] thumbnails out as one comparison image,
shrunk with PIL's ``thumbnail`` as the JAX package shrinks them (PIL is
imported inside it: no path of the card's calls it).
"""
import numpy as np
import torch

from ..ops import colorspace as cs


def _transforms_to_colorspace(transforms):
    if "tospace:lab" in transforms or "tolab" in transforms:
        return "lab"
    if "tospace:luv" in transforms or "toluv" in transforms:
        return "luv"
    if "tospace:lsh" in transforms or "tolsh" in transforms:
        return "lsh"
    return None


def _tensor_to_image(img, mean_std, transforms, stretch_by=False):
    """Undo normalisation (and colorspace) of an HWC float output -> uint8
    RGB."""
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    colorspace = _transforms_to_colorspace(transforms)
    mean = np.asarray(mean_std[0], np.float32)
    std = np.asarray(mean_std[1], np.float32)

    if not colorspace:
        out = img[..., :3] * std[:3] + mean[:3]
        if stretch_by:
            if stretch_by == "auto":
                out = out - np.min(out)
                out = out / max(np.max(out), 1e-12)
            else:
                out = out / stretch_by + 1 / 2.0 / stretch_by
        return np.clip(out * 255, 0, 255).astype(np.uint8)

    single_channel = "chan1" in transforms or img.shape[-1] == 1
    if single_channel:
        img = np.concatenate(
            (img, np.zeros_like(img), np.zeros_like(img)), axis=-1)
        mean = np.array([mean[0], 0, 0], np.float32)
        std = np.array([std[0], 1, 1], np.float32)

    out = img[..., :3] * std[:3] + mean[:3]
    if colorspace == "lab":
        out[..., 0] = np.clip(out[..., 0], 0, 100)
        out[..., 1:] = np.clip(out[..., 1:], -127, 127)
        convert = cs.lab_to_rgb
    elif colorspace == "luv":
        out[..., 0] = np.clip(out[..., 0], 0, 100)
        out[..., 1] = np.clip(out[..., 1], -134, 220)
        out[..., 2] = np.clip(out[..., 2], -140, 122)
        convert = cs.luv_to_rgb_cv2
    else:  # lsh -> hls
        tmp = np.copy(out[..., 2])
        out[..., 2] = np.clip(out[..., 1], 0, 1)
        out[..., 1] = np.clip(out[..., 0], 0, 1)
        out[..., 0] = np.clip(tmp, 0, 360)
        convert = cs.hls_to_rgb

    rgb = convert(torch.from_numpy(
        np.ascontiguousarray(out, np.float32))).numpy()
    if single_channel:
        rgb = np.mean(rgb, axis=2)
    return (rgb * 255).astype(np.uint8)


def get_image(imgs, mean_std, colortransforms, stretch_by=False):
    """[input, output] HWC arrays -> displayable uint8 RGB of the output."""
    imgs = [np.asarray(x) for x in imgs]
    if "chan42" in colortransforms:
        imgs = [imgs[0][..., 0:3],
                np.concatenate((imgs[0][..., 3:], imgs[1]), axis=-1)]
    elif "add_meanstd" in colortransforms:
        imgs = [imgs[0][..., :1], imgs[1][..., :1]]
    return _tensor_to_image(imgs[1], mean_std, colortransforms, stretch_by)


def makegrid(imgs, size, mean_std, colortransforms):
    """A comparison grid of [input, gnd, output] thumbnails (at most
    ``size`` on a side each) as a uint8 RGB array: input and ground truth on
    the first row, the output under the ground truth (JAX ``makegrid``)."""
    from PIL import Image

    imgs = [np.asarray(x) for x in imgs]
    if len(imgs) == 3:
        rows = [[imgs[0][..., 0:3], imgs[1][..., 0:3]],
                [None, imgs[2][..., 0:3]]]
    elif len(imgs) == 2:
        rows = [[imgs[0][..., 0:3], imgs[1][..., 0:3]]]
    else:
        rows = [[imgs[0][..., 0:3]]]

    acc = []
    for row in rows:
        acci = []
        for img in row:
            if img is not None:
                arr = _tensor_to_image(img, mean_std, colortransforms)
            else:
                arr = np.zeros(rows[-1][-1].shape[:2] + (3,), np.uint8)
            pimg = Image.fromarray(arr)
            pimg.thumbnail((size, size))
            acci.append(np.array(pimg))
        acc.append(np.concatenate(acci, axis=1))
    return np.concatenate(acc, axis=0)
