"""Host transforms and their pipe DSL, as ``mdir_tpu/data/transforms.py``
has them. Images stay HWC float32 numpy arrays between transforms.

The JAX package's host transforms call cv2 for their colorspaces. The port
has no cv2: ``rgb2normspace_np`` and ``normspace2rgb_np`` compute in torch
(``ops/colorspace.py``) on the transform's device. An image that is exactly
u8 / 255, as ``pil2np`` makes it, takes the exact planes of the device chain:
lab from the ``lab_n`` lattice (cv2's float Lab of u8 / 255, bit for bit),
lsh through float HLS (its L cut to uint8 is ``(max + min) >> 1``), luv on the
analytic sRGB curve cv2's float Luv uses (its L plane that of
``rgb_u8_to_luv_l``). Any other float image takes the float conversions,
which agree with cv2's within ``tests/test_colorspace.py``'s bars (luv's on
the analytic curve, as cv2's). The way back is float in every space, luv's
with cv2's clamp of v' (``luv_to_rgb_cv2``). The host CLAHE transforms run
``ops/clahe.py::clahe_u8``, the two CLAHE kernels at batch 1, on the same
device; the histogram transforms run ``ops/histogram.py``'s numpy functions
on the host.

A transform that computes on a device takes it from ``on_device(compose,
device)``, which the extractor, the translator, the infer stage and the
training epoch call with their network's device; it is the card
(``"cuda"``) until then, and raises without one.

The augmentations (``random_crop``, ``mirror``, ``center_crop``,
``downscale``, ``scalecrop``, ``gaussian_noise``) take ``*pics`` and apply
one draw to every image of a tuple. They draw from Python's ``random`` and
numpy's global generator in the JAX package's order, so under the same
seeds (the training epoch reseeds both with ``seed + epoch``) they crop,
flip and add noise as the JAX package does, bit for bit. ``downscale``
resizes as PIL's ``BILINEAR`` and ``scalecrop`` as ``cv2.resize``'s
``INTER_LINEAR``, both without PIL or cv2 (``ops/resize.py``).

The one label that raises (``NOT_PORTED``) is ``add_edgesdollar_fromrgb``:
it needs ``cv2.ximgproc`` and a model file that is not in the repository.
"""
import random

import numpy as np
import torch

from ..device import resolve_device
from ..ops import clahe as clahe_ops
from ..ops import colorspace as cs
from ..ops import histogram as hist_ops
from ..ops import lab_trilinear, preprocess
from ..ops.resize import cv2_linear_f32, pil_bilinear_u8
from ..tools.utils import parse_tuple


def exact_u8(img):
    """The (H, W, 3) uint8 pixels of an RGB float image that is exactly
    u8 / 255 in float32, else None."""
    rgb = np.asarray(img)[..., :3]
    if rgb.dtype != np.float32:
        return None
    u8 = np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)
    if not np.array_equal(u8.astype(np.float32) / np.float32(255.0), rgb):
        return None
    return u8


def _normspace(img, colorspace, device):
    """An HWC image's normalized colorspace as a float32 tensor on
    ``device``: the exact planes for u8 / 255 input, else the float ones."""
    space = colorspace.lower()
    if space not in cs.NORMSPACES:
        raise cs._unsupported(colorspace)
    u8 = exact_u8(img)
    if u8 is None:
        rgb = np.ascontiguousarray(np.asarray(img)[..., :3], np.float32)
        return cs.rgb2normspace(torch.from_numpy(rgb).to(device), space,
                                cv2_luv=True)
    u8 = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    if space == "lab":
        return lab_trilinear.lab_normspace(u8[None])[0]
    if space == "luv":
        return cs.rgb_u8_to_luv_analytic(u8)
    return cs.rgb2normspace(u8.to(torch.float32) / 255.0, space)


@torch.no_grad()
def rgb2normspace_np(img, colorspace, device="cuda"):
    """RGB HWC float32 -> the reference's normalized colorspace, numpy."""
    return _normspace(img, colorspace, resolve_device(device)).cpu().numpy()


@torch.no_grad()
def normspace2rgb_np(img, colorspace, device="cuda"):
    """The reference's normalized colorspace -> RGB HWC float32, numpy."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return cs.normspace2rgb(x.to(resolve_device(device)), colorspace,
                            cv2_luv=True).cpu().numpy()


def _clahe_chan(spc, clip_limit, grid):
    """CLAHE of channel 0 of a normalized-space tensor: the host's
    ``(chan * 255).astype(uint8)`` plane through ``clahe_u8``, / 255."""
    plane = preprocess.quantize(spc[..., 0]).to(torch.uint8).contiguous()
    out = clahe_ops.clahe_u8(plane, float(int(clip_limit)), grid)
    return out.to(torch.float32) / 255.0


@torch.no_grad()
def apply_image_clahe(img, clip_limit, grid_size, colorspace, device="cuda"):
    """CLAHE on the lightness channel in a colorspace (ImageClahe.apply)."""
    grid = (int(grid_size), int(grid_size)) \
        if not isinstance(grid_size, tuple) else grid_size
    spc = _normspace(img, colorspace, resolve_device(device))
    chan = _clahe_chan(spc, clip_limit, grid)
    spc = torch.cat([chan[..., None], spc[..., 1:]], dim=-1)
    return cs.normspace2rgb(spc, colorspace, cv2_luv=True).cpu().numpy()


class GenericTransform:
    def __init__(self, params=None):
        self.params = params or {}

    def __repr__(self):
        return self.__class__.__name__ + "(%s)" % ", ".join(
            "%s=%s" % (k, v) for k, v in self.params.items())


class DeviceTransform(GenericTransform):
    """A host transform that computes in torch on ``device``."""

    device = "cuda"


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *pics):
        for t in self.transforms:
            pics = t(*pics)
        if len(pics) == 1:
            return pics[0]
        return pics

    def __repr__(self):
        return "Compose([%s])" % ", ".join(repr(t) for t in self.transforms)


def on_device(transform, device):
    """Point the device transforms of a Compose at ``device``; returns it."""
    for t in getattr(transform, "transforms", None) or ():
        if isinstance(t, DeviceTransform):
            t.device = device
    return transform


#
# Core
#

class ToTensor(GenericTransform):
    """PIL -> HWC float32 in [0, 1]; float numpy passes through."""

    def __call__(self, *pics):
        acc = []
        for pic in pics:
            if isinstance(pic, np.ndarray):
                acc.append(np.ascontiguousarray(pic, dtype=np.float32))
            else:  # PIL image
                arr = np.asarray(pic, dtype=np.float32) / 255.0
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                acc.append(arr)
        return acc


class Normalize(GenericTransform):
    """(x - mean) / std over the channel (last) axis; strict or loose count."""

    def __init__(self, mean, std, strict_shape=True):
        if isinstance(strict_shape, str):
            strict_shape = strict_shape.lower() != "false"
        super().__init__({"mean": mean, "std": std,
                          "strict_shape": bool(strict_shape)})
        assert len(mean) == len(std)

    def __call__(self, *pics):
        mean = np.asarray(self.params["mean"], np.float32)
        std = np.asarray(self.params["std"], np.float32)
        acc = []
        for pic in pics:
            c = pic.shape[-1]
            if self.params["strict_shape"]:
                assert c == len(mean), (c, len(mean))
                acc.append((pic - mean) / std)
            else:
                assert c <= len(mean), (c, len(mean))
                acc.append((pic - mean[:c]) / std[:c])
        return acc


class Pil2Numpy(GenericTransform):
    """PIL image or (H, W, 3) uint8 array -> RGB HWC float32 in [0, 1]."""

    def __call__(self, *pics):
        return [np.array(x.convert("RGB") if hasattr(x, "convert") else x,
                         dtype=np.float32) / 255.0 for x in pics]


class StackBatch(GenericTransform):
    """Concatenate images along channels (the reference stacks CHW along
    axis 0; channels-last here)."""

    def __call__(self, *pics):
        return [np.concatenate(pics, axis=-1)]


class NanCheck(GenericTransform):
    def __call__(self, *pics):
        for pic in pics:
            if np.isnan(pic).any():
                raise ValueError("Nan value occured in input")
        return pics


#
# Augmentations
#

class RandomCrop(GenericTransform):
    def __init__(self, size):
        super().__init__({"size": parse_tuple(size, int)})

    def __call__(self, *pics):
        th, tw = self.params["size"] if len(self.params["size"]) == 2 \
            else self.params["size"] * 2
        h, w = pics[0].shape[:2]
        i = random.randint(0, h - th)
        j = random.randint(0, w - tw)
        return [x[i:i + th, j:j + tw] for x in pics]


class RandomHorizontalFlip(GenericTransform):
    def __init__(self, p=0.5):
        super().__init__({"p": float(p)})

    def __call__(self, *pics):
        if random.random() < self.params["p"]:
            return [np.flip(x, axis=1) for x in pics]
        return pics


class CenterCrop(GenericTransform):
    def __init__(self, size):
        super().__init__({"size": np.array(parse_tuple(size, int))[::-1]})

    def __call__(self, *pics):
        acc = []
        for pic in pics:
            pad = (np.array(pic.shape[:2]) - self.params["size"]) / 2
            y0, y1 = int(np.floor(pad[0])), -int(np.ceil(pad[0])) or None
            x0, x1 = int(np.floor(pad[1])), -int(np.ceil(pad[1])) or None
            acc.append(pic[y0:y1, x0:x1])
        return acc


class Downscale(GenericTransform):
    """Smaller side down to ``size`` when the image (or its channel count)
    exceeds it: PIL's BILINEAR resize of ``(pic * 255).astype(uint8)``, a
    truncation as in the JAX package, then / 255."""

    def __init__(self, size):
        super().__init__({"size": int(size)})

    def __call__(self, *pics):
        size = self.params["size"]
        acc = []
        for pic in pics:
            if max(pic.shape) > size:
                h, w = pic.shape[:2]
                if w < h:
                    new = (size, int(size * h / w))
                else:
                    new = (int(size * w / h), size)
                pic = pil_bilinear_u8((pic * 255).astype(np.uint8), new) \
                    .astype(np.float32) / 255.0
            acc.append(pic)
        return acc


class RandomScaleCrop(GenericTransform):
    """Random scale (bounds) + random crop, crop then resize (cv2's
    INTER_LINEAR on float32) to ``size`` (width_height)."""

    def __init__(self, size, scale=(0.5, 0.8)):
        super().__init__({"size": np.array(parse_tuple(size, int)),
                          "scale": parse_tuple(scale, float)})

    def __call__(self, *pics):
        if len(pics) == 1 or pics[0].shape[:2] == pics[1].shape[:2]:
            if (pics[0].shape[:2] == self.params["size"][::-1]).all():
                return pics

        lo, hi = self.params["scale"]
        scale = random.random() * (hi - lo) + lo
        cropped_size = np.ceil(self.params["size"][::-1] / scale).astype(int)
        assert (np.array(pics[0].shape[:2]) >= cropped_size).all()
        offs = [random.randint(0, x)
                for x in (np.array(pics[0].shape[:2]) - cropped_size)]
        ys, ye = offs[0], offs[0] + cropped_size[0]
        xs, xe = offs[1], offs[1] + cropped_size[1]
        return [cv2_linear_f32(pic[ys:ye, xs:xe], tuple(self.params["size"]))
                for pic in pics]


class AdditiveGaussianNoise(GenericTransform):
    """Gaussian noise on the first image only, clipped to [0, 1]."""

    def __init__(self, sigma):
        super().__init__({"sigma": float(sigma)})

    def __call__(self, *pics):
        pics = list(pics)
        noise = np.random.normal(0, self.params["sigma"], pics[0].shape)
        pics[0] = np.clip(pics[0] + noise, 0, 1).astype(np.float32)
        return pics


#
# Channel transforms
#

def _chan_end(end):
    if end != "unset":
        end = int(end) if end and end != "null" else None
    return end


class AddConstantChannel(GenericTransform):
    def __init__(self, value):
        super().__init__({"value": float(value)})

    def __call__(self, *pics):
        return [np.concatenate(
            (x, np.full(x.shape[:-1] + (1,), self.params["value"],
                        np.float32)), axis=2) for x in pics]


class NpInvertChannel(GenericTransform):
    def __init__(self, channel):
        super().__init__({"channel": int(channel)})

    def __call__(self, *pics):
        for pic in pics:
            c = self.params["channel"]
            pic[:, :, c] = 1 - pic[:, :, c]
        return pics


class NpChanSelector(GenericTransform):
    def __init__(self, start, end="unset"):
        super().__init__({"start": int(start), "end": _chan_end(end)})

    def __call__(self, *pics):
        s, e = self.params["start"], self.params["end"]
        if e == "unset":
            return [x[:, :, s:s + 1] for x in pics]
        return [x[:, :, s:e] for x in pics]


class NpCloneChannels(GenericTransform):
    def __init__(self, start, end="unset"):
        super().__init__({"start": int(start), "end": _chan_end(end)})

    def __call__(self, *pics):
        s, e = self.params["start"], self.params["end"]
        if e == "unset":
            return [np.concatenate((x, x[:, :, s:s + 1]), axis=2)
                    for x in pics]
        return [np.concatenate((x, x[:, :, s:e]), axis=2) for x in pics]


class AddIntensityFromRgb(DeviceTransform):
    def __init__(self, colorspace="lab"):
        super().__init__({"colorspace": colorspace})

    def __call__(self, *pics):
        acc = []
        for pic in pics:
            spc = rgb2normspace_np(pic[:, :, :3], self.params["colorspace"],
                                   self.device)
            acc.append(np.concatenate((pic, spc[:, :, :1]), axis=2))
        return acc


class ToColorspace(DeviceTransform):
    def __init__(self, colorspace):
        super().__init__({"colorspace": colorspace})

    def __call__(self, *pics):
        return [rgb2normspace_np(pic[:, :, :3], self.params["colorspace"],
                                 self.device) for pic in pics]


#
# Photometric (the paper's)
#

class AddClaheFromRgb(DeviceTransform):
    """Append the image's CLAHE-normalized lightness as a new channel."""

    def __init__(self, clip_limit=4, grid_size=8, colorspace="lab"):
        super().__init__({"clip_limit": int(clip_limit),
                          "grid_size": grid_size, "colorspace": colorspace})

    @torch.no_grad()
    def __call__(self, *pics):
        grid = (int(self.params["grid_size"]),) * 2
        device = resolve_device(self.device)
        acc = []
        for pic in pics:
            assert isinstance(pic, np.ndarray)
            spc = _normspace(pic[:, :, :3], self.params["colorspace"],
                             device)
            chan = _clahe_chan(spc, self.params["clip_limit"], grid)
            acc.append(np.concatenate((pic, chan.cpu().numpy()[..., None]),
                                      axis=2))
        return acc


class ApplyClahe(DeviceTransform):
    """CLAHE the lightness channel in place in a colorspace."""

    def __init__(self, clip_limit=4, colorspace="lab", grid_size=8):
        super().__init__({"clip_limit": clip_limit, "colorspace": colorspace,
                          "grid_size": grid_size})

    def __call__(self, pic):
        return [apply_image_clahe(pic, self.params["clip_limit"],
                                  self.params["grid_size"],
                                  self.params["colorspace"], self.device)]


class CreateClahedImage(ApplyClahe):
    """Emit the [original, clahe(original)] image pair."""

    def __call__(self, pic):
        return [pic, apply_image_clahe(pic[:, :, :3],
                                       self.params["clip_limit"],
                                       self.params["grid_size"],
                                       self.params["colorspace"],
                                       self.device)]


class MatchHistogram(DeviceTransform):
    def __init__(self, histogram, colorspace="lab"):
        super().__init__({"histogram": histogram, "colorspace": colorspace})

    def __call__(self, pic):
        space = self.params["colorspace"]
        spc = rgb2normspace_np(pic, space, self.device)
        spc[:, :, 0] = hist_ops.channel_histogram_matching(
            spc[:, :, 0], self.params["histogram"])
        return [normspace2rgb_np(spc, space, self.device)]


class ReplaceChannelWithHistogram(GenericTransform):
    """Histogram-matched extra channel; train: matched to the gt image's last
    channel, test: matched to a stored reference CDF."""

    def __init__(self, histogram, created_channel):
        super().__init__({"histogram": histogram,
                          "created_channel": created_channel})
        assert created_channel in {"append", "replace"}

    def __call__(self, pic0, pic1=None):
        out0 = pic0[:, :, :-1] if self.params["created_channel"] == "replace" \
            else pic0
        if pic1 is not None:
            chan = hist_ops.channel2channel_histogram_matching(
                pic0[:, :, -1], pic1[:, :, -1])
            return (np.concatenate((out0, chan[..., None]), axis=2),
                    pic1[:, :, :-1])
        chan = hist_ops.channel_histogram_matching(
            pic0[:, :, -1], self.params["histogram"])
        return (np.concatenate((out0, chan[..., None]), axis=2),)


class GammaEqualize(DeviceTransform):
    def __init__(self, target, colorspace="lab"):
        target = float(target)
        super().__init__({"target": target, "colorspace": colorspace})
        assert 0 < target < 1, target

    def __call__(self, pic):
        space = self.params["colorspace"]
        spc = rgb2normspace_np(pic, space, self.device)
        spc[:, :, 0] = hist_ops.channel_gamma_matching(
            spc[:, :, 0], self.params["target"])
        return [normspace2rgb_np(spc, space, self.device)]


TRANSFORMS = {
    "totensor": ToTensor,
    "normalize": Normalize,
    "pil2np": Pil2Numpy,
    "stackbatch": StackBatch,
    "nan_check": NanCheck,

    "random_crop": RandomCrop,
    "mirror": RandomHorizontalFlip,
    "center_crop": CenterCrop,
    "downscale": Downscale,
    "scalecrop": RandomScaleCrop,
    "gaussian_noise": AdditiveGaussianNoise,

    "add_const": AddConstantChannel,
    "tospace": ToColorspace,
    "add_intensity_fromrgb": AddIntensityFromRgb,
    "np_invert_chan": NpInvertChannel,
    "np_chanselect": NpChanSelector,
    "np_chanclone": NpCloneChannels,

    "add_clahe_fromrgb": AddClaheFromRgb,
    "apply_clahe": ApplyClahe,
    "create_clahed": CreateClahedImage,
    "match_histogram": MatchHistogram,
    "replace_histogram": ReplaceChannelWithHistogram,
    "gamma_equalize": GammaEqualize,
}

NOT_PORTED = {
    "add_edgesdollar_fromrgb": "it needs cv2.ximgproc and a structured-edge "
                               "model file that is not in the repository",
}


def initialize_transforms(augmentations, mean_std):
    """Parse the pipe DSL; ``name:arg1:arg2`` per item; ``normalize`` gets
    mean_std injected."""
    trans = []
    for aug in [x.strip() for x in (augmentations or "").split("|")
                if x.strip()]:
        tname, *args = aug.split(":", 1)
        args = args[0].split(":") if args else []
        if tname in NOT_PORTED:
            raise NotImplementedError("transform %r is not ported: %s"
                                      % (tname, NOT_PORTED[tname]))
        if tname not in TRANSFORMS:
            raise KeyError(tname)
        if "normalize" in aug:
            trans.append(TRANSFORMS[tname](*(list(mean_std) + args)))
        else:
            trans.append(TRANSFORMS[tname](*args))
    return Compose(trans)
