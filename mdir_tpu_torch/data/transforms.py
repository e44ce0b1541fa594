"""Host transforms of the eval path and their pipe DSL, as
``mdir_tpu/data/transforms.py`` has them. Images stay HWC numpy arrays on
the host.

The photometric transforms (``apply_clahe``, ``add_clahe_fromrgb``,
``tospace``) parse their parameters as the JAX package does, but run only
as the device chain (``ops/preprocess.py``), which the extractor builds from
them: the port has no cv2, so their host ``__call__`` raises.
"""
import numpy as np


class GenericTransform:
    def __init__(self, params=None):
        self.params = params or {}

    def __repr__(self):
        return self.__class__.__name__ + "(%s)" % ", ".join(
            "%s=%s" % (k, v) for k, v in self.params.items())


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
    """PIL -> RGB HWC float32 in [0, 1]."""

    def __call__(self, *pics):
        return [np.array(x.convert("RGB"), dtype=np.float32) / 255.0
                for x in pics]


class _DeviceChainOnly(GenericTransform):
    """A photometric transform that runs only inside the device chain."""

    def __call__(self, *pics):
        raise NotImplementedError(
            "%s runs on the device chain (ops/preprocess.py, through the "
            "extractor); the port has no host colorspace path" % self)


class ToColorspace(_DeviceChainOnly):
    def __init__(self, colorspace):
        super().__init__({"colorspace": colorspace})


class AddClaheFromRgb(_DeviceChainOnly):
    """Append the image's CLAHE-normalized lightness as a new channel."""

    def __init__(self, clip_limit=4, grid_size=8, colorspace="lab"):
        super().__init__({"clip_limit": int(clip_limit),
                          "grid_size": grid_size, "colorspace": colorspace})


class ApplyClahe(_DeviceChainOnly):
    """CLAHE the lightness channel in place in a colorspace."""

    def __init__(self, clip_limit=4, colorspace="lab", grid_size=8):
        super().__init__({"clip_limit": clip_limit, "colorspace": colorspace,
                          "grid_size": grid_size})


TRANSFORMS = {
    "totensor": ToTensor,
    "normalize": Normalize,
    "pil2np": Pil2Numpy,
    "tospace": ToColorspace,
    "add_clahe_fromrgb": AddClaheFromRgb,
    "apply_clahe": ApplyClahe,
}


def initialize_transforms(augmentations, mean_std):
    """Parse the pipe DSL; ``name:arg1:arg2`` per item; ``normalize`` gets
    mean_std injected."""
    trans = []
    for aug in [x.strip() for x in (augmentations or "").split("|")
                if x.strip()]:
        tname, *args = aug.split(":", 1)
        args = args[0].split(":") if args else []
        if tname not in TRANSFORMS:
            raise NotImplementedError("transform %r is not ported yet" % tname)
        if "normalize" in aug:
            trans.append(TRANSFORMS[tname](*(list(mean_std) + args)))
        else:
            trans.append(TRANSFORMS[tname](*args))
    return Compose(trans)
