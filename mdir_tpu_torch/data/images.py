"""Image loading: decode, bounding-box crop, max-side resize (cirtorch
``ImagesFromList``, JAX ``data/datasets.py``). PIL is imported inside the
functions that decode, so importing this module needs no PIL.

A loader maps a path to a PIL image or an (H, W, 3) uint8 array, or returns
the exception that stopped it, as ``pil_loader`` returns the ``OSError`` of
a missing or unreadable file. ``ImagesFromList`` raises that exception,
unless it was built with ``ignore_errors``: then the image is missing, and
``__getitem__`` gives the reference's ``{}`` sentinel.
"""
import sys

import numpy as np

from ..ops.resize import max_side_resize_pil


def pil_loader(path):
    """Decode an image file to RGB (truncated files tolerated); returns the
    ``OSError`` when the file cannot be read."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        with open(path, "rb") as handle:
            return Image.open(handle).convert("RGB")
    except OSError as exc:
        return exc


def imresize(img, imsize):
    """Longer side down to ``imsize`` (PIL thumbnail); never enlarges."""
    if hasattr(img, "thumbnail"):
        return max_side_resize_pil(img, imsize)
    if max(img.shape[:2]) > imsize:
        raise NotImplementedError(
            "an array of shape %s is larger than image_size %d: shrinking "
            "it needs PIL; load it as a PIL image or at its final size"
            % (img.shape, imsize))
    return img


def crop(img, bbx):
    """PIL ``crop`` of a PIL image or an array: the box (x0, y0, x1, y1)
    rounded; an array's box must lie inside it."""
    if hasattr(img, "crop"):
        return img.crop(bbx)
    x0, y0, x1, y1 = (int(round(v)) for v in bbx)
    if not (0 <= x0 <= x1 <= img.shape[1] and 0 <= y0 <= y1 <= img.shape[0]):
        raise ValueError("box %s is not inside an array of shape %s"
                         % (bbx, img.shape))
    return img[y0:y1, x0:x1]


def as_uint8(img):
    """A loaded image as (H, W, 3) uint8 pixels."""
    if hasattr(img, "convert"):
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError("a loader must give RGB images or (H, W, 3) uint8 "
                         "arrays, not %s %s" % (img.dtype, img.shape))
    return img


class ImagesFromList:
    """Image paths -> loaded, cropped, resized (and transformed) images."""

    def __init__(self, images, imsize=None, bbxs=None, transform=None,
                 loader=pil_loader, ignore_errors=False):
        if len(images) == 0:
            raise RuntimeError("Dataset contains 0 images!")
        self.images = images
        self.imsize = imsize
        self.bbxs = bbxs
        self.transform = transform
        self.loader = loader
        self.ignore_errors = ignore_errors

    def __len__(self):
        return len(self.images)

    def image(self, index):
        """The decoded, cropped and resized image; None for a missing image
        under ``ignore_errors``."""
        img = self.loader(self.images[index])
        if isinstance(img, Exception):
            sys.stderr.write("Warning: Image '%s' was not found\n"
                             % self.images[index])
            if self.ignore_errors:
                return None
            raise img
        if self.bbxs is not None and self.bbxs[index]:
            img = crop(img, self.bbxs[index])
        if self.imsize is not None:
            img = imresize(img, self.imsize)
        return img

    def uint8(self, index):
        """The image as (H, W, 3) uint8 pixels; None when missing."""
        img = self.image(index)
        return None if img is None else as_uint8(img)

    def __getitem__(self, index):
        img = self.image(index)
        if img is None:
            return {}
        return img if self.transform is None else self.transform(img)
