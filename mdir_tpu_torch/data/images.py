"""Image loading of the eval path: decode, bounding-box crop, max-side
resize (cirtorch ``ImagesFromList``). PIL is imported inside the functions
that decode, so importing this module needs no PIL.
"""
import numpy as np

from ..ops.resize import max_side_resize_pil


def pil_loader(path):
    """Decode an image file to RGB (truncated files tolerated)."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with open(path, "rb") as handle:
        return Image.open(handle).convert("RGB")


class ImagesFromList:
    """Image paths -> loaded, cropped, resized (and transformed) images."""

    def __init__(self, images, imsize=None, bbxs=None, transform=None):
        if len(images) == 0:
            raise RuntimeError("Dataset contains 0 images!")
        self.images = images
        self.imsize = imsize
        self.bbxs = bbxs
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def image(self, index):
        """The decoded, cropped and resized PIL image."""
        img = pil_loader(self.images[index])
        if self.bbxs is not None and self.bbxs[index]:
            img = img.crop(self.bbxs[index])
        if self.imsize is not None:
            img = max_side_resize_pil(img, self.imsize)
        return img

    def uint8(self, index):
        """The image as (H, W, 3) uint8 pixels."""
        return np.asarray(self.image(index).convert("RGB"), dtype=np.uint8)

    def __getitem__(self, index):
        img = self.image(index)
        return img if self.transform is None else self.transform(img)
