"""The infer stage's outputs: a descriptor matrix, or translated images saved
as RGB files -- ``mdir_tpu/data/outputs.py`` (reference
``mdir/components/data/output.py``) on the port.

An output's lifecycle is ``preprocess`` (returns the data left to process;
with ``append`` the images whose file exists are left out), ``add`` per
result, and ``postprocess`` (returns the stage's outputs). Descriptor rows
are collected by index and put together at ``postprocess``; a missing image
(``add(i, None, None)``) is a NaN row. ``async: true`` is accepted: the JAX
package then writes behind a thread pool, in order; the port writes each
result in ``add``, on the calling thread (it starts no thread), in the same
order and to the same files. PIL is imported where a PNG is written.
"""
import abc
import os

import numpy as np

from ..tools.utils import path_join


class DataOutput(abc.ABC):
    @abc.abstractmethod
    def preprocess(self):
        """Open the output; returns the remaining data to process."""

    @abc.abstractmethod
    def add(self, index, input_data, output_data):
        """Add a single result."""

    @abc.abstractmethod
    def postprocess(self):
        """Finalize; returns output data tuple."""


def _flat_name(item):
    """Join an image tuple into one path-safe file name."""
    stems = [piece.rsplit(".", 1)[0] for piece in item[:-1]]
    return "::".join(stems + [item[-1]]).replace("/", "%")


def _plan_targets(items, image_dir, dir_structure):
    """Map each data item to its destination path."""
    if dir_structure == "flat":
        names = [_flat_name(item) for item in items]
    else:
        names = [item[0] for item in items]
    return names, [path_join(image_dir, name) for name in names]


class RgbImageSaver(DataOutput):
    """Save translated images (e.g. U-Net outputs) as RGB files.

    ``add`` takes the network's float output, (1, H, W, C) or (H, W, C), and
    converts it with ``tools.imgtools.get_image`` (denormalise, clip, uint8).
    Nothing in the port hands it converted pixels, so an output that is not
    floating point raises rather than being taken as already converted.
    """

    def __init__(self, data, data_params, *, image_dir, dir_structure=None,
                 append=False, stretch_by=False):
        if len(data) != 1:
            raise ValueError("the rgb output takes one column of images")
        self.items = [x if isinstance(x, (list, tuple)) else [x]
                      for x in data[0]]
        self.unnormalize = {key: data_params[key]
                            for key in ("mean_std", "transforms")}
        self.image_dir = image_dir
        self.dir_structure = dir_structure or (
            "flat" if len(self.items[0]) > 1 else "input")
        self.append, self.stretch_by = append, stretch_by
        self.fnames, self.paths = None, None

    def preprocess(self):
        self.fnames, paths = _plan_targets(self.items, self.image_dir,
                                           self.dir_structure)
        remaining = [item[0] for item in self.items]
        if self.append:
            todo = [i for i, path in enumerate(paths)
                    if not os.path.exists(path)]
            remaining = [remaining[i] for i in todo]
            paths = [paths[i] for i in todo]
        self.paths = paths
        return (remaining,)

    def add(self, index, input_data, output_data):
        from PIL import Image

        from ..tools import imgtools

        out = np.asarray(output_data[0])
        if not np.issubdtype(out.dtype, np.floating):
            raise TypeError("the rgb output converts float network outputs, "
                            "not %s" % out.dtype)
        img = imgtools.get_image(
            (np.asarray(input_data[0]), out),
            self.unnormalize["mean_std"], self.unnormalize["transforms"],
            stretch_by=self.stretch_by)
        target = self.paths[index]
        os.makedirs(os.path.dirname(target), exist_ok=True)
        Image.fromarray(img).save(target)

    def postprocess(self):
        return (self.fnames,)


class EmbeddingOutput(DataOutput):
    """Accumulate a descriptor matrix; NaN rows mark missing images."""

    def __init__(self, data, _data_params, *, bbxs=False):
        if bbxs:
            self.images, self.bbxs = data
        else:
            if len(data) != 1:
                raise ValueError("the embedding output takes one column of "
                                 "images, or images and bbxs with bbxs: true")
            self.images, self.bbxs = data[0], None
        self.rows = {}  # index -> descriptor; None marks a missing image

    def preprocess(self):
        return self.images, self.bbxs

    def add(self, index, input_data, output_data):
        missing = input_data is None and output_data is None
        self.rows[index] = None if missing else np.asarray(
            output_data).reshape(-1)

    def _materialize(self):
        dim = next((row.shape[0] for row in self.rows.values()
                    if row is not None), None)
        if dim is None:
            return []
        vecs = np.zeros((len(self.images), dim))
        for index, row in self.rows.items():
            vecs[index, :] = np.nan if row is None else row
        return vecs

    def postprocess(self):
        return self.images, self._materialize()


OUTPUT_LABELS = {"embedding": EmbeddingOutput, "rgb": RgbImageSaver}


def initialize_output(output, data_params, data):
    """The output of a scenario's ``output: inference`` section; with
    ``async: true`` too, it writes synchronously."""
    output.pop("async", None)
    return OUTPUT_LABELS[output.pop("name")](data, data_params, **output)
