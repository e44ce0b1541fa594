"""Read network checkpoints: the JAX package's msgpack ``.ckpt`` files and
torch ``.pth`` pickles.

A ``.ckpt`` is flax's msgpack encoding of a nested dict whose arrays are
msgpack ext values (code 1: an array as ``(shape, dtype name, bytes)``;
code 3: a numpy scalar, encoded the same way). ``msgpack`` and
``torch.load`` are imported inside the readers, off the path that only
extracts. Nothing is downloaded: URLs raise.
"""
import os
import pickle
from pathlib import Path

import numpy as np

SUFFIX_BEST = "_best.ckpt"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray(data):
    import msgpack

    shape, dtype, buffer = msgpack.unpackb(data, raw=False)
    return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape).copy()


def _unpack_ext(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError("unsupported msgpack ext type %d in checkpoint" % code)


def load_state(path):
    """A msgpack checkpoint written by ``mdir_tpu`` -> nested dict of numpy."""
    import msgpack

    with open(path, "rb") as handle:
        blob = handle.read()
    return msgpack.unpackb(blob, ext_hook=_unpack_ext, raw=False,
                           strict_map_key=False)


def load_torch_pickle(path):
    """A torch pickle on the CPU (tensors stay tensors)."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def load_checkpoint_any(path):
    """Load a checkpoint file: ``mdir_tpu``'s msgpack or a torch pickle."""
    path = str(path)
    with open(path, "rb") as handle:
        magic = handle.read(2)
    if magic == b"PK" or path.endswith((".pth", ".pt")):
        return load_torch_pickle(path)
    try:
        return load_state(path)
    except ValueError:
        with open(path, "rb") as handle:
            return pickle.load(handle)


class Checkpoints:

    @classmethod
    def load_network(cls, directory):
        """Load a single-network state ``{"net": payload}`` from a directory
        (its best checkpoint) or a file."""
        if str(directory).startswith(("http://", "https://")):
            raise ValueError("the port does not download checkpoints; fetch "
                             "%s and pass its local path" % directory)
        path = Path(directory)
        if path.is_dir():
            best = path / ("net" + SUFFIX_BEST)
            if not best.exists() and (path / "net_best.pth").exists():
                best = path / "net_best.pth"
            return {"net": load_checkpoint_any(best)}
        return {"net": load_checkpoint_any(os.fspath(path))}
