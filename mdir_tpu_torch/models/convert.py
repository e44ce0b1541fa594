"""Map the JAX package's model variables onto the port's ``state_dict``.

``mdir_tpu`` keeps a model's weights as a flax tree
(``{"params": ..., "batch_stats": ...}``, NHWC/HWIO). Given that tree as
numpy arrays -- from a JAX model in memory or from its msgpack checkpoint --
``from_jax_variables`` returns the port's state dict (cirtorch names, OIHW):

* conv ``<m>/conv/kernel`` (kH, kW, I, O)  -> ``<m>.weight`` (O, I, kH, kW)
* transposed conv ``<m>/kernel`` (kH, kW, I, O) -> ``<m>.weight``
  (I, O, kH, kW), with no spatial flip: the JAX layer transposes the kernel
  itself (``transpose_kernel=True``), so it computes what torch's
  ``ConvTranspose2d`` computes with the same numbers
* dense ``<m>/dense/kernel`` (I, O)        -> ``<m>.weight`` (O, I)
* ``<m>/conv|dense/bias``, ``<m>/bias``     -> ``<m>.bias``
* batchnorm ``<m>/bn/{scale,bias}``         -> ``<m>.{weight,bias}``
* ``batch_stats/<m>/bn/{mean,var}``         -> ``<m>.running_{mean,var}``
* ``pool/p``                                -> ``pool.p``
* a regional (Rpool) net's ``pool/p`` and ``pool_whiten`` -> cirtorch's
  ``pool.rpool.p`` and ``pool.whiten``
* a branched net's (``cirnet_branched``) ``branches_<name>/<idx>/conv/
  {kernel,bias}`` -> ``branches.<name>.<idx>.{weight,bias}``; its post
  stack ``features``, ``pool/p`` and ``whiten`` as above

``to_jax_variables`` reads a port state dict back into a flax tree.

ResNet module names map to cirtorch's ``features`` indices: conv1 -> 0,
bn1 -> 1, ``layer<L>_<B>`` -> ``<L+3>.<B>``, ``downsample_<i>`` ->
``downsample.<i>``. The spec-driven stacks (alexnet, vgg, densenet,
squeezenet) already carry them: ``features/<idx>/conv/{kernel,bias}`` ->
``features.<idx>.{weight,bias}``, ``features/4/denselayer1/norm1/bn`` ->
``features.4.denselayer1.norm1``, ``features/3/squeeze/conv`` ->
``features.3.squeeze``.
The U-Nets and autoencoders carry their torch names already (``outerblock``,
``nested``, the ``Sequential`` indices, ``model_<i>``).
"""
import re
from collections import OrderedDict

import numpy as np
import torch

_RESNET_STEM = {"conv1": "0", "bn1": "1"}
#: a regional net's head in cirtorch's names (the JAX package renames them
#: on import, ``mdir_tpu/models/torch_import.py:206-210``)
_RPOOL = {"pool": "pool.rpool", "pool_whiten": "pool.whiten"}
#: a branched net's branch scope (JAX ``branched.py:64``)
_BRANCH = "branches_"


def _module_name(path, regional=False):
    """flax module path (tuple of names) -> the port's dotted module name."""
    head, rest = path[0], list(path[1:])
    if regional and head in _RPOOL:
        return ".".join([_RPOOL[head]] + rest)
    if head.startswith(_BRANCH):
        return ".".join(["branches", head[len(_BRANCH):]] + rest)
    if head != "features" or not rest:
        return ".".join([head] + rest)
    if rest[0].isdigit():  # alexnet/vgg: torchvision's own index
        return ".".join(["features"] + rest)
    if rest[0] in _RESNET_STEM:
        return ".".join(["features", _RESNET_STEM[rest[0]]] + rest[1:])
    match = re.fullmatch(r"layer(\d)_(\d+)", rest[0])
    if match is None:
        raise KeyError("no port module for %s" % "/".join(path))
    names = ["features", str(int(match.group(1)) + 3), match.group(2)]
    for part in rest[1:]:
        ds = re.fullmatch(r"downsample_(\d+)", part)
        names += ["downsample", ds.group(1)] if ds else [part]
    return ".".join(names)


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _entries(variables_np):
    """(collection, flax path, port name, to port, to flax) of every leaf
    of a flax variables tree; ``to flax`` takes the port's array and the
    flax leaf it replaces."""
    params = variables_np.get("params", {})
    regional = "pool_whiten" in params
    same = (lambda v: v, lambda v, like: v)
    oihw = (lambda v: np.transpose(v, (3, 2, 0, 1)),
            lambda v, like: np.transpose(v, (2, 3, 1, 0)))
    iohw = (lambda v: np.transpose(v, (2, 3, 0, 1)),
            lambda v, like: np.transpose(v, (2, 3, 0, 1)))
    dense = (lambda v: v.T, lambda v, like: v.T)
    for path, value in _leaves(params):
        if path == ("pool", "p"):
            yield ("params", path, _module_name(("pool",), regional) + ".p",
                   lambda v: v.reshape(-1),
                   lambda v, like: v.reshape(like.shape))
            continue
        layer, leaf = path[-2], path[-1]
        name = _module_name(path[:-2], regional)
        if layer == "conv" and leaf == "kernel":
            yield ("params", path, name + ".weight") + oihw
        elif layer == "dense" and leaf == "kernel":
            yield ("params", path, name + ".weight") + dense
        elif layer in ("conv", "dense") and leaf == "bias":
            yield ("params", path, name + ".bias") + same
        elif layer == "bn" and leaf in ("scale", "bias"):
            yield ("params", path, name + (".weight" if leaf == "scale"
                                           else ".bias")) + same
        elif leaf == "kernel" and value.ndim == 4:  # ConvTranspose: no scope
            yield ("params", path,
                   _module_name(path[:-1]) + ".weight") + iohw
        elif leaf == "bias" and layer not in ("conv", "dense", "bn"):
            yield ("params", path, _module_name(path[:-1]) + ".bias") + same
        else:
            raise KeyError("cannot map JAX parameter %s" % "/".join(path))
    for path, value in _leaves(variables_np.get("batch_stats", {})):
        if path[-2] != "bn" or path[-1] not in ("mean", "var"):
            raise KeyError("cannot map JAX statistic %s" % "/".join(path))
        suffix = ".running_mean" if path[-1] == "mean" else ".running_var"
        yield ("batch_stats", path, _module_name(path[:-2]) + suffix) + same


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def from_jax_variables(variables_np):
    """flax variables of a model (numpy leaves) -> port state dict."""
    return OrderedDict(
        (name, torch.from_numpy(np.array(to_port(_leaf(
            variables_np[collection], path)), np.float32)))
        for collection, path, name, to_port, _ in _entries(variables_np))


def to_jax_variables(state, like):
    """The reverse reading: a port state dict -> flax variables shaped as
    ``like`` (a flax variables tree of the same model, numpy leaves), each
    leaf in ``like``'s dtype. Tests read a port model's weights and
    BatchNorm statistics after a step in the JAX package's names with it."""
    out = {}
    for collection, path, name, _, to_flax in _entries(like):
        old = _leaf(like[collection], path)
        node = out.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(to_flax(
            state[name].detach().cpu().numpy(), old), old.dtype)
    return out
