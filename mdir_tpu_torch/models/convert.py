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


def _module_name(path, regional=False):
    """flax module path (tuple of names) -> the port's dotted module name."""
    head, rest = path[0], list(path[1:])
    if regional and head in _RPOOL:
        return ".".join([_RPOOL[head]] + rest)
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


def from_jax_variables(variables_np):
    """flax variables of a model (numpy leaves) -> port state dict."""
    state = OrderedDict()
    params = variables_np.get("params", {})
    regional = "pool_whiten" in params
    for path, value in _leaves(params):
        if path == ("pool", "p"):
            state[_module_name(("pool",), regional) + ".p"] = \
                value.reshape(-1)
            continue
        layer, leaf = path[-2], path[-1]
        name = _module_name(path[:-2], regional)
        if layer == "conv" and leaf == "kernel":
            state[name + ".weight"] = np.transpose(value, (3, 2, 0, 1))
        elif layer == "dense" and leaf == "kernel":
            state[name + ".weight"] = value.T
        elif layer in ("conv", "dense") and leaf == "bias":
            state[name + ".bias"] = value
        elif layer == "bn" and leaf in ("scale", "bias"):
            state[name + (".weight" if leaf == "scale" else ".bias")] = value
        elif leaf == "kernel" and value.ndim == 4:  # ConvTranspose: no scope
            state[_module_name(path[:-1]) + ".weight"] = np.transpose(
                value, (2, 3, 0, 1))
        elif leaf == "bias" and layer not in ("conv", "dense", "bn"):
            state[_module_name(path[:-1]) + ".bias"] = value
        else:
            raise KeyError("cannot map JAX parameter %s" % "/".join(path))
    for path, value in _leaves(variables_np.get("batch_stats", {})):
        if path[-2] != "bn" or path[-1] not in ("mean", "var"):
            raise KeyError("cannot map JAX statistic %s" % "/".join(path))
        suffix = ".running_mean" if path[-1] == "mean" else ".running_var"
        state[_module_name(path[:-2]) + suffix] = value
    return OrderedDict((k, torch.from_numpy(np.array(v, np.float32)))
                       for k, v in state.items())
