"""Torch state dicts into the port's models: the caffe-pretrained trunk
features for ``pretrained: true`` and whole official cirtorch
``ImageRetrievalNet`` states -- the port's counterparts of
``mdir_tpu/models/torch_import.py``'s ``load_pretrained_features`` and
``import_model_state``.

cirtorch publishes the trunks it fine-tunes from as bare ``features`` state
dicts (``imagenet-caffe-<arch>-features-<sha256 prefix>.pth``). The port's
trunks already carry cirtorch's ``features.<idx>`` names
(``models/trunks.py``), so a file loads as it is, with a strict
``load_state_dict`` of the trunk: no conversion. The file is looked up where
``tools/utils.py::resolve_artifact`` looks, ``<data root>/networks/<basename>``,
and its hash is checked; nothing is downloaded, so a missing file raises,
naming the path to put it at.

A branched net (``models/branched.py``) with ``pretrained: true`` takes its
convs from a plain ``cirnet`` of its architecture loaded the same way
(``init_branched_from_pretrained``, JAX ``branched.py:152-248``).

An official checkpoint's ``state_dict`` (``features.*``, ``pool.p``, a
regional net's ``pool.rpool.p`` and ``pool.whiten.weight/bias``,
``whiten.weight/bias``, ``lwhiten.weight/bias``) carries the names of the
port's ``ImageRetrievalNet`` as well: ``import_model_state`` drops
BatchNorm's ``num_batches_tracked`` counters and loads the rest with a
strict ``load_state_dict``, so a key it cannot place raises.
"""
import numpy as np
import torch

from ..tools.utils import resolve_artifact

# Caffe-pretrained trunk features (cirtorch imageretrievalnet.py:17-22)
FEATURES_URLS = {
    "vgg16": "http://cmp.felk.cvut.cz/cnnimageretrieval/data/networks/imagenet/imagenet-caffe-vgg16-features-d369c8e.pth",
    "resnet50": "http://cmp.felk.cvut.cz/cnnimageretrieval/data/networks/imagenet/imagenet-caffe-resnet50-features-ac468af.pth",
    "resnet101": "http://cmp.felk.cvut.cz/cnnimageretrieval/data/networks/imagenet/imagenet-caffe-resnet101-features-10a101d.pth",
    "resnet152": "http://cmp.felk.cvut.cz/cnnimageretrieval/data/networks/imagenet/imagenet-caffe-resnet152-features-1011020.pth",
}


def load_pretrained_features(model, architecture):
    """Fill ``model.features`` from the architecture's caffe features file.

    An architecture without one (AlexNet, the densenets and squeezenets
    among them) keeps its weights, as in the JAX package, whose reference
    would take torchvision's weights, which need a download. BatchNorm's
    ``num_batches_tracked`` counters are dropped: frozen BatchNorm has
    none.
    """
    if architecture not in FEATURES_URLS:
        return model
    path = resolve_artifact(FEATURES_URLS[architecture])
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {key: value for key, value in state.items()
             if not key.endswith("num_batches_tracked")}
    with torch.no_grad():
        model.features.load_state_dict(state, strict=True)
    return model


def import_model_state(model, state_dict):
    """Load a torch state dict in cirtorch names (an official
    ``ImageRetrievalNet``'s, a U-Net's) into ``model``; strict, so a key
    the model lacks, or a weight it has and the dict does not, raises."""
    state = {key: value if torch.is_tensor(value)
             else torch.as_tensor(np.asarray(value))
             for key, value in state_dict.items()
             if not key.endswith("num_batches_tracked")}
    with torch.no_grad():
        model.load_state_dict(state, strict=True)
    return model


def _pretrained_features(architecture):
    """The trunk of a plain ``cirnet`` with ``pretrained: true`` (JAX
    ``_load_base_params``), as a state dict of numpy arrays; an
    architecture without a features file keeps its seeded weights."""
    from . import initialize_model

    base = initialize_model({
        "architecture": "cirnet", "cir_architecture": architecture,
        "local_whitening": False, "pooling": "gem", "regional": False,
        "whitening": False, "pretrained": True}, device="cpu")
    return {key: value.numpy() for key, value
            in base.features.state_dict().items()}


def _adapt_first_conv(weight, init, in_channels):
    """(out, 3, kh, kw) -> a branch's first conv: ``clone`` keeps it (3
    channels), ``sum`` adds over the input axis (1 channel)."""
    if (init, in_channels) not in (("clone", 3), ("sum", 1)):
        raise ValueError("a pretrained branch takes clone with 3 channels "
                         "or sum with 1, not %s with %d" % (init,
                                                            in_channels))
    if init == "clone":
        return weight
    return weight.sum(axis=1, keepdims=True)


def init_branched_from_pretrained(model, architecture, items, merge):
    """Set a branched net's convs from the caffe features (JAX
    ``_init_branches_from_pretrained`` and ``_build_input_merged``): each
    branch's pre-split convs, its first adapted by ``clone`` or ``sum``;
    the post convs, the first tiled over the branches under ``concat``; at
    ``merge.layer`` 0 the one trunk, its first conv the branches' adapted
    copies scaled by their weights and concatenated on the input axis."""
    from .branched import split_spec_at_conv, trunk_spec

    base = _pretrained_features(architecture)
    spec = trunk_spec(architecture)
    state = {}
    if merge["layer"] == 0:
        first = next(str(item[1]) for item in spec if item[0] == "conv")
        for key, value in base.items():
            state["features." + key] = value
        state["features.%s.weight" % first] = np.concatenate(
            [weight * _adapt_first_conv(base[first + ".weight"], init, c)
             for _, c, weight, init in items], axis=1)
    else:
        pre, post = split_spec_at_conv(spec, merge["layer"])
        pre_convs = [str(item[1]) for item in pre if item[0] == "conv"]
        post_convs = [str(item[1]) for item in post if item[0] == "conv"]
        for name, c, _weight, init in items:
            for i, idx in enumerate(pre_convs):
                weight = base[idx + ".weight"]
                if i == 0:
                    weight = _adapt_first_conv(weight, init, c)
                state["branches.%s.%s.weight" % (name, idx)] = weight
                state["branches.%s.%s.bias" % (name, idx)] = \
                    base[idx + ".bias"]
        for i, idx in enumerate(post_convs):
            weight = base[idx + ".weight"]
            if i == 0 and merge["aggregation"] == "concat":
                weight = np.tile(weight, (1, len(items), 1, 1))
            state["features.%s.weight" % idx] = weight
            state["features.%s.bias" % idx] = base[idx + ".bias"]
    with torch.no_grad():
        for key, value in state.items():
            model.get_parameter(key).copy_(torch.from_numpy(
                np.ascontiguousarray(value)))
    return model
