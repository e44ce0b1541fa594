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
