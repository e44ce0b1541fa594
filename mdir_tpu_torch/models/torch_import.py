"""Caffe-pretrained trunk features for ``pretrained: true``: the port's
counterpart of ``mdir_tpu/models/torch_import.py::load_pretrained_features``.

cirtorch publishes the trunks it fine-tunes from as bare ``features`` state
dicts (``imagenet-caffe-<arch>-features-<sha256 prefix>.pth``). The port's
trunks already carry cirtorch's ``features.<idx>`` names
(``models/trunks.py``), so a file loads as it is, with a strict
``load_state_dict`` of the trunk: no conversion. The file is looked up where
``tools/utils.py::resolve_artifact`` looks, ``<data root>/networks/<basename>``,
and its hash is checked; nothing is downloaded, so a missing file raises,
naming the path to put it at.
"""
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

    An architecture without one (AlexNet among them) keeps its weights, as
    in the JAX package, whose reference would take torchvision's weights,
    which need a download. BatchNorm's ``num_batches_tracked`` counters are
    dropped: frozen BatchNorm has none.
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
