"""Model registry: label -> model factory (``mdir_tpu/models/__init__.py``
``MODEL_LABELS``): ``identity``, the U-Net translators, the pixel-wise
autoencoders and the ``cirnet`` retrieval nets.

``initialize_model`` takes the params dict of ``mdir_tpu.models``
(``architecture`` key plus the factory's keys) and a ``device``. Weights are
random from an explicit seed; ``pretrained: true`` then loads the caffe trunk
features from ``<data root>/networks/`` (``torch_import.py``; nothing is
downloaded). A whitening given as a local pkl path fills the ``whiten``
layer.
Image-to-image nets carry ``meta`` ``in_channels``/``out_channels``.
"""
import math
import pickle

import numpy as np
import torch

from ..device import resolve_device
from . import autoencoder, torch_import, unet
from .retrievalnet import ImageRetrievalNet


def init_weights(model, seed=0):
    """Seeded random weights: conv, transposed conv and linear weights
    ~ N(0, 1/fan_in) (flax's default lecun scale), biases 0; BatchNorm and
    GeM p keep their defaults (identity statistics, p = 3)."""
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                   torch.nn.Linear)):
                fan_in = module.weight[0].numel()
                if isinstance(module, torch.nn.ConvTranspose2d):
                    # (in, out, kh, kw): each output sums in * kh * kw taps
                    fan_in = module.weight[:, 0].numel()
                module.weight.copy_(torch.randn(
                    module.weight.shape, generator=generator)
                    / math.sqrt(fan_in))
                if module.bias is not None:
                    module.bias.zero_()
    return model


def load_whitening_pkl(model, whitening_path):
    """Whitening pkl {'P', 'm'} -> whiten Linear (weight P, bias -P m)."""
    with open(whitening_path, "rb") as handle:
        whit = pickle.load(handle)
    P = np.asarray(whit["P"], np.float32)
    m = np.asarray(whit["m"], np.float32).reshape(-1, 1)
    with torch.no_grad():
        model.whiten.weight.copy_(torch.from_numpy(P))
        model.whiten.bias.copy_(torch.from_numpy((-P @ m).reshape(-1)))
    return model


def _make_cirnet(device, seed=0, **params):
    """cirnet factory (reference cirnet.py:10-23)."""
    for key in ["local_whitening", "pooling", "regional", "whitening",
                "pretrained"]:
        if key not in params:
            raise ValueError("Key '%s' not in params" % key)
    pretrained = params.pop("pretrained")
    whitening = params.pop("whitening")
    architecture = params.pop("cir_architecture")
    model = ImageRetrievalNet(
        architecture=architecture,
        local_whitening=params.pop("local_whitening"),
        pooling=params.pop("pooling"),
        regional=params.pop("regional"),
        whitening=bool(whitening))
    assert not params, params.keys()
    if seed is not None:
        init_weights(model, seed)
    if pretrained:
        torch_import.load_pretrained_features(model, architecture)
    if isinstance(whitening, str):
        load_whitening_pkl(model, whitening)
    model.meta["whitening"] = whitening
    return model.eval().to(device)


class Identity(unet.ImageModel):

    def __init__(self):
        super().__init__(None, None)
        self.meta = {}

    def forward(self, x):
        return x


def _make_identity(device, _seed, **params):
    assert not params, params.keys()
    return Identity().eval().to(device)


def _make_unet(cls):
    """Factory of an image-to-image net; ``hidden`` becomes a tuple."""
    def factory(device, seed, in_channels, out_channels, **params):
        if params.get("hidden") is not None:
            params["hidden"] = tuple(params["hidden"])
        model = cls(in_channels=in_channels, out_channels=out_channels,
                    **params)
        if seed is not None:
            init_weights(model, seed)
        return model.eval().to(device)
    return factory


MODEL_LABELS = {
    "identity": _make_identity,
    "orig_unet": _make_unet(unet.OrigUNet),
    "p2p_unet": _make_unet(unet.P2pUNet),
    "outconv_unet": _make_unet(unet.OutconvP2pUNet),
    "outconv_dynint_unet": _make_unet(unet.OutconvP2pUNetDynamicInterpolate),
    "shallow_p2p_unet": _make_unet(unet.ShallowP2pUNet),
    "inconv_p2p_unet": _make_unet(unet.InconvP2pUNet),
    "aligned_p2p_unet": _make_unet(unet.AlignedP2pUNet),
    "pixelconv_regr": _make_unet(autoencoder.PixelConvRegr),
    "pixelconv_res": _make_unet(autoencoder.PixelConvRes),
    "autoencoder_regr": _make_unet(autoencoder.AutoencoderRegr),
    "cirnet": _make_cirnet,
}


#: architectures of the JAX package the port does not build yet, and why
NOT_PORTED = {
    "cirnet_branched": "the branched retrieval net (JAX models/branched.py, "
                       "BranchedRetrievalNet) is ROADMAP queue 1 item 6.3, "
                       "the next slice",
}


def initialize_model(params, device="cuda", seed=0):
    """Build a model from its params dict on ``device``, its weights drawn
    from ``seed``; with ``seed`` None they are left to a strict load of a
    checkpoint (the draw costs about a second for a full P2pUNet)."""
    device = resolve_device(device)
    params = dict(params)
    architecture = params.pop("architecture")
    if architecture in NOT_PORTED:
        raise NotImplementedError("architecture %r is not ported: %s"
                                  % (architecture, NOT_PORTED[architecture]))
    return MODEL_LABELS[architecture](device, seed, **params)
