"""Model registry: label -> model factory (the ``cirnet`` retrieval nets).

``initialize_model`` takes the params dict of ``mdir_tpu.models``
(``architecture`` key plus the factory's keys) and a ``device``. Weights are
random from an explicit seed; nothing is downloaded, so ``pretrained: true``
raises. A whitening given as a local pkl path fills the ``whiten`` layer.
"""
import math
import pickle

import numpy as np
import torch

from ..device import resolve_device
from .retrievalnet import ImageRetrievalNet


def init_weights(model, seed=0):
    """Seeded random weights: conv and linear weights ~ N(0, 1/fan_in)
    (flax's default lecun scale), biases 0; BatchNorm and GeM p keep their
    defaults (identity statistics, p = 3)."""
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = module.weight[0].numel()
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
    if params.pop("pretrained"):
        raise ValueError("pretrained weights need a download, which the port "
                         "never does; load a checkpoint instead")
    whitening = params.pop("whitening")
    model = ImageRetrievalNet(
        architecture=params.pop("cir_architecture"),
        local_whitening=params.pop("local_whitening"),
        pooling=params.pop("pooling"),
        regional=params.pop("regional"),
        whitening=bool(whitening))
    assert not params, params.keys()
    init_weights(model, seed)
    if isinstance(whitening, str):
        load_whitening_pkl(model, whitening)
    model.meta["whitening"] = whitening
    return model.eval().to(device)


MODEL_LABELS = {
    "cirnet": _make_cirnet,
}


def initialize_model(params, device="cuda", seed=0):
    """Build a model from its params dict on ``device``."""
    device = resolve_device(device)
    params = dict(params)
    return MODEL_LABELS[params.pop("architecture")](device, seed, **params)
