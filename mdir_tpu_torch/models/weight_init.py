"""Weight initialisations of ``network: initialize: weights``, as
``mdir_tpu/models/weight_init.py`` defines them, drawn from an explicit
``torch.Generator`` seeded from the scenario:

* ``normal``: N(0, 1) on convolution weights and on every bias outside
  BatchNorm (the JAX package's leaf walk: conv kernels and 1-d biases);
* ``normal_p2p`` (pix2pix): weights N(0, 0.02), biases 0, BatchNorm weight
  N(1, 0.02) and bias 0;
* ``he_normal``: convolution and linear weights N(0, 2 / fan_in), biases
  0.01.

``default`` keeps the model's own seeded initialisation
(``models.init_weights``). GeM's ``p`` and the BatchNorm statistics are left
as they are. The draws are the port's own: both packages are seeded and
deterministic, not equal.
"""
import math

import torch

from .layers import BatchNorm2d


def _leaves(model):
    """(module, parameter name, parameter) of every parameter."""
    for module in model.modules():
        for name, param in module.named_parameters(recurse=False):
            yield module, name, param


def _normal(shape, generator, std=1.0, mean=0.0):
    return mean + std * torch.randn(shape, generator=generator)


def init_normal(generator, model):
    for module, name, param in _leaves(model):
        if isinstance(module, BatchNorm2d):
            continue
        if (name == "weight" and param.dim() == 4) or name == "bias":
            param.copy_(_normal(param.shape, generator))


def init_normal_p2p(generator, model):
    for module, name, param in _leaves(model):
        if isinstance(module, BatchNorm2d):
            param.copy_(_normal(param.shape, generator, 0.02, 1.0)
                        if name == "weight" else torch.zeros(param.shape))
        elif name == "weight":
            param.copy_(_normal(param.shape, generator, 0.02))
        elif name == "bias":
            param.zero_()


def init_he_normal(generator, model):
    for module, name, param in _leaves(model):
        if isinstance(module, BatchNorm2d):
            continue
        if name == "weight":
            fan_in = param[0].numel()
            param.copy_(_normal(param.shape, generator,
                                math.sqrt(2.0 / fan_in)))
        elif name == "bias":
            param.fill_(0.01)


WEIGHT_INITIALIZATIONS = {
    "normal": init_normal,
    "normal_p2p": init_normal_p2p,
    "he_normal": init_he_normal,
}


@torch.no_grad()
def initialize_weights(model, weights, seed):
    """Apply initialisation ``weights`` to ``model`` from ``seed``."""
    generator = torch.Generator().manual_seed(int(seed))
    WEIGHT_INITIALIZATIONS[weights](generator, model)
    return model
