"""Layers with the numerics of ``mdir_tpu/models/layers.py``, in NCHW/OIHW.

Convolutions are ``nn.Conv2d`` and max pooling ``F.max_pool2d`` (torch
semantics are the reference's; cuDNN on the card, in full float32 once
``device.resolve_device`` has turned TF32 off).

BatchNorm has two forms. ``FrozenBatchNorm2d`` always normalises with its
running statistics: the retrieval trunks use it in training too (reference
``network.py:399-408``). ``BatchNorm2d`` is the U-Nets' live BatchNorm with
flax ``nn.BatchNorm``'s semantics (JAX ``models/layers.py:62-79``): in train
mode it normalises with the batch's mean and biased variance over
(N, H, W), padded cells included, the variance taken as
``E[x^2] - E[x]^2`` clipped at 0, and moves both running statistics by
``momentum`` 0.9 toward them, the biased variance included (where
``torch.nn.BatchNorm2d`` keeps the unbiased one); in eval mode it uses the
running statistics. Pointed at a data mesh (``set_batchnorm_mesh``), its
train-mode statistics are those of the global batch, as JAX's BatchNorm
computes them over a batch sharded on its mesh: each rank sums x and x*x
over its (N, H, W) and counts its cells, and the (2C + 1)-long vector goes
through one differentiable all-reduce (``Mesh.sum_over_ranks``), so both
running statistics move alike on every rank. Not
``torch.nn.SyncBatchNorm``: it keeps the unbiased running variance with
torch's opposite momentum, and runs on CUDA only. ``Dropout`` is active in
train mode and draws its mask from the ``torch.Generator`` in its
``generator`` attribute (the default generator when that is None), as
flax's ``nn.Dropout`` draws from the step's key: kept cells are scaled by
``1 / (1 - p)``.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.Module):
    """Live BatchNorm, flax semantics (momentum 0.9, eps 1e-5).

    State names follow ``nn.BatchNorm2d`` (weight, bias, running_mean,
    running_var), so torchvision/cirtorch state dicts load as they are.
    """

    #: the data mesh whose global batch the train-mode statistics span
    #: (``set_batchnorm_mesh``); None: this process's batch
    mesh = None

    def __init__(self, num_features, eps=1e-5, momentum=0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        dims, channels = (0, 2, 3), x.shape[1]
        sums = torch.cat([x.sum(dims), (x * x).sum(dims),
                          x.new_full((1,), x.numel() // channels)])
        if self.mesh is not None:
            sums = self.mesh.sum_over_ranks(sums)
        mean = sums[:channels] / sums[-1]
        var = torch.clamp(sums[channels:-1] / sums[-1] - mean * mean, min=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean.detach())
            self.running_var.mul_(m).add_((1 - m) * var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


class FrozenBatchNorm2d(BatchNorm2d):
    """BatchNorm2d that always uses its running statistics."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class Dropout(nn.Dropout):
    """Dropout whose train-mode mask comes from ``self.generator``."""

    generator = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = 1.0 - self.p
        if keep == 0:
            return torch.zeros_like(x)
        u = torch.rand(x.shape, generator=self.generator, device=x.device,
                       dtype=x.dtype)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def has_train_mode(model):
    """Whether ``model`` computes differently in train mode: a live
    BatchNorm or a Dropout with p > 0."""
    return any(type(m) is BatchNorm2d
               or (isinstance(m, nn.Dropout) and m.p > 0)
               for m in model.modules())


def set_batchnorm_mesh(model, mesh):
    """Point every live ``BatchNorm2d`` of ``model`` at ``mesh`` (None: the
    statistics of this process's batch)."""
    for module in model.modules():
        if type(module) is BatchNorm2d:
            module.mesh = mesh


def set_dropout_generator(model, generator):
    """Point every ``Dropout`` of ``model`` at ``generator``."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator
