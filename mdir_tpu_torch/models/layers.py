"""Layers with the numerics of ``mdir_tpu/models/layers.py``, in NCHW/OIHW.

Convolutions are ``nn.Conv2d`` and max pooling ``F.max_pool2d`` (torch
semantics are the reference's; cuDNN on the card, in full float32 once
``device.resolve_device`` has turned TF32 off). BatchNorm is frozen: it
always normalises with its running statistics, the only mode the retrieval
nets use.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d that always uses its running statistics.

    State names follow ``nn.BatchNorm2d`` (weight, bias, running_mean,
    running_var), so torchvision/cirtorch state dicts load as they are.
    """

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)
