"""Pixel-wise colour mappers (1x1-conv autoencoders) in NCHW: the nets of
``mdir_tpu/models/autoencoder.py`` (reference ``mdir/components/model/
network/autoencoder.py``). PixelConvRegr is a 1x1-conv MLP with a Tanh out,
PixelConvRes adds its output to channels 0:2 of the input, and
AutoencoderRegr's first conv has a reception field. The convolutions are
named ``model_<i>`` at the reference's ``Sequential`` index i (activations
take the odd indices).
"""
import torch
import torch.nn as nn

from .unet import ImageModel

_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh}


class _PixelMLP(ImageModel):
    """Convs ``model_0, model_2, ...`` with the hidden activation between
    them; the first has ``first_kernel`` (odd) as its kernel."""

    def __init__(self, in_channels, out_channels, hidden, hidden_activation,
                 first_kernel=1):
        assert first_kernel % 2 == 1
        super().__init__(in_channels, out_channels)
        self.activation = _ACTIVATIONS[hidden_activation]
        self.names = []
        channels = in_channels
        kernel = first_kernel
        for features in tuple(hidden) + (out_channels,):
            name = "model_%d" % (2 * len(self.names))
            self.add_module(name, nn.Conv2d(channels, features, kernel, 1,
                                            kernel // 2))
            self.names.append(name)
            channels, kernel = features, 1

    def mlp(self, x):
        for name in self.names[:-1]:
            x = self.activation(getattr(self, name)(x))
        return torch.tanh(getattr(self, self.names[-1])(x))


class PixelConvRegr(_PixelMLP):

    def __init__(self, in_channels=3, out_channels=3, hidden=(16,),
                 hidden_activation="relu"):
        super().__init__(in_channels, out_channels, hidden, hidden_activation)

    def forward(self, x):
        return self.mlp(x)


class PixelConvRes(_PixelMLP):
    """Residual pixel mapper: mlp(x) + x[:, 0:2]."""

    def __init__(self, in_channels=3, out_channels=2, hidden=(16,),
                 hidden_activation="relu"):
        super().__init__(in_channels, out_channels, hidden, hidden_activation)

    def forward(self, x):
        return self.mlp(x) + x[:, 0:2]


class AutoencoderRegr(_PixelMLP):

    def __init__(self, in_channels=3, out_channels=3, hidden=(16,),
                 hidden_activation="relu", reception_field=3):
        super().__init__(in_channels, out_channels, hidden, hidden_activation,
                         first_kernel=reception_field)

    def forward(self, x):
        return self.mlp(x)
