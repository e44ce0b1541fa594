"""U-Net night->day translator family in NCHW: the nets of
``mdir_tpu/models/unet.py`` (reference ``mdir/components/model/network/
unet.py``).

The pix2pix-style nets (P2pUNet, ShallowP2pUNet, OutconvP2pUNet,
InconvP2pUNet, AlignedP2pUNet, OutconvP2pUNetDynamicInterpolate) are built
from one spec executor, as in the JAX package: a spec is a tuple of items
(``conv``, ``convT``, ``bn``, ``relu``, ``lrelu``, ``tanh``, ``dropout``,
``skip``, ``dyn``), and ``seq`` turns it into an ``nn.Sequential`` in which
every item, parametric or not, takes its index. Module names are therefore
the reference torch ``Sequential`` indices (``outerblock.2.nested.3...``), and
a reference state dict loads with ``load_state_dict(strict=True)``. OrigUNet
is the classic conv-conv / maxpool / convT U-Net with the reference's
attribute names.

BatchNorm is frozen (its running statistics) and Dropout is the identity in
eval: the port runs these nets for inference only. The convolutions are
cuDNN's on the card, as the JAX package leaves them to XLA.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import FrozenBatchNorm2d


class ImageModel(nn.Module):
    """An image-to-image net with its ``meta`` channels and its device."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.meta = {"in_channels": in_channels, "out_channels": out_channels}
        # a non-persistent anchor: the device of a net without parameters
        self.register_buffer("_anchor", torch.empty(0), persistent=False)

    @property
    def device(self):
        return self._anchor.device


# --- generic torch-Sequential-shaped executor ------------------------------

def _item(item, channels):
    """One spec item as a module, and the channels it outputs."""
    kind = item[0]
    if kind in ("conv", "convT"):
        _, out, k, s, p, bias = item
        layer = nn.Conv2d if kind == "conv" else nn.ConvTranspose2d
        return layer(channels, out, k, s, p, bias=bias), out
    if kind == "bn":
        return FrozenBatchNorm2d(channels), channels
    if kind == "relu":
        return nn.ReLU(), channels
    if kind == "lrelu":
        return nn.LeakyReLU(item[1]), channels
    if kind == "tanh":
        return nn.Tanh(), channels
    if kind == "dropout":
        return nn.Dropout(item[1]), channels
    if kind == "skip":
        block = SkipCat(item[1], channels)
        return block, block.out_channels
    if kind == "dyn":
        block = DynSkipBlock(item[1], item[2], item[3], channels)
        return block, block.out_channels
    raise ValueError(kind)


def seq(spec, channels):
    """A spec as ``nn.Sequential`` (one index per item) and its output
    channels."""
    modules = []
    for item in spec:
        module, channels = _item(item, channels)
        modules.append(module)
    return nn.Sequential(*modules), channels


class SkipCat(nn.Module):
    """pix2pix skip block: cat([x, nested(x)]) on channels."""

    def __init__(self, spec, channels):
        super().__init__()
        self.nested, nested_channels = seq(spec, channels)
        self.out_channels = channels + nested_channels

    def forward(self, x):
        return torch.cat([x, self.nested(x)], dim=1)


def _resize_to(x, size, upsample):
    """jax.image.resize to ``size`` (an upsampling): half-pixel centres,
    as ``F.interpolate(..., align_corners=False)`` places them."""
    if upsample == "bilinear":
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)
    if upsample == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    raise ValueError("upsample %r" % (upsample,))


class DynSkipBlock(nn.Module):
    """Resize-convolution skip block: down -> interpolate to the input's
    size -> up -> cat([x, .])."""

    def __init__(self, down_spec, up_spec, upsample, channels):
        super().__init__()
        self.upsample = upsample
        self.down, down_channels = seq(down_spec, channels)
        self.up, up_channels = seq(up_spec, down_channels)
        self.out_channels = channels + up_channels

    def forward(self, x):
        y = self.down(x)
        y = self.up(_resize_to(y, x.shape[-2:], self.upsample))
        return torch.cat([x, y], dim=1)


# --- P2pUNet family ---------------------------------------------------------

def _p2p_skip_spec(nested, outer_ch, inter_ch, conv_kwargs, batchnorm=True,
                   dropout=0.0):
    k, s, p, bias = conv_kwargs
    spec = [("conv", inter_ch, k, s, p, bias)]
    if nested is not None:
        if batchnorm:
            spec.append(("bn",))
        spec += [("lrelu", 0.2), ("skip", nested)]
    else:
        spec.append(("relu",))
    spec.append(("convT", outer_ch, k, s, p, bias))
    if batchnorm:
        spec.append(("bn",))
    if dropout:
        spec.append(("dropout", dropout))
    spec.append(("relu",))
    return tuple(spec)


def _p2p_blocks(nested_levels, dropout=0.0):
    blocks = [(64, 128), (128, 256), (256, 512), (512, 512)][:nested_levels]
    blocks += [(512, 512, True)] * (nested_levels - len(blocks))
    return [(b[0], b[1], dropout * (b[2] if len(b) == 3 else False))
            for b in blocks]


def _plain_blocks(nested_levels):
    blocks = [(64, 128), (128, 256), (256, 512)][:nested_levels]
    return blocks + [(512, 512)] * (nested_levels - len(blocks))


def _nest(blocks, make):
    """The skip specs of ``blocks`` nested innermost first."""
    inner = None
    for block in reversed(blocks):
        inner = make(inner, *block)
    return inner


class SpecUNet(ImageModel):
    """A net that is one spec, ``outerblock``, made by ``spec(**config)``."""

    def __init__(self, in_channels, out_channels, **config):
        super().__init__(in_channels, out_channels)
        self.outerblock, _ = seq(self.spec(out_channels, **config),
                                 in_channels)

    def forward(self, x):
        return self.outerblock(x)


class P2pUNet(SpecUNet):
    """pix2pix U-Net: 4x4 s2 encoder/decoder, LeakyReLU/BN/Dropout, Tanh
    out."""

    def __init__(self, in_channels=3, out_channels=3, dropout=0.0,
                 batchnorm=True, nested_levels=7):
        super().__init__(in_channels, out_channels, dropout=dropout,
                         batchnorm=batchnorm, nested_levels=nested_levels)

    @staticmethod
    def spec(out_channels, dropout, batchnorm, nested_levels):
        conv_kwargs = (4, 2, 1, False)
        inner = _nest(_p2p_blocks(nested_levels, dropout),
                      lambda nested, cin, cout, drop: _p2p_skip_spec(
                          nested, cin, cout, conv_kwargs, batchnorm, drop))
        return (
            ("conv", 64, 4, 2, 1, False),
            ("lrelu", 0.2),
            ("skip", inner),
            ("convT", out_channels, 4, 2, 1, True),
            ("tanh",),
        )


class ShallowP2pUNet(SpecUNet):
    """Shallow variant: double convs (4x4 s2 + 1x1), ReLU only, conv head."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=4):
        super().__init__(in_channels, out_channels,
                         nested_levels=nested_levels)

    @staticmethod
    def spec(out_channels, nested_levels):
        def skip_spec(nested, outer_ch, inter_ch):
            spec = [
                ("conv", inter_ch, 4, 2, 1, True), ("relu",),
                ("conv", inter_ch, 1, 1, 0, True), ("relu",),
            ]
            if nested is not None:
                spec.append(("skip", nested))
            spec += [
                ("convT", outer_ch, 4, 2, 1, True), ("relu",),
                ("conv", outer_ch, 1, 1, 0, True), ("relu",),
            ]
            return tuple(spec)

        return (
            ("conv", 64, 4, 2, 1, True), ("relu",),
            ("conv", 64, 1, 1, 0, True), ("relu",),
            ("skip", _nest(_plain_blocks(nested_levels), skip_spec)),
            ("convT", 64, 4, 2, 1, True), ("relu",),
            ("conv", 64, 1, 1, 0, True), ("relu",),
            ("conv", out_channels, 1, 1, 0, True),
        )


class OutconvP2pUNet(SpecUNet):
    """P2pUNet with a conv head instead of Tanh."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7,
                 outconv_channels=32, outconv_kernel=3, dropout=0.0,
                 batchnorm=False):
        assert outconv_kernel % 2 == 1
        super().__init__(in_channels, out_channels,
                         nested_levels=nested_levels,
                         outconv_channels=outconv_channels,
                         outconv_kernel=outconv_kernel, dropout=dropout,
                         batchnorm=batchnorm)

    @staticmethod
    def spec(out_channels, nested_levels, outconv_channels, outconv_kernel,
             dropout, batchnorm):
        conv_kwargs = (4, 2, 1, True)
        inner = _nest(_plain_blocks(nested_levels),
                      lambda nested, cin, cout: _p2p_skip_spec(
                          nested, cin, cout, conv_kwargs, batchnorm,
                          dropout))
        k = outconv_kernel
        return (
            ("conv", 64, 4, 2, 1, True),
            ("lrelu", 0.2),
            ("skip", inner),
            ("convT", outconv_channels, 4, 2, 1, True),
            ("relu",),
            ("conv", out_channels, k, 1, k // 2, True),
        )


def _unnormalized_core(nested_levels):
    """The pix2pix core without BatchNorm or Dropout, biased convs."""
    return _nest(_plain_blocks(nested_levels),
                 lambda nested, cin, cout: _p2p_skip_spec(
                     nested, cin, cout, (4, 2, 1, True), batchnorm=False))


class InconvP2pUNet(SpecUNet):
    """P2pUNet with a 1x1 conv stem."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7):
        super().__init__(in_channels, out_channels,
                         nested_levels=nested_levels)

    @staticmethod
    def spec(out_channels, nested_levels):
        return (
            ("conv", 64, 1, 1, 0, True), ("lrelu", 0.2),
            ("conv", 64, 4, 2, 1, True), ("lrelu", 0.2),
            ("skip", _unnormalized_core(nested_levels)),
            ("convT", out_channels, 4, 2, 1, True),
            ("tanh",),
        )


class AlignedP2pUNet(SpecUNet):
    """Stride-1 3x3 stem/head around the pix2pix core."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7):
        super().__init__(in_channels, out_channels,
                         nested_levels=nested_levels)

    @staticmethod
    def spec(out_channels, nested_levels):
        return (
            ("conv", 64, 3, 1, 1, True), ("relu",),
            ("conv", 64, 3, 1, 1, True), ("relu",),
            ("skip", _unnormalized_core(nested_levels)),
            ("conv", 64, 3, 1, 1, True), ("relu",),
            ("conv", 64, 3, 1, 1, True), ("relu",),
            ("conv", out_channels, 3, 1, 1, True),
        )


class OutconvP2pUNetDynamicInterpolate(ImageModel):
    """Resize-convolution upsampling to the exact input size.

    ``down`` = Sequential(conv, LeakyReLU, DynSkipBlock), each DynSkipBlock
    carrying its own ``down``/``up`` Sequentials (the nested block appended
    to ``down``); ``up`` = Sequential(conv, ReLU, conv). Reference state
    dict keys such as ``down.2.down.2.up.0.weight`` load as they are.
    """

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7,
                 upsample="bilinear", outconv_channels=32, outconv_kernel=3,
                 dropout=0.0, batchnorm=False):
        assert outconv_kernel % 2 == 1
        super().__init__(in_channels, out_channels)
        self.upsample = upsample

        def make_block(nested, outer_ch, inter_ch):
            down = [("conv", inter_ch, 4, 2, 1, True)]
            if batchnorm:
                down.append(("bn",))
            down.append(("lrelu", 0.2))
            if nested is not None:
                down.append(nested)
            up = [("conv", outer_ch, 3, 1, 1, True)]
            if batchnorm:
                up.append(("bn",))
            if dropout:
                up.append(("dropout", dropout))
            up.append(("relu",))
            return ("dyn", tuple(down), tuple(up), upsample)

        inner = _nest(_plain_blocks(nested_levels), make_block)
        self.down, channels = seq((("conv", 64, 4, 2, 1, True),
                                   ("lrelu", 0.2), inner), in_channels)
        self.up, _ = seq((("conv", outconv_channels, 3, 1, 1, True),
                          ("relu",),
                          ("conv", out_channels, outconv_kernel, 1,
                           outconv_kernel // 2, True)), channels)

    def forward(self, x):
        return self.up(_resize_to(self.down(x), x.shape[-2:], self.upsample))


# --- classic U-Net ----------------------------------------------------------

class OrigConvBlock(nn.Module):
    def __init__(self, in_channels, features):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class OrigSkipBlock(nn.Module):
    """downconv / maxpool / nested / convT / upconv(cat), the reference's
    attribute names."""

    def __init__(self, in_channels, level, nested_levels, min_channels):
        super().__init__()
        channels = min_channels * 2 ** level
        self.downconv = OrigConvBlock(in_channels, channels)
        if level + 1 == nested_levels:
            self.nested = OrigConvBlock(channels, channels * 2)
        else:
            self.nested = OrigSkipBlock(channels, level + 1, nested_levels,
                                        min_channels)
        self.convT = nn.ConvTranspose2d(channels * 2, channels, 2, 2, 0)
        self.upconv = OrigConvBlock(channels * 2, channels)

    def forward(self, x):
        x1 = self.downconv(x)
        y = self.convT(self.nested(F.max_pool2d(x1, 2, 2)))
        return self.upconv(torch.cat([x1, y], dim=1))


class OrigUNet(ImageModel):
    """Classic U-Net: conv-conv/maxpool encoder, convT decoder, skip concat."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=4,
                 min_channels=64):
        super().__init__(in_channels, out_channels)
        self.outerblock = OrigSkipBlock(in_channels, 0, nested_levels,
                                        min_channels)
        self.outconv = nn.Conv2d(min_channels, out_channels, 1)

    def forward(self, x):
        return self.outconv(self.outerblock(x))
