"""CNN feature trunks in NCHW, with exact valid-extent masking.

The 16 trunks of ``mdir_tpu/models/trunks.py`` (AlexNet, VGG, ResNet,
DenseNet, SqueezeNet), named as cirtorch names them, so a cirtorch state
dict loads as it is: torchvision's resnet without avgpool/fc
(``features.0`` = conv1, ``features.1`` = bn1, ``features.4``..
``features.7`` = layer1..layer4), the ``features`` stack of alexnet/vgg
without its final maxpool (``features.<idx>`` = the conv at torchvision
index idx), and every child of densenet's and squeezenet's ``features``
(``features.4.denselayer1.norm1``, ``features.5.conv``, ``features.3.
squeeze``), densenet's with a ReLU appended, so every trunk ends in
non-negative activations. BatchNorm is frozen.

Static-shape batching: images padded into a shape bucket carry a per-image
valid extent ``valid_hw`` (N, 2) through the trunk. After every
nonlinearity and pooling stage the cells outside the extent are zeroed and
the extent follows torch's floor arithmetic, so a bucketed batch gives what
each image gives at its own size.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import feature_mask
from .layers import FrozenBatchNorm2d


def conv(in_channels, out_channels, kernel_size, stride, padding):
    """Bias-free convolution, as every ResNet convolution is."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                     bias=False)


# (arch -> trunk output channels), reference imageretrievalnet.py:62-79
OUTPUT_DIM = {
    "alexnet": 256,
    "vgg11": 512,
    "vgg13": 512,
    "vgg16": 512,
    "vgg19": 512,
    "resnet18": 512,
    "resnet34": 512,
    "resnet50": 2048,
    "resnet101": 2048,
    "resnet152": 2048,
    "densenet121": 1024,
    "densenet161": 2208,
    "densenet169": 1664,
    "densenet201": 1920,
    "squeezenet1_0": 512,
    "squeezenet1_1": 512,
}

# Total spatial stride of each trunk (bucket shapes should be multiples).
TOTAL_STRIDE = {
    "alexnet": 16, "vgg11": 16, "vgg13": 16, "vgg16": 16, "vgg19": 16,
    "resnet18": 32, "resnet34": 32, "resnet50": 32, "resnet101": 32,
    "resnet152": 32,
    "densenet121": 32, "densenet161": 32, "densenet169": 32,
    "densenet201": 32,
    "squeezenet1_0": 16, "squeezenet1_1": 16,
}


def conv_out_extent(valid, kernel, stride, padding):
    """torch output-size arithmetic on an int or an integer tensor extent."""
    return (valid + 2 * padding - kernel) // stride + 1


def apply_valid_mask(x, valid_hw):
    """Zero all cells at or beyond the per-image valid extent. x: (N,C,H,W)."""
    if valid_hw is None:
        return x
    return x * feature_mask(x.shape[-2:], valid_hw, dtype=x.dtype)[:, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, downsample=False):
        super().__init__()
        self.stride = stride
        self.conv1 = conv(in_planes, planes, 3, stride, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = nn.Sequential(
            conv(in_planes, planes, 1, stride, 0),
            FrozenBatchNorm2d(planes)) if downsample else None

    def forward(self, x, valid_hw=None):
        identity = x
        out = self.conv1(x)
        if valid_hw is not None:
            valid_hw = conv_out_extent(valid_hw, 3, self.stride, 1)
        out = apply_valid_mask(F.relu(self.bn1(out)), valid_hw)
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return apply_valid_mask(F.relu(out + identity), valid_hw), valid_hw


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck (stride on the 3x3 conv)."""
    expansion = 4

    def __init__(self, in_planes, planes, stride=1, downsample=False):
        super().__init__()
        self.stride = stride
        self.conv1 = conv(in_planes, planes, 1, 1, 0)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1, 1, 0)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            conv(in_planes, planes * 4, 1, stride, 0),
            FrozenBatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x, valid_hw=None):
        identity = x
        out = apply_valid_mask(F.relu(self.bn1(self.conv1(x))), valid_hw)
        out = self.conv2(out)
        if valid_hw is not None:
            valid_hw = conv_out_extent(valid_hw, 3, self.stride, 1)
        out = apply_valid_mask(F.relu(self.bn2(out)), valid_hw)
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return apply_valid_mask(F.relu(out + identity), valid_hw), valid_hw


RESNET_LAYERS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


class ResNetFeatures(nn.ModuleDict):
    """torchvision resnet minus avgpool/fc (``children()[:-2]``).

    Children are keyed by their cirtorch ``features`` index: "0" conv1,
    "1" bn1, "4".."7" the four layers (index 2 is the ReLU and 3 the max
    pool, which hold no state).
    """

    def __init__(self, block, layers):
        modules = {"0": conv(3, 64, 7, 2, 3),
                   "1": FrozenBatchNorm2d(64)}
        in_planes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers)):
            stride = 1 if li == 0 else 2
            stage = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                downsample = bi == 0 and (
                    s != 1 or in_planes != planes * block.expansion)
                stage.append(block(in_planes, planes, s, downsample))
                in_planes = planes * block.expansion
            modules[str(li + 4)] = nn.ModuleList(stage)
        super().__init__(modules)

    def forward(self, x, valid_hw=None):
        x = self["0"](x)
        if valid_hw is not None:
            valid_hw = conv_out_extent(valid_hw, 7, 2, 3)
        x = apply_valid_mask(F.relu(self["1"](x)), valid_hw)
        x = F.max_pool2d(x, 3, 2, padding=1)
        if valid_hw is not None:
            valid_hw = conv_out_extent(valid_hw, 3, 2, 1)
            x = apply_valid_mask(x, valid_hw)
        for key in ("4", "5", "6", "7"):
            for block in self[key]:
                x, valid_hw = block(x, valid_hw)
        return x, valid_hw


def ceil_out_extent(valid, kernel, stride):
    """torch's ceil_mode pooling output size (padding 0)."""
    return (valid - kernel + stride - 1) // stride + 1


def max_pool_ceil(x, kernel_size, stride):
    """torch ``MaxPool2d(ceil_mode=True, padding=0)``. A tail window past a
    padded image's valid extent sees its masked zeros besides the valid
    cells, where the native-size image's partial window sees the valid
    cells alone: the same max, since the squeezenet trunk feeds it
    non-negative (post-ReLU) values. The JAX package pads the tail with
    zeros for the same reason."""
    return F.max_pool2d(x, kernel_size, stride, ceil_mode=True)


class Fire(nn.Module):
    """squeezenet Fire: squeeze 1x1 -> (expand1x1 || expand3x3), all ReLU.
    The squeeze output is masked before the 3x3 expand, so that bias in
    padded cells cannot leak across the valid boundary."""

    def __init__(self, in_channels, squeeze, expand1, expand3):
        super().__init__()
        self.squeeze = nn.Conv2d(in_channels, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3, 3, 1, 1)

    def forward(self, x, valid_hw=None):
        s = apply_valid_mask(F.relu(self.squeeze(x)), valid_hw)
        out = torch.cat([F.relu(self.expand1x1(s)),
                         F.relu(self.expand3x3(s))], dim=1)
        return apply_valid_mask(out, valid_hw)


class DenseLayer(nn.Module):
    """torchvision ``_DenseLayer``: BN-ReLU-1x1 -> BN-ReLU-3x3, its output
    concatenated to its input. Masked after each ReLU: frozen BatchNorm
    turns padded zeros into a per-channel constant that the 3x3 conv would
    smear across the valid boundary."""

    def __init__(self, in_channels, growth):
        super().__init__()
        self.norm1 = FrozenBatchNorm2d(in_channels)
        self.conv1 = nn.Conv2d(in_channels, 4 * growth, 1, bias=False)
        self.norm2 = FrozenBatchNorm2d(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, 1, 1, bias=False)

    def forward(self, x, valid_hw=None):
        y = apply_valid_mask(F.relu(self.norm1(x)), valid_hw)
        y = apply_valid_mask(F.relu(self.norm2(self.conv1(y))), valid_hw)
        return torch.cat([x, self.conv2(y)], dim=1)


class DenseBlock(nn.ModuleDict):
    """torchvision ``_DenseBlock``: ``denselayer1``..``denselayer<n>``."""

    def __init__(self, in_channels, growth, layers):
        super().__init__({"denselayer%d" % (i + 1):
                          DenseLayer(in_channels + i * growth, growth)
                          for i in range(layers)})

    def forward(self, x, valid_hw=None):
        for layer in self.values():
            x = layer(x, valid_hw)
        return x


class DenseTransition(nn.Module):
    """torchvision ``_Transition``: BN-ReLU-1x1 conv, then a 2x2 stride-2
    average pool, masked to its output extent."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm = FrozenBatchNorm2d(in_channels)
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x, valid_hw=None):
        y = apply_valid_mask(F.relu(self.norm(x)), valid_hw)
        y = F.avg_pool2d(self.conv(y), 2, 2)
        if valid_hw is not None:
            valid_hw = conv_out_extent(valid_hw, 2, 2, 0)
            y = apply_valid_mask(y, valid_hw)
        return y, valid_hw


class SequentialFeatures(nn.ModuleDict):
    """Feature stack named by torchvision ``features.<idx>`` indices.

    Spec items: ``("conv", idx, out, k, s, p[, use_bias])``, ``("relu",)``,
    ``("maxpool", k, s[, p])``, ``("maxpool_ceil", k, s)``, ``("bn",
    idx)``, ``("fire", idx, squeeze, e1, e3)``, ``("denseblock", idx,
    growth, n)``, ``("transition", idx, out)``. The valid extent is masked
    after every ReLU and every pool, as in the JAX package.
    """

    def __init__(self, spec, in_channels=3):
        modules = {}
        for item in spec:
            kind = item[0]
            if kind == "conv":
                _, idx, out, k, s, p = item[:6]
                use_bias = item[6] if len(item) > 6 else True
                modules[str(idx)] = nn.Conv2d(in_channels, out, k, s, p,
                                              bias=use_bias)
                in_channels = out
            elif kind == "bn":
                modules[str(item[1])] = FrozenBatchNorm2d(in_channels)
            elif kind == "fire":
                _, idx, squeeze, e1, e3 = item
                modules[str(idx)] = Fire(in_channels, squeeze, e1, e3)
                in_channels = e1 + e3
            elif kind == "denseblock":
                _, idx, growth, layers = item
                modules[str(idx)] = DenseBlock(in_channels, growth, layers)
                in_channels += layers * growth
            elif kind == "transition":
                modules[str(item[1])] = DenseTransition(in_channels,
                                                        item[2])
                in_channels = item[2]
            elif kind not in ("relu", "maxpool", "maxpool_ceil"):
                raise ValueError("unknown spec item %r" % (item,))
        super().__init__(modules)
        self.spec = tuple(spec)

    def forward(self, x, valid_hw=None):
        for item in self.spec:
            kind = item[0]
            if kind == "conv":
                _, idx, _, k, s, p = item[:6]
                x = self[str(idx)](x)
                if valid_hw is not None:
                    valid_hw = conv_out_extent(valid_hw, k, s, p)
            elif kind == "relu":
                x = apply_valid_mask(F.relu(x), valid_hw)
            elif kind == "maxpool":
                p = item[3] if len(item) > 3 else 0
                x = F.max_pool2d(x, item[1], item[2], padding=p)
                if valid_hw is not None:
                    valid_hw = conv_out_extent(valid_hw, item[1], item[2], p)
                    x = apply_valid_mask(x, valid_hw)
            elif kind == "maxpool_ceil":
                x = max_pool_ceil(x, item[1], item[2])
                if valid_hw is not None:
                    valid_hw = ceil_out_extent(valid_hw, item[1], item[2])
                    x = apply_valid_mask(x, valid_hw)
            elif kind in ("bn", "fire", "denseblock"):
                module = self[str(item[1])]
                x = module(x) if kind == "bn" else module(x, valid_hw)
            else:  # transition
                x, valid_hw = self[str(item[1])](x, valid_hw)
        return x, valid_hw


# torchvision ``features`` indices with cirtorch's [:-1] slicing: the
# trailing maxpool is dropped so the trunk ends with a ReLU
ALEXNET_SPEC = (
    ("conv", 0, 64, 11, 4, 2), ("relu",), ("maxpool", 3, 2),
    ("conv", 3, 192, 5, 1, 2), ("relu",), ("maxpool", 3, 2),
    ("conv", 6, 384, 3, 1, 1), ("relu",),
    ("conv", 8, 256, 3, 1, 1), ("relu",),
    ("conv", 10, 256, 3, 1, 1), ("relu",),
)


def _vgg_spec(cfg):
    spec = []
    idx = 0
    for v in cfg:
        if v == "M":
            spec.append(("maxpool", 2, 2))
            idx += 1
        else:
            spec.append(("conv", idx, v, 3, 1, 1))
            spec.append(("relu",))
            idx += 2
    if spec[-1][0] == "maxpool":  # drop the final maxpool ([:-1])
        spec = spec[:-1]
    return tuple(spec)


VGG_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
              512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


# densenet: (initial features, growth rate, block sizes)
DENSENET_CFGS = {
    "densenet121": (64, 32, (6, 12, 24, 16)),
    "densenet161": (96, 48, (6, 12, 36, 24)),
    "densenet169": (64, 32, (6, 12, 32, 32)),
    "densenet201": (64, 32, (6, 12, 48, 32)),
}


def _densenet_spec(arch):
    """cirtorch's slicing (imageretrievalnet.py:175-177): every child of
    torchvision's ``features`` (re-indexed 0..11 by ``nn.Sequential``) and
    a ReLU appended, so the activations are non-negative."""
    init, growth, blocks = DENSENET_CFGS[arch]
    spec = [("conv", 0, init, 7, 2, 3, False), ("bn", 1), ("relu",),
            ("maxpool", 3, 2, 1)]
    channels = init
    idx = 4
    for bi, layers in enumerate(blocks):
        spec.append(("denseblock", idx, growth, layers))
        channels += layers * growth
        idx += 1
        if bi < len(blocks) - 1:
            channels //= 2
            spec.append(("transition", idx, channels))
            idx += 1
    spec += [("bn", idx), ("relu",)]
    return tuple(spec)


# squeezenet: cirtorch takes every child of torchvision's ``features``
# (imageretrievalnet.py:178-179); fire items are (squeeze, e1x1, e3x3)
SQUEEZENET_SPECS = {
    "squeezenet1_0": (
        ("conv", 0, 96, 7, 2, 0), ("relu",), ("maxpool_ceil", 3, 2),
        ("fire", 3, 16, 64, 64), ("fire", 4, 16, 64, 64),
        ("fire", 5, 32, 128, 128), ("maxpool_ceil", 3, 2),
        ("fire", 7, 32, 128, 128), ("fire", 8, 48, 192, 192),
        ("fire", 9, 48, 192, 192), ("fire", 10, 64, 256, 256),
        ("maxpool_ceil", 3, 2), ("fire", 12, 64, 256, 256),
    ),
    "squeezenet1_1": (
        ("conv", 0, 64, 3, 2, 0), ("relu",), ("maxpool_ceil", 3, 2),
        ("fire", 3, 16, 64, 64), ("fire", 4, 16, 64, 64),
        ("maxpool_ceil", 3, 2),
        ("fire", 6, 32, 128, 128), ("fire", 7, 32, 128, 128),
        ("maxpool_ceil", 3, 2),
        ("fire", 9, 48, 192, 192), ("fire", 10, 48, 192, 192),
        ("fire", 11, 64, 256, 256), ("fire", 12, 64, 256, 256),
    ),
}


def _arch_spec(architecture):
    """SequentialFeatures spec of a spec-driven trunk (None for the
    resnets)."""
    if architecture == "alexnet":
        return ALEXNET_SPEC
    if architecture in VGG_CFGS:
        return _vgg_spec(VGG_CFGS[architecture])
    if architecture in DENSENET_CFGS:
        return _densenet_spec(architecture)
    if architecture in SQUEEZENET_SPECS:
        return SQUEEZENET_SPECS[architecture]
    return None


def make_trunk(architecture):
    """Build the feature trunk module for an architecture label."""
    spec = _arch_spec(architecture)
    if spec is not None:
        return SequentialFeatures(spec)
    if architecture in RESNET_LAYERS:
        block, layers = RESNET_LAYERS[architecture]
        return ResNetFeatures(block, layers)
    raise ValueError("unknown architecture %r" % architecture)


def trunk_valid_extent(architecture, hw):
    """Host replay of the trunk's valid-extent arithmetic for one image:
    the feature-map extent that an input of true size ``hw`` gives (the
    same formulas as the forward's, so the two cannot drift)."""
    h, w = int(hw[0]), int(hw[1])
    step = conv_out_extent
    spec = _arch_spec(architecture)
    if spec is not None:
        for item in spec:
            if item[0] == "conv":
                _, _, _, k, s, p = item[:6]
                h, w = step(h, k, s, p), step(w, k, s, p)
            elif item[0] == "maxpool":
                p = item[3] if len(item) > 3 else 0
                h, w = step(h, item[1], item[2], p), \
                    step(w, item[1], item[2], p)
            elif item[0] == "maxpool_ceil":
                h, w = ceil_out_extent(h, item[1], item[2]), \
                    ceil_out_extent(w, item[1], item[2])
            elif item[0] == "transition":
                h, w = step(h, 2, 2, 0), step(w, 2, 2, 0)
        return h, w
    if architecture not in RESNET_LAYERS:
        raise ValueError("unknown architecture %r" % architecture)
    h, w = step(h, 7, 2, 3), step(w, 7, 2, 3)
    h, w = step(h, 3, 2, 1), step(w, 3, 2, 1)
    for _ in range(3):  # layers 2-4 start with a stride-2 3x3 p1 conv
        h, w = step(h, 3, 2, 1), step(w, 3, 2, 1)
    return h, w
