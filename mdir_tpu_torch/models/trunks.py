"""CNN feature trunks in NCHW, with exact valid-extent masking.

The ResNet trunk of ``mdir_tpu/models/trunks.py``: torchvision's resnet
without avgpool/fc, named as cirtorch names it (``features.0`` = conv1,
``features.1`` = bn1, ``features.4``..``features.7`` = layer1..layer4), so a
cirtorch state dict loads as it is. AlexNet and VGG come with a later slice.

Static-shape batching: images padded into a shape bucket carry a per-image
valid extent ``valid_hw`` (N, 2) through the trunk. After every
nonlinearity and pooling stage the cells outside the extent are zeroed and
the extent follows torch's floor arithmetic, so a bucketed batch gives what
each image gives at its own size.
"""
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


def make_trunk(architecture):
    """Build the feature trunk module for an architecture label."""
    if architecture in RESNET_LAYERS:
        block, layers = RESNET_LAYERS[architecture]
        return ResNetFeatures(block, layers)
    raise NotImplementedError(
        "trunk %r is not ported yet (this slice ports the resnets)"
        % architecture)


def trunk_valid_extent(architecture, hw):
    """Host replay of the trunk's valid-extent arithmetic for one image:
    the feature-map extent that an input of true size ``hw`` gives."""
    h, w = int(hw[0]), int(hw[1])
    if architecture not in RESNET_LAYERS:
        raise NotImplementedError("trunk %r is not ported yet" % architecture)
    step = conv_out_extent
    h, w = step(h, 7, 2, 3), step(w, 7, 2, 3)
    h, w = step(h, 3, 2, 1), step(w, 3, 2, 1)
    for _ in range(3):  # layers 2-4 start with a stride-2 3x3 p1 conv
        h, w = step(h, 3, 2, 1), step(w, 3, 2, 1)
    return h, w
