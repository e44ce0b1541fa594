"""CNN feature trunks in NCHW, with exact valid-extent masking.

The ResNet, VGG and AlexNet trunks of ``mdir_tpu/models/trunks.py``, named
as cirtorch names them, so a cirtorch state dict loads as it is:
torchvision's resnet without avgpool/fc (``features.0`` = conv1,
``features.1`` = bn1, ``features.4``..``features.7`` = layer1..layer4), and
the ``features`` stack of alexnet/vgg without its final maxpool
(``features.<idx>`` = the conv at torchvision index idx).

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


class SequentialFeatures(nn.ModuleDict):
    """Feature stack named by torchvision ``features.<idx>`` indices.

    Spec items: ``("conv", idx, out, k, s, p)`` (with bias),
    ``("relu",)``, ``("maxpool", k, s[, p])``. The valid extent is masked
    after every ReLU and after every maxpool, as in the JAX package.
    """

    def __init__(self, spec, in_channels=3):
        modules = {}
        for item in spec:
            if item[0] == "conv":
                _, idx, out, k, s, p = item
                modules[str(idx)] = nn.Conv2d(in_channels, out, k, s, p)
                in_channels = out
            elif item[0] not in ("relu", "maxpool"):
                raise NotImplementedError("spec item %r is not ported yet"
                                          % (item,))
        super().__init__(modules)
        self.spec = tuple(spec)

    def forward(self, x, valid_hw=None):
        for item in self.spec:
            if item[0] == "conv":
                _, idx, _, k, s, p = item
                x = self[str(idx)](x)
                if valid_hw is not None:
                    valid_hw = conv_out_extent(valid_hw, k, s, p)
            elif item[0] == "relu":
                x = apply_valid_mask(F.relu(x), valid_hw)
            else:  # maxpool
                p = item[3] if len(item) > 3 else 0
                x = F.max_pool2d(x, item[1], item[2], padding=p)
                if valid_hw is not None:
                    valid_hw = conv_out_extent(valid_hw, item[1], item[2], p)
                    x = apply_valid_mask(x, valid_hw)
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


def _arch_spec(architecture):
    """SequentialFeatures spec of alexnet/vgg (None for the others)."""
    if architecture == "alexnet":
        return ALEXNET_SPEC
    if architecture in VGG_CFGS:
        return _vgg_spec(VGG_CFGS[architecture])
    return None


def make_trunk(architecture):
    """Build the feature trunk module for an architecture label."""
    spec = _arch_spec(architecture)
    if spec is not None:
        return SequentialFeatures(spec)
    if architecture in RESNET_LAYERS:
        block, layers = RESNET_LAYERS[architecture]
        return ResNetFeatures(block, layers)
    raise NotImplementedError(
        "trunk %r is not ported yet (the port has the resnets, vgg and "
        "alexnet)" % architecture)


def trunk_valid_extent(architecture, hw):
    """Host replay of the trunk's valid-extent arithmetic for one image:
    the feature-map extent that an input of true size ``hw`` gives."""
    h, w = int(hw[0]), int(hw[1])
    step = conv_out_extent
    spec = _arch_spec(architecture)
    if spec is not None:
        for item in spec:
            if item[0] == "conv":
                _, _, _, k, s, p = item
                h, w = step(h, k, s, p), step(w, k, s, p)
            elif item[0] == "maxpool":
                p = item[3] if len(item) > 3 else 0
                h, w = step(h, item[1], item[2], p), \
                    step(w, item[1], item[2], p)
        return h, w
    if architecture not in RESNET_LAYERS:
        raise NotImplementedError("trunk %r is not ported yet" % architecture)
    h, w = step(h, 7, 2, 3), step(w, 7, 2, 3)
    h, w = step(h, 3, 2, 1), step(w, 3, 2, 1)
    for _ in range(3):  # layers 2-4 start with a stride-2 3x3 p1 conv
        h, w = step(h, 3, 2, 1), step(w, 3, 2, 1)
    return h, w
