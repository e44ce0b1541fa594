"""Plain PyTorch trunks of the benchmark's retrieval nets, from a state dict.

VGG16 and ResNet101 as cirtorch cuts them (torchvision's ``features``
without the last max pool; ResNet without avgpool and fc), written as plain
functional code over a dict of tensors named as cirtorch names them, so the
one dict the benchmark draws from the seed loads into the program and runs
here. One image at a time at its own size: no padding, no masks, no batching,
no kernel of the program. BatchNorm is frozen (running statistics, eps 1e-5).

``param_shapes`` lists every tensor of a net; ``draw_params`` fills them from
one seeded draw on the device; ``features`` runs the trunk; ``feature_hw``
gives the trunk's output size for an input size, by the same arithmetic.
"""
import math

import torch
import torch.nn.functional as F

VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"]
RESNET101 = (3, 4, 23, 3)
BN_EPS = 1e-5


def vgg_layers(cfg):
    """[("conv", idx, cin, cout) | ("pool",)] of cirtorch's VGG features."""
    layers, idx, cin = [], 0, 3
    for v in cfg:
        if v == "M":
            layers.append(("pool",))
            idx += 1
        else:
            layers.append(("conv", idx, cin, v))
            cin = v
            idx += 2
    if layers[-1][0] == "pool":
        layers = layers[:-1]
    return layers


def resnet_blocks(blocks):
    """[(prefix, cin, planes, stride, downsample)] of the bottlenecks."""
    out, cin = [], 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512), blocks)):
        for bi in range(n):
            stride = 2 if li > 0 and bi == 0 else 1
            down = bi == 0 and (stride != 1 or cin != planes * 4)
            out.append(("features.%d.%d" % (li + 4, bi), cin, planes,
                        stride, down))
            cin = planes * 4
    return out


def _bn_shapes(prefix, c):
    return [(prefix + "." + name, (c,), "bn_" + name)
            for name in ("weight", "bias", "running_mean", "running_var")]


def param_shapes(arch, cfg):
    """[(name, shape, kind)] of every tensor of the net, GeM's p last.
    ``kind`` says how the draw scales it."""
    shapes = []
    if arch == "vgg":
        for layer in vgg_layers(cfg):
            if layer[0] == "conv":
                _, idx, cin, cout = layer
                shapes.append(("features.%d.weight" % idx, (cout, cin, 3, 3),
                               "conv"))
                shapes.append(("features.%d.bias" % idx, (cout,), "bias"))
    elif arch == "resnet":
        shapes.append(("features.0.weight", (64, 3, 7, 7), "conv"))
        shapes += _bn_shapes("features.1", 64)
        for prefix, cin, planes, _, down in resnet_blocks(cfg):
            shapes.append((prefix + ".conv1.weight", (planes, cin, 1, 1),
                           "conv"))
            shapes += _bn_shapes(prefix + ".bn1", planes)
            shapes.append((prefix + ".conv2.weight", (planes, planes, 3, 3),
                           "conv"))
            shapes += _bn_shapes(prefix + ".bn2", planes)
            shapes.append((prefix + ".conv3.weight", (planes * 4, planes, 1,
                                                      1), "conv"))
            shapes += [(n, s, "last_" + k if k == "bn_weight" else k)
                       for n, s, k in _bn_shapes(prefix + ".bn3",
                                                 planes * 4)]
            if down:
                shapes.append((prefix + ".downsample.0.weight",
                               (planes * 4, cin, 1, 1), "conv"))
                shapes += _bn_shapes(prefix + ".downsample.1", planes * 4)
    else:
        raise ValueError("unknown trunk %r" % arch)
    shapes.append(("pool.p", (1,), "gem_p"))
    return shapes


def buffer_names(arch, cfg):
    """The tensors that are statistics, not parameters (BatchNorm's running
    mean and variance)."""
    return {name for name, _, kind in param_shapes(arch, cfg)
            if kind.startswith("bn_running")}


def draw_params(arch, cfg, generator, device, gem_p=3.0):
    """The net's tensors from one normal draw of ``generator`` on
    ``device``: convolutions He-normal (std sqrt(2 / fan_in)), biases and
    BatchNorm shifts small, BatchNorm scales near 1 (the last of each
    bottleneck near 0.2, so the residual sum stays bounded over 33 blocks),
    running variances in [0.9, 1.1]; GeM's p is ``gem_p``."""
    shapes = param_shapes(arch, cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=generator, device=device)
    params, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        z = flat[at:at + n].reshape(shape)
        at += n
        if kind == "conv":
            v = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind in ("bias", "bn_bias", "bn_running_mean"):
            v = 0.05 * z
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * z
        elif kind == "last_bn_weight":
            v = 0.2 + 0.05 * z
        elif kind == "bn_running_var":
            v = 1.0 + 0.1 * torch.tanh(z)
        else:  # gem_p
            v = torch.full(shape, gem_p, device=device)
        params[name] = v.contiguous()
    return params


def _bn(x, params, prefix):
    return F.batch_norm(x, params[prefix + ".running_mean"],
                        params[prefix + ".running_var"],
                        params[prefix + ".weight"], params[prefix + ".bias"],
                        training=False, eps=BN_EPS)


def features(arch, cfg, params, x):
    """(1, 3, H, W) normalised image -> (1, C, h, w) trunk output."""
    if arch == "vgg":
        for layer in vgg_layers(cfg):
            if layer[0] == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                idx = layer[1]
                x = F.relu(F.conv2d(x, params["features.%d.weight" % idx],
                                    params["features.%d.bias" % idx],
                                    padding=1))
        return x
    x = F.conv2d(x, params["features.0.weight"], stride=2, padding=3)
    x = F.relu(_bn(x, params, "features.1"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for prefix, _, _, stride, down in resnet_blocks(cfg):
        out = F.relu(_bn(F.conv2d(x, params[prefix + ".conv1.weight"]),
                         params, prefix + ".bn1"))
        out = F.relu(_bn(F.conv2d(out, params[prefix + ".conv2.weight"],
                                  stride=stride, padding=1),
                         params, prefix + ".bn2"))
        out = _bn(F.conv2d(out, params[prefix + ".conv3.weight"]),
                  params, prefix + ".bn3")
        if down:
            x = _bn(F.conv2d(x, params[prefix + ".downsample.0.weight"],
                             stride=stride), params, prefix + ".downsample.1")
        x = F.relu(out + x)
    return x


def _out(size, kernel, stride, padding):
    return (size + 2 * padding - kernel) // stride + 1


def feature_hw(arch, cfg, hw):
    """The trunk's output (h, w) for an (H, W) input."""
    h, w = hw
    if arch == "vgg":
        for layer in vgg_layers(cfg):
            if layer[0] == "pool":
                h, w = _out(h, 2, 2, 0), _out(w, 2, 2, 0)
        return h, w
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    for _, _, _, stride, _ in resnet_blocks(cfg):
        h, w = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
    return h, w


def out_channels(arch, cfg):
    if arch == "vgg":
        return [v for v in cfg if v != "M"][-1]
    return 2048
