"""The branched retrieval net (``cirnet_branched``): the trunk split at its
Nth conv into branches, one per group of input channels (an RGB image and
its equalized lightness, say), merged by sum or concat -- the port of
``mdir_tpu/models/branched.py`` (reference ``mdir/components/model/network/
cirnet.py:25-116``), in NCHW.

Each branch runs the pre-split stack of an AlexNet or VGG trunk on its slice
of the input channels (``branches.<name>``, a ``SequentialFeatures`` with
the branch's channel count), scaled by its weight; the merged map runs the
shared post stack (``features``, its first conv widened to take every
branch's channels under ``concat``), then the global head of the port's
other nets: GeM (``GeMPoolL2N``, the ``gem_l2n`` kernel in eval and its
plain version under autograd; the JAX package pools with a separate GeM and
L2N, within GeM's 1e-5), MAC or SPoC, L2N, and optionally ``whiten`` and
L2N. Each branch masks by its valid extent; the branches share one.

``merge.layer: 0`` builds one plain ``ImageRetrievalNet`` instead, its first
conv taking all the branches' channels (``build_input_merged``).

The forward has no ``head_dtype`` seam, as the JAX module has none, so a
training step keeps this net in float32 under ``auto``
(``learning/train_step.py::_bf16_trainable``); extraction under ``auto``
casts the whole net behind the extraction guard (``ops/dtypes.py``).

A ``whitening`` given as a string is only a flag here (``bool(whitening)``),
as in the JAX package: no pkl is loaded into ``whiten``. ``pretrained:
true`` sets each branch's first conv from the caffe features by ``clone``
(3 channels) or ``sum`` (1 channel) over their input axis, and a ``concat``
merge tiles the first post conv
(``torch_import.init_branched_from_pretrained``).
"""
import torch
import torch.nn as nn

from .retrievalnet import GeMPoolL2N, ImageRetrievalNet, global_pool, \
    whiten_l2n
from .trunks import ALEXNET_SPEC, OUTPUT_DIM, VGG_CFGS, SequentialFeatures, \
    _vgg_spec

MEAN_STD = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])


def split_spec_at_conv(spec, layer):
    """Split a Sequential spec before its ``layer``-th conv (0-based)."""
    conv_positions = [i for i, item in enumerate(spec) if item[0] == "conv"]
    split = conv_positions[layer]
    return tuple(spec[:split]), tuple(spec[split:])


def trunk_spec(architecture):
    if architecture == "alexnet":
        return ALEXNET_SPEC
    if architecture in VGG_CFGS:
        return _vgg_spec(VGG_CFGS[architecture])
    raise ValueError(
        "cirnet_branched supports sequential trunks (alexnet/vgg*), got %s"
        % architecture)


def _spec_out_channels(spec):
    return [item[2] for item in spec if item[0] == "conv"][-1]


class BranchedRetrievalNet(nn.Module):
    """Branches -> merge -> post trunk -> pool -> L2N -> (whiten) -> L2N.

    ``branches`` is a tuple of (name, in_channels, weight)."""

    def __init__(self, architecture="vgg16", branches=(), merge_layer=3,
                 merge_aggregation="sum", pooling="gem", whitening=False,
                 p_init=3.0):
        super().__init__()
        if merge_aggregation not in ("sum", "concat"):
            raise ValueError(merge_aggregation)
        if pooling not in ("gem", "mac", "spoc"):
            raise ValueError(pooling)
        dim = OUTPUT_DIM[architecture]
        pre, post = split_spec_at_conv(trunk_spec(architecture), merge_layer)
        self.architecture = architecture
        self.pooling = pooling
        self.merge_aggregation = merge_aggregation
        self.branch_specs = tuple((str(n), int(c), float(w))
                                  for n, c, w in branches)
        self.branches = nn.ModuleDict({
            name: SequentialFeatures(pre, in_channels=c)
            for name, c, _ in self.branch_specs})
        merged = _spec_out_channels(pre)
        if merge_aggregation == "concat":
            merged *= len(self.branch_specs)
        self.features = SequentialFeatures(post, in_channels=merged)
        self.pool = GeMPoolL2N(p_init) if pooling == "gem" else None
        self.whiten = nn.Linear(dim, dim) if whitening else None
        self.meta = {
            "architecture": architecture, "local_whitening": False,
            "pooling": pooling, "regional": False, "whitening": whitening,
            "mean": list(MEAN_STD[0]), "std": list(MEAN_STD[1]),
            "outputdim": dim,
            "in_channels": sum(c for _, c, _ in self.branch_specs),
            "out_channels": dim,
        }

    @property
    def pool_p(self):
        return float(self.pool.p.detach()[0])

    @property
    def needs_region_boxes(self):
        return False

    @property
    def device(self):
        return next(self.parameters()).device

    def forward(self, x, valid_hw=None):
        """x: (N, sum of the branches' channels, H, W) -> (N, D) rows;
        ``valid_hw`` (N, 2) int32 each image's extent in a padded bucket."""
        start = 0
        merged = out_valid = None
        for name, channels, weight in self.branch_specs:
            y, branch_valid = self.branches[name](
                x[:, start:start + channels], valid_hw)
            start += channels
            y = weight * y
            if merged is None:
                merged, out_valid = y, branch_valid
            elif self.merge_aggregation == "sum":
                merged = merged + y
            else:
                merged = torch.cat([merged, y], dim=1)
        o, out_valid = self.features(merged, out_valid)
        return whiten_l2n(global_pool(o, out_valid, self.pool, self.pooling),
                          self.whiten)


def _require(ok, what):
    if not ok:
        raise ValueError("cirnet_branched: %s" % (what,))


def parse_branches(channels):
    """The scenario's ``channels`` -> (merge dict, [(name, in, weight,
    init)] sorted by key), checked as the JAX factory checks them."""
    merge = dict(channels["merge"])
    _require(set(merge) == {"layer", "aggregation"}, ("merge keys", merge))
    items = []
    for key, branch in sorted(channels["branches"].items()):
        _require(set(branch) == {"in", "init", "weight"},
                 ("branch keys", key, branch))
        _require(branch["init"] in {"sum", "clone"}, ("init", branch))
        items.append((key.split("_", 1)[1], int(branch["in"]),
                      float(branch["weight"]), branch["init"]))
    return merge, items


def build_input_merged(architecture, pooling, whitening, items):
    """``merge.layer: 0``: a plain retrieval net whose first conv takes the
    branches' channels (JAX ``_build_input_merged``)."""
    model = ImageRetrievalNet(architecture=architecture, pooling=pooling,
                              whitening=bool(whitening))
    first = next(str(item[1]) for item in trunk_spec(architecture)
                 if item[0] == "conv")
    conv = model.features[first]
    channels = sum(c for _, c, _, _ in items)
    model.features[first] = nn.Conv2d(
        channels, conv.out_channels, conv.kernel_size, conv.stride,
        conv.padding, bias=conv.bias is not None)
    model.meta["whitening"] = whitening
    model.meta["in_channels"] = channels
    return model


def init_cirnet_branched(device, seed=0, **params):
    """Factory of ``MODEL_LABELS['cirnet_branched']`` (JAX
    ``init_cirnet_branched``): weights from ``seed``, then the caffe
    features with ``pretrained``."""
    from . import init_weights, torch_import

    merge, items = parse_branches(params.pop("channels"))
    architecture = params.pop("cir_architecture")
    pretrained = params.pop("pretrained")
    pooling = params.pop("pooling")
    whitening = params.pop("whitening")
    local_whitening = params.pop("local_whitening", False)
    regional = params.pop("regional", False)
    _require(not local_whitening and not regional,
             "global pooling only, as in the reference")
    _require(not params, ("unknown keys", sorted(params)))

    if merge["layer"] == 0:
        _require(merge["aggregation"] == "concat",
                 "merge.layer 0 concatenates the inputs")
        model = build_input_merged(architecture, pooling, whitening, items)
    else:
        model = BranchedRetrievalNet(
            architecture=architecture,
            branches=tuple((n, c, w) for n, c, w, _ in items),
            merge_layer=merge["layer"],
            merge_aggregation=merge["aggregation"], pooling=pooling,
            whitening=whitening)
    if seed is not None:
        init_weights(model, seed)
    if pretrained:
        torch_import.init_branched_from_pretrained(
            model, architecture, items, merge)
    return model.eval().to(device)
