"""Network abstraction: a model, its runtime (wrappers, data defaults,
frozen flag), stage switching, trainable parameter groups and the
checkpoint payload.

The checkpoint schema is the JAX package's single-net payload
``{"net": {type, frozen, network_params, model_state}}``. ``model_state``
is read as the JAX package's flax variables (mapped by
``models.convert.from_jax_variables``) or as a torch state dict in cirtorch
names; the port writes the latter. A network is built from scratch
(``model`` + ``initialize``), from a checkpoint ``path`` (its runtime may
defer to the checkpoint's with ``load_from_checkpoint``), or from a training
checkpoint on resume. ``CirNetwork`` injects the model's mean/std as data
defaults and puts GeM's ``p`` in a ``pool`` parameter group with 10x the
learning rate and no weight decay. Descriptor models keep the reference's
D x N output convention at ``__call__``. A retrieval trunk's BatchNorm stays
frozen in training; a U-Net's is live in train mode (``models/layers.py``).
``train_data`` gives the weight-histogram rows of the training's event log
and ``const_data`` the network's graph, as the JAX package's.

``SequentialNetwork`` composes two networks (a U-Net translator, then an
embedder) and presents them as one: the tail's wrappers move up to the
composition, the head's data defaults become its defaults, and its
checkpoint is the JAX package's multi-net payload (each member's payload
under its name, a ``net`` header with ``sequence`` and
``network_hierarchy``). In training (JAX ``network.py:420-448``) its
``train()`` puts each member that is not frozen in train mode,
``freeze(name)`` freezes one member (an ``optimizer: <name>: null`` in the
scenario does so), and ``parameters(opts, name)`` gives one member's
groups for its optimizer (``optim/optimizers.py::OptimizerAlternation``).
"""
import copy
import time
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from .. import models as models_lib
from ..device import resolve_device
from ..models import torch_import, weight_init
from ..models.convert import from_jax_variables
from .checkpoints import Checkpoints
from .resume import require
from .wrappers import initialize_wrappers

TRAIN, EVAL = "train", "eval"
_RUNTIME_KEYS = {"data", "wrappers", "frozen", "compute_dtype", "pallas",
                 "param_sharding"}
_DATA_KEYS = {"mean_std", "transforms"}


def _build_stage_wrappers(spec):
    """Per-stage wrapper Composes from one spec or a {train, eval} pair."""
    if isinstance(spec, dict):
        assert spec.keys() == {TRAIN, EVAL}, spec.keys()
        return {stage: initialize_wrappers(spec[stage]) for stage in spec}
    return {stage: initialize_wrappers(spec) for stage in (TRAIN, EVAL)}


def _inherit_runtime(requested, stored):
    """Resolve ``load_from_checkpoint``: the whole runtime section, or single
    keys of it, may defer to the checkpoint's values."""
    if requested == "load_from_checkpoint":
        return stored
    return {key: stored[key] if value == "load_from_checkpoint" else value
            for key, value in requested.items()}


def _image_batch(image, device):
    """Images for the per-image path as float NCHW tensors on ``device``:
    an HWC array (the host transform's output) as (1, C, H, W), an NHWC
    array (a loader's stacked batch) as (N, C, H, W), a 4-d NCHW tensor
    passed on between networks as it is, and a list (a tuple batch) item by
    item."""
    if isinstance(image, list):
        return [_image_batch(item, device) for item in image]
    if torch.is_tensor(image) and image.dim() == 4:
        return image.to(device)
    x = torch.as_tensor(np.asarray(image, np.float32), device=device)
    if x.dim() == 4:
        return x.permute(0, 3, 1, 2).contiguous()
    return x.permute(2, 0, 1)[None].contiguous()


def _restored_model(model_params, model_state, device):
    """The model of ``model_params`` with ``model_state`` (flax variables or
    a torch state dict) loaded. The strict load sets every weight, so the
    model is built without its seeded draw and without its ``pretrained``
    trunk features: a checkpoint of a net fine-tuned from them loads
    without the features file."""
    model_params = dict(model_params)
    if "pretrained" in model_params:
        model_params["pretrained"] = False
    model = models_lib.initialize_model(model_params, device=device,
                                        seed=None)
    return _restore_weights(model, model_state)


def _restore_weights(model, model_state):
    """Load ``model_state`` (flax variables or a torch state dict)."""
    if set(model_state.keys()) & {"params", "batch_stats"}:
        model_state = from_jax_variables(model_state)
    return torch_import.import_model_state(model, model_state)


def generate_network_graph(models):
    """The models' module summaries (``str(module)``) drawn as one image
    blob with PIL, or None where PIL is not importable (the card's machine)
    or cannot draw it: a debug image, as the JAX package's ``nn.tabulate``
    render, which returns None on any failure."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return None
    try:
        lines = "\n".join(str(model) for model in models).split("\n")[:200]
        width = min(max(len(line) for line in lines) * 7 + 20, 1600)
        img = Image.new("RGB", (width, len(lines) * 12 + 20), "white")
        draw = ImageDraw.Draw(img)
        for i, line in enumerate(lines):
            draw.text((10, 10 + i * 12), line, fill="black")
        return np.asarray(img)
    except (OSError, ValueError):  # no default font, an image too large
        return None


def graph_rows(models):
    """The constant rows of the event log: the graph's blob, if drawn."""
    graph = generate_network_graph(models)
    if graph is None:
        return []
    return [{"key": "network_graph", "dtype": "blob",
             "data": {"net": {"dtype": "image:rgb", "data": graph}}}]


class SingleNetwork:
    """One model + its runtime (wrappers, data defaults, frozen flag)."""

    NetworkParams = namedtuple("NetworkParams", ["model", "runtime"])

    def __init__(self, model, network_params, frozen=False):
        runtime = network_params.runtime
        unknown = runtime.keys() - _RUNTIME_KEYS
        assert not unknown, unknown
        data_unknown = runtime.get("data", {}).keys() - _DATA_KEYS
        assert not data_unknown, runtime.get("data", {}).keys()
        self.model = model
        self.meta = {side: model.meta.get(side)
                     for side in ("in_channels", "out_channels")}
        self.network_params = network_params
        self.wrappers = _build_stage_wrappers(runtime.get("wrappers", ""))
        self.frozen = runtime.get("frozen", False) or frozen
        self.stage = None
        if self.frozen:
            self.eval()

    @property
    def device(self):
        return self.model.device

    def train(self):
        """The train stage and the model's train mode (a frozen network
        stays in eval): a U-Net's BatchNorm is then live and its Dropout
        drops; a retrieval trunk's BatchNorm keeps its running statistics."""
        if not self.frozen:
            self.stage = TRAIN
            self.model.train()
        return self

    def eval(self):
        self.stage = EVAL
        self.model.eval()
        return self

    def freeze(self, net="net"):
        assert net == "net", net
        self.frozen = True
        return self.eval()

    def trainables(self):
        """The parameters the optimizer steps: none when frozen."""
        return [] if self.frozen else list(self.model.parameters())

    def parameters(self, _optimizer_opts, net="net"):
        """Trainable parameters for the optimizer (None when frozen):
        ``{"params": {name: param}, "labels": {name: group}, "opts":
        {group: {lr_multiplier, weight_decay}}}``."""
        assert net == "net", net
        if self.frozen:
            return None
        params = OrderedDict(self.model.named_parameters())
        return {"params": params, "labels": dict.fromkeys(params, "default"),
                "opts": {}}

    # --- debug / observability ---------------------------------------------

    def train_data(self):
        """The weight-histogram rows (JAX ``network.py:145-147``): every
        parameter under its name, on its device (the broker counts there)."""
        return [{"key": "net/params", "dtype": "weight/param",
                 "data": {name: p.detach() for name, p
                          in self.model.named_parameters()}}]

    def const_data(self):
        return graph_rows([self.model])

    # --- inference ---------------------------------------------------------

    @torch.no_grad()
    def inference(self, image):
        """Model on one (1, C, H, W) image: descriptors as (D, 1) columns,
        images as they come."""
        out = self.model(image)
        return out.T if "pooling" in self.model.meta else out

    def __call__(self, image):
        """One image (HWC array, or NCHW tensor) through the stage's
        wrappers."""
        return self.wrappers[self.stage](_image_batch(image, self.device),
                                         self.inference, self.model)

    # --- construction ------------------------------------------------------

    @classmethod
    def initialize(cls, params, device="cuda"):
        """A trainable network from its scenario section: from a checkpoint
        ``path``, else from ``model`` and ``initialize``."""
        device = resolve_device(device)
        path = params.pop("path", None)
        model, spec = cls._from_pretrained(path, params, device) if path \
            else cls._from_scratch(params, device)
        assert not params, params.keys()
        return cls(model, spec)

    @classmethod
    def _from_scratch(cls, params, device):
        spec = cls.NetworkParams(params.pop("model"), params.pop("runtime"))
        init = params.pop("initialize")
        seed = init["seed"] if init else None
        model = models_lib.initialize_model(copy.deepcopy(spec.model),
                                            device=device, seed=seed or 0)
        if init and init["weights"] != "default":
            weight_init.initialize_weights(
                model, init["weights"],
                seed if seed is not None else int(time.time()))
        return model, spec

    @classmethod
    def _from_pretrained(cls, path, params, device):
        print(">> Loaded net from %s" % path)
        checkpoint = Checkpoints.load_network(path)["net"]
        stored = checkpoint["network_params"]
        runtime = _inherit_runtime(params.pop("runtime"), stored["runtime"])
        spec = cls.NetworkParams(stored["model"], runtime)
        model = _restored_model(spec.model, checkpoint["model_state"], device)
        params.pop("initialize", None)
        if "model" in params:
            require(params.pop("model") == stored["model"], "model",
                    stored["model"], "the scenario's")
        return model, spec

    @classmethod
    def initialize_from_state(cls, state_dict, device="cuda", params=None,
                              runtime=None):
        """Network from a checkpoint payload on ``device``. With the
        scenario's ``params`` of a network built from scratch, the
        checkpoint's spec must match them (resume consistency)."""
        device = resolve_device(device)
        payload = state_dict["net"]
        if state_dict.keys() != {"net"} or payload.keys() != {
                "type", "frozen", "network_params", "model_state"}:
            raise ValueError("not a single-network checkpoint: %s / %s"
                             % (list(state_dict), list(payload)))
        if payload["type"] != cls.__name__:
            raise ValueError("checkpoint holds a %s, not a %s"
                             % (payload["type"], cls.__name__))
        spec = cls.NetworkParams(**copy.deepcopy(payload["network_params"]))
        model = _restored_model(spec.model, payload["model_state"], device)
        if params is not None and not params.get("path"):
            declared = {k: v for k, v in params.items()
                        if k not in ("path", "initialize", "type")}
            cls._canonicalize_resume_params(declared, model)
            require(spec._asdict() == declared, "network params",
                    spec._asdict(), declared)
        if runtime:
            spec.runtime.update(runtime)
        return cls(model, spec, frozen=payload["frozen"])

    @classmethod
    def _canonicalize_resume_params(cls, params, model):
        """The defaulting ``__init__`` applies to a fresh spec, so that the
        resume check compares like with like."""

    def state_dict(self):
        """The checkpoint payload, weights as CPU tensors."""
        return {"net": {
            "type": type(self).__name__,
            "frozen": self.frozen,
            "network_params": copy.deepcopy(self.network_params._asdict()),
            "model_state": OrderedDict(
                (k, v.detach().cpu().clone())
                for k, v in self.model.state_dict().items())}}

    def overlay_params(self, new_params):
        """A frozen copy under a different runtime (validation overlays)."""
        if not new_params:
            return self
        new_params["runtime"]["frozen"] = True
        overlaid = self.NetworkParams(self.network_params.model,
                                      new_params.pop("runtime"))
        assert not new_params
        return type(self)(self.model, overlaid, frozen=True)


class CirNetwork(SingleNetwork):
    """Retrieval network: the model's mean/std as data defaults, and GeM's
    ``p`` in its own optimizer group (10x lr, no weight decay; reference
    ``network.py:392-428``)."""

    def __init__(self, model, network_params, frozen=False):
        data_defaults = network_params.runtime.setdefault("data", {})
        data_defaults.setdefault("mean_std",
                                 [model.meta["mean"], model.meta["std"]])
        super().__init__(model, network_params, frozen)

    @classmethod
    def _canonicalize_resume_params(cls, params, model):
        runtime = dict(params.get("runtime") or {})
        data = dict(runtime.get("data") or {})
        data.setdefault("mean_std", [model.meta["mean"], model.meta["std"]])
        runtime["data"] = data
        params["runtime"] = runtime

    def parameters(self, optimizer_opts, net="net"):
        groups = super().parameters(optimizer_opts, net)
        if groups is not None:
            for name in groups["labels"]:
                # GeM's p (``pool.p``, Rpool's ``pool.rpool.p``); Rpool's
                # whitening stays default, as the JAX package's
                # ``pool_whiten`` scope does
                if name.split(".")[0] == "pool" \
                        and not name.startswith("pool.whiten."):
                    groups["labels"][name] = "pool"
            groups["opts"] = {"pool": {"lr_multiplier": 10.0,
                                       "weight_decay": 0.0}}
        return groups


# --- sequential composition -------------------------------------------------

def _flatten_substates(networks, sequence):
    """Members' payloads, each keyed by its name, and the hierarchy map of
    any nested entries they carry (already prefixed)."""
    flat, hierarchy = {}, {}
    for name in sequence:
        substate = networks[name].state_dict()
        substate[name] = substate.pop("net")
        clash = set(flat) & set(substate)
        if clash:
            raise ValueError("member states collide on %s" % sorted(clash))
        hierarchy[name] = [key for key in substate if key != name]
        flat.update(substate)
    return flat, hierarchy


def _nest_substates(flat, hierarchy, name):
    """Inverse of ``_flatten_substates`` for one member."""
    nested = {key: flat[key] for key in hierarchy[name]}
    nested["net"] = flat[name]
    return nested


def _route_runtime_overrides(runtime, sequence):
    """A composition's runtime per member: wrappers and the compute keys
    (compute_dtype, pallas, param_sharding) to the tail, data defaults to
    the head. Pops what it routes from ``runtime``."""
    routed = {name: None for name in sequence}
    if runtime and "wrappers" in runtime:
        routed[sequence[-1]] = {"wrappers": runtime.pop("wrappers")}
    if runtime and "data" in runtime:
        routed[sequence[0]] = {"data": runtime.pop("data")}
    for key in ("compute_dtype", "pallas", "param_sharding"):
        if runtime and key in runtime:
            tail = routed[sequence[-1]] or {}
            tail[key] = runtime.pop(key)
            routed[sequence[-1]] = tail
    if runtime:
        raise ValueError("a composition's runtime takes wrappers, data, "
                         "compute_dtype, pallas and param_sharding, not %s"
                         % sorted(runtime))
    return routed


class SequentialNetwork:
    """A 2-net pipeline (a U-Net translator, then an embedder).

    The composition presents itself as one network: the tail's wrappers
    move up to the composition (the member keeps none), the head's data
    defaults become the composition's, and the channels must match at the
    junction. Its ``model`` is the tail's (the multiscale wrapper reads its
    GeM p from it).
    """

    NetworkParams = namedtuple("NetworkParams", ["runtime"])

    def __init__(self, networks, sequence, frozen=False):
        if len(networks) != 2 or set(networks) != set(sequence):
            raise ValueError("a composition is two networks in sequence, "
                             "got %s for %s" % (sorted(networks), sequence))
        self.sequence = list(sequence)
        self.networks = networks
        head = networks[self.sequence[0]]
        tail = networks[self.sequence[-1]]
        self.model = tail.model
        self.wrappers, tail.wrappers = \
            tail.wrappers, _build_stage_wrappers("")
        self.network_params = self.NetworkParams(
            {"wrappers": tail.network_params.runtime.get("wrappers"),
             "data": head.network_params.runtime.get("data"),
             "param_sharding":
                 tail.network_params.runtime.get("param_sharding")})
        if head.meta["out_channels"] != tail.meta["in_channels"]:
            raise ValueError("%s gives %s channels, %s takes %s"
                             % (self.sequence[0], head.meta["out_channels"],
                                self.sequence[-1], tail.meta["in_channels"]))
        self.meta = {"in_channels": head.meta["in_channels"],
                     "out_channels": tail.meta["out_channels"]}
        self.frozen = frozen
        self.stage = None
        if frozen:
            self.eval()

    @property
    def device(self):
        return self.model.device

    def __getitem__(self, key):
        return self.networks[key]

    def __call__(self, image):
        """One image (HWC array, or NCHW tensor) through the composition's
        wrappers around ``forward``."""
        return self.wrappers[self.stage](_image_batch(image, self.device),
                                         self.forward, self.model)

    def forward(self, image):
        """Each member on the image in turn, with its own wrappers."""
        for name in self.sequence:
            image = self.networks[name](image)
        return image

    def train(self):
        """Each member that is not frozen in train mode; a frozen
        composition stays in eval."""
        if not self.frozen:
            for name in self.sequence:
                self.networks[name].train()
            self.stage = TRAIN
        return self

    def eval(self):
        for name in self.sequence:
            self.networks[name].eval()
        self.stage = EVAL
        return self

    def freeze(self, net=None):
        """Freeze member ``net``, or every member and the composition."""
        if net is not None:
            self.networks[net].freeze()
            return self
        for name in self.sequence:
            self.networks[name].freeze()
        self.frozen = True
        self.stage = EVAL
        return self

    def trainables(self):
        """The parameters of the members that are not frozen."""
        return [p for name in self.sequence
                for p in self.networks[name].trainables()]

    def parameters(self, optimizer_opts, net=None):
        """Member ``net``'s groups, or ``{member: groups}`` of the members
        that are not frozen."""
        if net is not None:
            return self.networks[net].parameters(optimizer_opts)
        reported = ((name, self.networks[name].parameters(optimizer_opts))
                    for name in self.sequence)
        return {name: groups for name, groups in reported
                if groups is not None}

    def train_data(self):
        """Each member's weight rows, keyed by the member's name (JAX
        ``network.py:539-545``)."""
        return [{**row, "key": row["key"].replace("net/", name + "/")}
                for name in self.sequence
                for row in self.networks[name].train_data()]

    def const_data(self):
        return graph_rows([self.networks[name].model
                           for name in self.sequence])

    @classmethod
    def initialize(cls, params, device="cuda"):
        """A composition from its scenario section: ``sequence``, an
        optional composition-level ``runtime`` (routed to the members), and
        one section per member."""
        device = resolve_device(device)
        sequence = params.pop("sequence").split(",")
        routed = _route_runtime_overrides(params.pop("runtime", None),
                                          sequence)
        for name, overrides in routed.items():
            if overrides:
                params[name].setdefault("runtime", {}).update(overrides)
        built = {name: NETWORKS[spec.pop("type")].initialize(spec, device)
                 for name, spec in params.items()}
        return cls(built, sequence)

    def overlay_params(self, new_params):
        """A frozen copy with members' runtimes overlaid. A falsy member
        entry keeps the member; the tail then keeps the composition's live
        wrappers, which ``__init__`` moved up."""
        if not new_params:
            return self
        missing = set(self.sequence) - set(new_params)
        if missing:
            raise ValueError("an overlay names every member; missing %s"
                             % sorted(missing))
        overlaid = {}
        for name in self.sequence:
            sub = self.networks[name]
            if new_params.get(name):
                overlaid[name] = sub.overlay_params(new_params[name])
            else:
                sub = copy.copy(sub)
                if name == self.sequence[-1]:
                    sub.wrappers = dict(self.wrappers)
                overlaid[name] = sub
        return type(self)(overlaid, self.sequence, frozen=True)

    def state_dict(self):
        """The multi-net payload: each member's under its name and the
        ``net`` header."""
        flat, hierarchy = _flatten_substates(self.networks, self.sequence)
        flat["net"] = {"type": type(self).__name__,
                       "frozen": self.frozen,
                       "sequence": list(self.sequence),
                       "network_hierarchy": hierarchy}
        return flat

    @classmethod
    def initialize_from_state(cls, state_dict, device="cuda", params=None,
                              runtime=None):
        """A composition from its multi-net payload (``runtime`` routed to
        the members). With the scenario's ``params`` the sequence and each
        member's spec must match the checkpoint's."""
        device = resolve_device(device)
        state_dict = dict(state_dict)
        header = state_dict.pop("net")
        if header.get("type") != cls.__name__ or header.keys() != {
                "type", "frozen", "sequence", "network_hierarchy"}:
            raise ValueError("not a %s header: %s"
                             % (cls.__name__, sorted(header)))
        sequence = list(header["sequence"])
        hierarchy = header["network_hierarchy"]
        if set(sequence) != set(hierarchy):
            raise ValueError("sequence %s against hierarchy %s"
                             % (sequence, sorted(hierarchy)))
        routed = _route_runtime_overrides(copy.deepcopy(runtime), sequence)
        if params is not None:
            declared = params["sequence"].split(",")
            require(sequence == declared, "sequence", sequence, declared)
            yaml_routed = _route_runtime_overrides(
                copy.deepcopy(params.get("runtime")), sequence)
            for name, overrides in yaml_routed.items():
                if overrides:
                    params[name].setdefault("runtime", {}).update(overrides)

        restored = {}
        for name in hierarchy:
            member = _nest_substates(state_dict, hierarchy, name)
            netparams = None
            if params is not None:
                netparams = params[name]
                declared_type = netparams.pop("type", None)
                require(declared_type in (None, member["net"]["type"]),
                        "%s type" % name, member["net"]["type"],
                        declared_type)
            restored[name] = NETWORKS[member["net"]["type"]] \
                .initialize_from_state(member, device, netparams,
                                       routed[name])
        return cls(restored, sequence, frozen=header["frozen"])


NETWORKS = {
    "SingleNetwork": SingleNetwork,
    "SequentialNetwork": SequentialNetwork,
    "CirNetwork": CirNetwork,
}


def initialize_network(params, device="cuda", state=None, runtime=None):
    """Network from its scenario section ``params``, or from a checkpoint
    ``state`` (``{"net": payload}``; ``params`` then checks it)."""
    label = params.pop("type") if params else state["net"]["type"]
    if label not in NETWORKS:
        raise NotImplementedError("network %r is not ported yet (ROADMAP "
                                  "§1.7)" % label)
    cls = NETWORKS[label]
    if state:
        return cls.initialize_from_state(state, device, params, runtime)
    return cls.initialize(params, device)
