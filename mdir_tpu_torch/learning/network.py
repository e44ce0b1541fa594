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
D x N output convention at ``__call__``. BatchNorm stays frozen in training
(``models/layers.py``). ``SequentialNetwork`` comes with the composition
slice (ROADMAP §1.6).
"""
import copy
import time
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from .. import models as models_lib
from ..device import resolve_device
from ..models import weight_init
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


def _restore_weights(model, model_state):
    """Load ``model_state`` (flax variables or a torch state dict)."""
    keys = set(model_state.keys())
    if keys & {"params", "batch_stats"}:
        state = from_jax_variables(model_state)
    else:
        state = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                 else v for k, v in model_state.items()
                 if not k.endswith("num_batches_tracked")}
    model.load_state_dict(state, strict=True)


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
        """The train stage (a frozen network stays in eval). BatchNorm keeps
        its running statistics in both stages."""
        if not self.frozen:
            self.stage = TRAIN
            self.model.train()
        return self

    def eval(self):
        self.stage = EVAL
        self.model.eval()
        return self

    def parameters(self, _optimizer_opts):
        """Trainable parameters for the optimizer (None when frozen):
        ``{"params": {name: param}, "labels": {name: group}, "opts":
        {group: {lr_multiplier, weight_decay}}}``."""
        if self.frozen:
            return None
        params = OrderedDict(self.model.named_parameters())
        return {"params": params, "labels": dict.fromkeys(params, "default"),
                "opts": {}}

    # --- inference ---------------------------------------------------------

    @torch.no_grad()
    def inference(self, image):
        """Model on one (1, C, H, W) image: descriptors as (D, 1) columns."""
        return self.model(image).T

    def __call__(self, image):
        """One HWC image (numpy or tensor) through the stage's wrappers."""
        x = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        x = x.permute(2, 0, 1)[None].contiguous()
        return self.wrappers[self.stage](x, self.inference, self.model)

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
        model = models_lib.initialize_model(copy.deepcopy(spec.model),
                                            device=device)
        _restore_weights(model, checkpoint["model_state"])
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
        model = models_lib.initialize_model(copy.deepcopy(spec.model),
                                            device=device)
        _restore_weights(model, payload["model_state"])
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

    def parameters(self, optimizer_opts):
        groups = super().parameters(optimizer_opts)
        if groups is not None:
            for name in groups["labels"]:
                if name.split(".")[0] == "pool":
                    groups["labels"][name] = "pool"
            groups["opts"] = {"pool": {"lr_multiplier": 10.0,
                                       "weight_decay": 0.0}}
        return groups


NETWORKS = {
    "SingleNetwork": SingleNetwork,
    "CirNetwork": CirNetwork,
}


def initialize_network(params, device="cuda", state=None, runtime=None):
    """Network from its scenario section ``params``, or from a checkpoint
    ``state`` (``{"net": payload}``; ``params`` then checks it)."""
    label = params.pop("type") if params else state["net"]["type"]
    if label not in NETWORKS:
        raise NotImplementedError("network %r is not ported yet (ROADMAP "
                                  "§1.6)" % label)
    cls = NETWORKS[label]
    if state:
        return cls.initialize_from_state(state, device, params, runtime)
    return cls.initialize(params, device)
