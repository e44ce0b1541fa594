"""Network abstraction of the eval path: a model, its runtime (wrappers, data
defaults, frozen flag) and stage switching.

The checkpoint schema is the JAX package's single-net payload
``{"net": {type, frozen, network_params, model_state}}``. ``model_state``
is either the JAX package's flax variables (mapped by
``models.convert.from_jax_variables``) or a torch state dict in cirtorch
names (loaded as it is). ``CirNetwork`` injects the model's mean/std as data
defaults. Descriptor models keep the reference's D x N output convention at
``__call__``. Training, freezing of subnets and the 2-net composition come
with later slices.
"""
import copy
from collections import namedtuple

import numpy as np
import torch

from .. import models as models_lib
from ..device import resolve_device
from ..models.convert import from_jax_variables
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

    def eval(self):
        self.stage = EVAL
        return self

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
    def initialize_from_state(cls, state_dict, device="cuda", runtime=None):
        """Network from a checkpoint payload on ``device``."""
        device = resolve_device(device)
        payload = state_dict["net"]
        if state_dict.keys() != {"net"} or payload.keys() != {
                "type", "frozen", "network_params", "model_state"}:
            raise ValueError("not a single-network checkpoint: %s / %s"
                             % (list(state_dict), list(payload)))
        if payload["type"] != cls.__name__:
            raise ValueError("checkpoint holds a %s, not a %s"
                             % (payload["type"], cls.__name__))
        spec = cls.NetworkParams(**payload["network_params"])
        model = models_lib.initialize_model(copy.deepcopy(spec.model),
                                            device=device)
        _restore_weights(model, payload["model_state"])
        if runtime:
            spec.runtime.update(runtime)
        return cls(model, spec, frozen=payload["frozen"])

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
    """Retrieval network: injects the model's mean/std as data defaults."""

    def __init__(self, model, network_params, frozen=False):
        data_defaults = network_params.runtime.setdefault("data", {})
        data_defaults.setdefault("mean_std",
                                 [model.meta["mean"], model.meta["std"]])
        super().__init__(model, network_params, frozen)


NETWORKS = {
    "SingleNetwork": SingleNetwork,
    "CirNetwork": CirNetwork,
}


def initialize_network(state, device="cuda", runtime=None):
    """Network from a checkpoint state (``{"net": payload}``)."""
    cls = NETWORKS[state["net"]["type"]]
    return cls.initialize_from_state(state, device, runtime=runtime)
