"""Optimizers over a network's labelled parameter groups, on ``torch.optim``.

The surface of ``mdir_tpu/optim/optimizers.py``: sgd and adam with torch's
coupled weight decay (``wd * p`` added to the gradient, which is what the
JAX package's optax chain computes), one param group per label of
``Network.parameters`` with per-group options (CirNetwork's pool ``p`` gets
10x the learning rate and no weight decay), and a learning-rate factor that
the epoch schedulers set. The per-subnet ``composition: alternation`` of
``SequentialNetwork`` waits for the composition slice (ROADMAP §1.6).
"""
import torch

ALGORITHMS = {
    "sgd": lambda groups, momentum: torch.optim.SGD(
        groups, lr=groups[0]["lr"], momentum=momentum or 0.0),
    "adam": lambda groups, _momentum: torch.optim.Adam(
        groups, lr=groups[0]["lr"], betas=(0.9, 0.999), eps=1e-8),
}


class Optimizer:
    """A torch optimizer with one param group per label, named."""

    def __init__(self, optimizer, base_lrs, group_names):
        self.optimizer = optimizer
        self.base_lrs = base_lrs  # {group: base lr}
        self.group_names = group_names  # one per optimizer.param_groups

    @classmethod
    def create(cls, net_parameters, algorithm, lr, weight_decay,
               momentum=None):
        """``net_parameters``: ``{"params", "labels", "opts"}`` of
        ``Network.parameters`` (params and labels keyed by name)."""
        labels = net_parameters["labels"]
        opts = net_parameters["opts"]
        groups, names, base_lrs = [], [], {}
        for group in sorted({*labels.values(), "default"}):
            gopts = opts.get(group, {})
            glr = lr * gopts.get("lr_multiplier", 1.0)
            base_lrs[group] = glr
            params = [p for name, p in net_parameters["params"].items()
                      if labels[name] == group]
            if params:
                groups.append({"params": params, "lr": glr,
                               "weight_decay": gopts.get("weight_decay",
                                                         weight_decay)})
                names.append(group)
        return cls(ALGORITHMS[algorithm](groups, momentum), base_lrs, names)

    def step(self):
        self.optimizer.step()

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def set_lr_factor(self, factor):
        """Every group's lr to its base lr times ``factor`` (scheduler hook)."""
        for name, group in zip(self.group_names, self.optimizer.param_groups):
            group["lr"] = self.base_lrs[name] * factor

    @property
    def learning_rates(self):
        return {name: group["lr"] for name, group
                in zip(self.group_names, self.optimizer.param_groups)}

    def state_dict(self):
        return {"torch_state": self.optimizer.state_dict(),
                "base_lrs": dict(self.base_lrs)}

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict["torch_state"])


def init_sgd(net_parameters, lr, momentum, weight_decay):
    return Optimizer.create(net_parameters, "sgd", lr, weight_decay, momentum)


def init_adam(net_parameters, lr, weight_decay):
    return Optimizer.create(net_parameters, "adam", lr, weight_decay)


BASE_OPTIMIZERS = {
    "sgd": init_sgd,
    "adam": init_adam,
}


def initialize_optimizer(network, params):
    if not params:
        return None
    params = dict(params)
    if "composition" in params:
        raise NotImplementedError(
            "optimizer compositions (alternation) belong to the "
            "SequentialNetwork slice, ROADMAP §1.6")
    algorithm = params.pop("algorithm")
    return BASE_OPTIMIZERS[algorithm](network.parameters(params), **params)
