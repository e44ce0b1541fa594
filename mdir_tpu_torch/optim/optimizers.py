"""Optimizers over a network's labelled parameter groups, on ``torch.optim``.

The surface of ``mdir_tpu/optim/optimizers.py``: sgd and adam with torch's
coupled weight decay (``wd * p`` added to the gradient, which is what the
JAX package's optax chain computes), one param group per label of
``Network.parameters`` with per-group options (CirNetwork's pool ``p`` gets
10x the learning rate and no weight decay), and a learning-rate factor that
the epoch schedulers set.

A ``SequentialNetwork`` trains under ``composition: alternation``
(``OptimizerAlternation``, JAX ``optimizers.py:162-258``): one optimizer per
member, a member whose optimizer is ``null`` frozen; with
``alternate_iteration`` N the members step in turn (in ``order``), N steps
each, else all at once. Its state keeps each member's optimizer state and
the ``alternation`` counters.
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


def initialize_base_optimizer(net_parameters, params):
    params = dict(params)
    algorithm = params.pop("algorithm")
    return BASE_OPTIMIZERS[algorithm](net_parameters, **params)


class OptimizerAlternation:
    """Per-member optimizers with optional step alternation (GAN-style)."""

    def __init__(self, optimizers, alternate_iteration, order):
        if len(optimizers) == 1:
            if alternate_iteration is not None:
                raise ValueError("one optimizer does not alternate")
            self.names = list(optimizers.keys())
            self.optimizers = list(optimizers.values())
        else:
            if alternate_iteration is None:
                raise ValueError("optimizers of several members need an "
                                 "alternate_iteration and an order")
            order = order.split(",")
            if optimizers.keys() != set(order):
                raise ValueError("order %s against optimizers %s"
                                 % (order, sorted(optimizers)))
            self.names = order
            self.optimizers = [optimizers[x] for x in order]
        self.alternate_iteration = alternate_iteration
        self.current_iteration = 0
        self.current_optimizer = 0

    def __iter__(self):
        return iter(self.names)

    def __getitem__(self, key):
        return self.optimizers[self.names.index(key)]

    def zero_grad(self):
        for opt in self.optimizers:
            opt.zero_grad()

    def active_names(self):
        """Members whose optimizer steps at the next ``step``."""
        if self.alternate_iteration:
            return [self.names[self.current_optimizer]]
        return list(self.names)

    def step(self):
        """Step the active optimizer(s), then move the counters."""
        self.current_iteration += 1
        if self.alternate_iteration:
            self.optimizers[self.current_optimizer].step()
            if self.current_iteration % self.alternate_iteration == 0:
                self.current_optimizer = (self.current_optimizer + 1) \
                    % len(self.optimizers)
        else:
            for opt in self.optimizers:
                opt.step()

    def set_lr_factor(self, factor):
        for opt in self.optimizers:
            opt.set_lr_factor(factor)

    def state_dict(self):
        state = {name: opt.state_dict()
                 for name, opt in zip(self.names, self.optimizers)}
        state["alternation"] = {"iteration": self.current_iteration,
                                "optimizer": self.current_optimizer}
        return state

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        alternation = state_dict.pop("alternation")
        self.current_iteration = alternation["iteration"]
        self.current_optimizer = alternation["optimizer"]
        if state_dict.keys() != set(self.names):
            raise ValueError("optimizer states of %s for members %s"
                             % (sorted(state_dict), self.names))
        for name, opt in zip(self.names, self.optimizers):
            opt.load_state_dict(state_dict[name])


OPTIMIZER_COMPOSITIONS = {
    "alternation": OptimizerAlternation,
}


def initialize_optimizer_composition(network, params):
    """One optimizer per member section; a ``null`` section freezes the
    member."""
    composition = dict(params.pop("composition"))
    comp_cls = OPTIMIZER_COMPOSITIONS[composition.pop("type")]
    acc = {}
    for net in list(params.keys()):
        if params[net] is not None:
            acc[net] = initialize_base_optimizer(
                network.parameters(params[net], net), params[net])
        else:
            network.freeze(net)
    return comp_cls(acc, **composition)


def initialize_optimizer(network, params):
    if not params:
        return None
    params = dict(params)
    if "composition" in params:
        return initialize_optimizer_composition(network, params)
    return initialize_base_optimizer(network.parameters(params), params)
