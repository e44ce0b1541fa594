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
the ``alternation`` counters. Under ZeRO it hands the mesh to each member's
optimizer (``shard_state``, JAX ``optimizers.py:214-216``), so each keeps
its own moments sharded and its state dict in the single-card format; a
member that does not step in an iteration leaves its parameters as they
are on every rank.

Under ``param_sharding: zero`` over several cards (``shard_state``, JAX
``optimizers.py:88-107``) each rank keeps and updates only its slice of
each parameter's moments, along the dimension JAX's ``zero_shardings``
picks (``parallel/mesh.py::zero_dim``): the step reduce-scatters each
gradient along it, the torch optimizer steps the slices (the same coupled
weight decay, eps and per-group learning rates), and the new slices are
all-gathered, so every rank holds the whole parameters. A parameter with no
divisible dimension gets its gradient all-reduced and is updated whole on
every rank. ``state_dict`` gathers the moments: it is a single-card state
dict, and ``load_state_dict`` slices one again, at any world size.
"""
import torch

from ..parallel.mesh import zero_dim

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
        self.mesh = None  # set by shard_state
        self.zero = []  # (parameter, its split dimension or None, its slice)

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

    def shard_state(self, mesh):
        """Keep the moments sharded over ``mesh``'s ranks (ZeRO); the
        state so far is sliced, and the parameters stay whole."""
        full = self.optimizer.state_dict()
        self.mesh = mesh
        groups = []
        for group in self.optimizer.param_groups:
            slices = []
            for param in group["params"]:
                dim = zero_dim(tuple(param.shape), mesh.size)
                piece = param if dim is None else \
                    param.detach().movedim(dim, 0)[
                        mesh.rows(param.shape[dim])].movedim(0, dim).clone(
                            memory_format=torch.contiguous_format)
                self.zero.append((param, dim, piece))
                slices.append(piece)
            groups.append(dict(group, params=slices))
        self.optimizer = type(self.optimizer)(groups,
                                              **self.optimizer.defaults)
        self.optimizer.load_state_dict(self._sliced(full))

    def _state_tensors(self, torch_state):
        """(index, key, tensor, dim) of every moment of a split parameter,
        index as in ``torch_state["state"]``."""
        for index, (_, dim, piece) in enumerate(self.zero):
            if dim is None:
                continue
            for key, value in torch_state["state"].get(index, {}).items():
                if torch.is_tensor(value) and value.dim() == piece.dim():
                    yield index, key, value, dim

    def _sliced(self, torch_state):
        """A single-card torch state dict with this rank's moment slices."""
        state = {i: dict(entry) for i, entry in torch_state["state"].items()}
        for index, key, value, dim in self._state_tensors(torch_state):
            state[index][key] = value.movedim(dim, 0)[self.mesh.rows(
                value.shape[dim])].movedim(0, dim).clone(
                    memory_format=torch.contiguous_format)
        return {"state": state, "param_groups": torch_state["param_groups"]}

    def _gathered(self, torch_state):
        """This rank's torch state dict with every moment whole."""
        state = {i: dict(entry) for i, entry in torch_state["state"].items()}
        for index, key, value, dim in self._state_tensors(torch_state):
            state[index][key] = self.mesh.all_gather_rows(
                value.movedim(dim, 0)).movedim(0, dim).contiguous()
        return {"state": state, "param_groups": torch_state["param_groups"]}

    def step(self):
        if self.mesh is None:
            self.optimizer.step()
            return
        whole = []
        for param, dim, piece in self.zero:
            if param.grad is None:
                continue
            if dim is None:
                whole.append(param.grad)
            else:
                piece.grad = self.mesh.reduce_scatter_rows(
                    param.grad.movedim(dim, 0)).movedim(0, dim).contiguous()
        self.mesh.all_reduce(whole)
        self.optimizer.step()
        with torch.no_grad():
            for param, dim, piece in self.zero:
                if dim is not None and piece.grad is not None:
                    param.copy_(self.mesh.all_gather_rows(
                        piece.movedim(dim, 0)).movedim(0, dim))

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)
        for param, _, _ in self.zero:
            param.grad = None

    def set_lr_factor(self, factor):
        """Every group's lr to its base lr times ``factor`` (scheduler hook)."""
        for name, group in zip(self.group_names, self.optimizer.param_groups):
            group["lr"] = self.base_lrs[name] * factor

    @property
    def learning_rates(self):
        return {name: group["lr"] for name, group
                in zip(self.group_names, self.optimizer.param_groups)}

    def state_dict(self):
        """The single-card state dict (under ZeRO a collective: every rank
        calls it)."""
        torch_state = self.optimizer.state_dict()
        if self.mesh is not None:
            torch_state = self._gathered(torch_state)
        return {"torch_state": torch_state, "base_lrs": dict(self.base_lrs)}

    def load_state_dict(self, state_dict):
        torch_state = state_dict["torch_state"]
        if self.mesh is not None:
            torch_state = self._sliced(torch_state)
        self.optimizer.load_state_dict(torch_state)


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

    def shard_state(self, mesh):
        """Each member's moments sharded over ``mesh``'s ranks (ZeRO)."""
        for opt in self.optimizers:
            opt.shard_state(mesh)

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
        """Each member's single-card state dict (under ZeRO a collective:
        every rank calls it) and the counters."""
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
