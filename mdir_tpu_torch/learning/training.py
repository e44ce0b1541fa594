"""The epoch loop (``EpochTraining``), as
``mdir_tpu/learning/training.py``: an ``EpochCursor`` walks the epochs and
reseeds the host RNGs per epoch (``seed + epoch``, numpy and ``random``, the
only randomness the train stage draws: the query subset, the pool and the
shuffle), the scheduler steps at the top of every epoch, and a resume may
change only the total epoch count. The state payload is ``{"type",
"params", "optimizer_state", "epoch"}``; epoch -1 means "not started".
"""
import copy
import random
import time
from dataclasses import dataclass

import numpy as np

from ..optim.criteria import initialize_criterion
from ..optim.optimizers import initialize_optimizer
from ..optim.schedulers import initialize_scheduler
from .epoch_iteration import initialize_epoch_iteration
from .resume import merge_epoch_override, require


def reseed_host(seed):
    """Seed the host RNGs that feed data sampling (numpy and stdlib)."""
    np.random.seed(int(seed) % (2 ** 32))
    random.seed(int(seed))


@dataclass
class EpochCursor:
    """Walks epochs ``-1 -> total-1``; epoch e reseeds with
    ``base_seed + e``, so a resumed run continues the seed sequence."""

    total: int
    base_seed: int = None
    position: int = -1

    def start_next(self):
        if self.position + 1 >= self.total:
            raise StopIteration()
        self.position += 1
        if self.base_seed is not None:
            reseed_host(self.base_seed + self.position)
        return self.position

    @property
    def epochs_left(self):
        return self.total - self.position - 1


def _build_parts(spec, network, data, params_data, optimizer_state,
                 last_epoch):
    """Criterion, optimizer, scheduler and epoch iteration from the spec
    (consuming their keys; the loop options remain)."""
    criterion = initialize_criterion(spec.pop("criterion"))
    optimizer = initialize_optimizer(network=network,
                                     params=spec.pop("optimizer"))
    if optimizer_state:
        optimizer.load_state_dict(optimizer_state)
    scheduler = initialize_scheduler(optimizer=optimizer,
                                     params=spec.pop("scheduler"),
                                     nepochs=spec["epochs"],
                                     last_epoch=last_epoch)
    iteration = initialize_epoch_iteration(
        spec.pop("epoch_iteration"), data=data, params_data=params_data,
        default_criterion=criterion,
        net_defaults=network.network_params.runtime.get("data", {}))
    return criterion, optimizer, scheduler, iteration


class EpochTraining:
    """Iterator over training epochs: yields ``(epoch, steps)`` pairs."""

    def __init__(self, declared_spec, components, cursor):
        self.params = declared_spec  # the scenario section, for the state
        self.criterion, self.optimizer, self.scheduler, \
            self.epoch_iteration = components
        self.cursor = cursor
        reseed_host(cursor.base_seed if cursor.base_seed is not None
                    else int(time.time()))

    def __next__(self):
        epoch = self.cursor.start_next()
        if self.scheduler is not None:
            self.scheduler.step()
        return epoch, self.epoch_iteration.steps(epoch)

    @property
    def epoch(self):
        return self.cursor.position

    @property
    def remains_epochs(self):
        return self.cursor.epochs_left

    def state_dict(self):
        return {
            "type": type(self).__name__,
            "params": self.params,
            "optimizer_state": (self.optimizer.state_dict()
                                if self.optimizer else None),
            "epoch": self.cursor.position,
        }


TRAININGS = {
    "EpochTraining": EpochTraining,
}


def initialize_training(params, network, data, params_data, state=None):
    """The epoch loop from its scenario section, or resumed from
    ``state``."""
    cls = TRAININGS[params.pop("type")]
    if state is None:
        spec, start_epoch, optimizer_state = params, -1, None
    else:
        require(state["type"] == cls.__name__, "training type",
                state["type"], cls.__name__)
        spec = merge_epoch_override(state["params"], params)
        require(state["epoch"] + 1 < spec["epochs"],
                "resume point (already complete)", state["epoch"] + 1,
                spec["epochs"])
        start_epoch, optimizer_state = state["epoch"], \
            state["optimizer_state"]

    declared = copy.deepcopy(spec)
    working = dict(spec)
    components = _build_parts(working, network, data, params_data,
                              optimizer_state, start_epoch)
    if set(working) != {"epochs", "deterministic", "seed"}:
        raise ValueError("unknown training keys: %s"
                         % sorted(set(working) - {"epochs", "deterministic",
                                                  "seed"}))
    cursor = EpochCursor(total=working["epochs"], base_seed=working["seed"],
                         position=start_epoch)
    return cls(declared, components, cursor)
