"""Epoch learning-rate schedulers, as ``mdir_tpu/optim/schedulers.py``.

``const`` (void), ``lambda`` (fixed lr, then linear decay to zero past
``fixed_ratio * nepochs``), ``gamma`` (exponential, with the ``exp(-0.01)``
string sugar) and the ``set`` composition. torch LRScheduler counting: the
constructor takes an implicit step, so the factor for epoch e applies after
the e-th ``step()``; ``last_epoch`` resumes the counter.
"""
import math


class BaseScheduler:
    def __init__(self, optimizer, last_epoch):
        self.optimizer = optimizer
        self.epoch = last_epoch + 1  # torch: init performs an implicit step
        if self.optimizer is not None:
            self.optimizer.set_lr_factor(self.factor(self.epoch))

    def factor(self, epoch):
        raise NotImplementedError

    def step(self):
        self.epoch += 1
        self.optimizer.set_lr_factor(self.factor(self.epoch))


class VoidScheduler:
    def step(self):
        pass


class LambdaScheduler(BaseScheduler):
    """Fixed lr for fixed_ratio*nepochs, then linear decay to zero."""

    def __init__(self, optimizer, last_epoch, nepochs, fixed_ratio):
        self.nepochs = nepochs
        self.fixed_ratio = fixed_ratio
        super().__init__(optimizer, last_epoch)

    def factor(self, epoch):
        return 1 - max(0, epoch + 1 - self.fixed_ratio * self.nepochs) \
            / float((1 - self.fixed_ratio) * self.nepochs + 1)


class GammaScheduler(BaseScheduler):
    """Exponential decay: lr = base * gamma^epoch."""

    def __init__(self, optimizer, last_epoch, gamma):
        if isinstance(gamma, str) and gamma.startswith("exp(") \
                and gamma[-1] == ")":
            gamma = math.exp(float(gamma[len("exp("):-1]))
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def factor(self, epoch):
        return self.gamma ** epoch


def init_void_scheduler(_optimizer, _last_epoch, _nepochs):
    return VoidScheduler()


def init_lambda_scheduler(optimizer, last_epoch, nepochs, fixed_ratio):
    return LambdaScheduler(optimizer, last_epoch, nepochs, fixed_ratio)


def init_gamma_scheduler(optimizer, last_epoch, _nepochs, gamma):
    return GammaScheduler(optimizer, last_epoch, gamma)


BASE_SCHEDULERS = {
    "const": init_void_scheduler,
    "lambda": init_lambda_scheduler,
    "gamma": init_gamma_scheduler,
}


def initialize_base_scheduler(optimizer, last_epoch, nepochs, params):
    params = dict(params)
    return BASE_SCHEDULERS[params.pop("algorithm")](
        optimizer, last_epoch, nepochs, **params)


class SchedulerSet:
    """One scheduler per optimizer of an optimizer composition."""

    def __init__(self, schedulers):
        self.schedulers = schedulers

    def step(self):
        for scheduler in self.schedulers:
            scheduler.step()

    @classmethod
    def initialize(cls, optimizer, last_epoch, nepochs, scheduler_params):
        return cls([initialize_base_scheduler(
            optimizer=optimizer[net], last_epoch=last_epoch,
            nepochs=nepochs, params=scheduler_params[net])
            for net in optimizer])


SCHEDULER_COMPOSITIONS = {
    "set": SchedulerSet,
}


def initialize_scheduler(optimizer, params, nepochs, last_epoch=-1):
    if not optimizer or not params:
        return None
    params = dict(params)
    if "composition" in params:
        composition = params.pop("composition")
        return SCHEDULER_COMPOSITIONS[composition.pop("type")].initialize(
            optimizer=optimizer, last_epoch=last_epoch, nepochs=nepochs,
            scheduler_params=params, **composition)
    return initialize_base_scheduler(optimizer=optimizer,
                                     last_epoch=last_epoch, nepochs=nepochs,
                                     params=params)
