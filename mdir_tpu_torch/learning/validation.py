"""Validation tasks of the validate and train stages (the yaml surface of
``mdir_tpu/learning/validation.py``): ``SingleValidation`` with a score
criterion (``data: null``, ``ScoreValidation``) or with a loss over a
loader (``data: <key>``, ``LossValidation``), and
``MultiCriterialValidation`` over named validations, with
``network_overlay`` wrapper swaps and ``frequency`` gating.

``LossValidation`` (JAX ``:76-152``) runs the dataset's ``prepare_epoch``
(mining, through the frozen overlay) and then the criterion over every
batch, sum-reduced losses divided by the batch size. A tuple batch over a
plain descriptor net whose eval wrappers only reshape (the FakeBatch
family, or none) runs as one padded bucket with its valid extents, in eval
mode and without gradients (JAX ``train_step.py:357-410``
``get_eval_loss_fn``): on the card its pool is the ``gem_l2n`` kernel. Any
other batch or net, a ``SequentialNetwork`` among them, goes through the
network's own wrappers (``network(images)``), as the JAX package's does.
The loader's host transform computes its device steps (CLAHE, colorspaces)
on the network's device (``data.transforms.on_device``), as the training
epoch's does.
"""
import copy

import numpy as np
import torch

from ..data.datasets import initialize_dataset_loader
from ..data.transforms import on_device
from ..optim.criteria import initialize_criterion
from ..optim.scores import initialize_score
from ..tools.stats import StopWatch
from ..tools.utils import get_dataset_params
from .train_step import as_targets, is_tuple_batch, prepare_batch
from .wrappers import FakeBatch


class NoValidation:

    decisive_criterion = ""

    def validations(self, _epoch):
        return []


class _ScheduledValidation:
    """Frequency gating and the frozen overlay a validation runs on."""

    def __init__(self, network_overlay, frequency):
        self.network_overlay = network_overlay
        self.frequency = frequency

    def should_validate(self, epoch):
        if epoch is None:
            return True
        return bool(self.frequency) and (epoch + 1) % self.frequency == 0

    def validations(self, epoch):
        return [("val", self)] if self.should_validate(epoch) else []

    def _frozen_overlay(self, network):
        network = network.overlay_params(copy.deepcopy(self.network_overlay))
        network.eval()
        return network


class ScoreValidation(_ScheduledValidation):
    """Loader-less validation: a score callable taking (network, logger)."""

    decisive_criterion = "val/learning/score:total"

    def __init__(self, score, network_overlay, frequency):
        super().__init__(network_overlay, frequency)
        self.criterion = score

    def validate(self, network, logger=None):
        return self.criterion(self._frozen_overlay(network), logger)


def batched_eval_loss(network, criterion, images, targets):
    """The criterion of a tuple batch as one padded bucket in eval mode (a
    float, no gradient), or None where the network has no such route (JAX
    ``get_eval_loss_fn``)."""
    if hasattr(network, "sequence") or not is_tuple_batch(images) \
            or not all(isinstance(w, FakeBatch)
                       for w in network.wrappers["eval"].wrappers):
        return None
    (batch, valid, tgt), = prepare_batch(images, targets, whole=True)
    model = network.model
    device = network.device
    with torch.no_grad():
        x = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2)
        x = x.to(torch.float32).contiguous()
        if "pooling" in model.meta:
            out = model(x, torch.from_numpy(valid).to(device)).T
        else:
            out = model(x)
        return float(criterion(out.to(torch.float32),
                               as_targets(tgt, device)))


class LossValidation(_ScheduledValidation):
    """Criterion averaged over a validation loader, reported
    batch-normalised."""

    decisive_criterion = "val/learning/loss:total"

    def __init__(self, data_loader, criterion, network_overlay, frequency):
        super().__init__(network_overlay, frequency)
        self.data_loader = data_loader
        self.criterion = criterion
        assert criterion.reduction in {"mean", "sum"}, criterion.reduction

    def _batch_loss(self, network, images, targets):
        loss = batched_eval_loss(network, self.criterion, images, targets)
        if loss is None:
            with torch.no_grad():
                out = network(images)
                if isinstance(targets, list):
                    targets = np.concatenate(
                        [np.asarray(t).reshape(-1) for t in targets])
                loss = float(self.criterion(
                    out, as_targets(targets, out.device)))
        if self.criterion.reduction == "sum":
            loss /= len(images)
        return loss

    def _prepare(self, network, logger, watch):
        dataset = self.data_loader.dataset
        # a host transform's device steps run where the network is
        on_device(getattr(dataset, "transform", None), network.device)
        if not hasattr(dataset, "prepare_epoch"):
            return
        mining_stats = dataset.prepare_epoch(network)
        watch.lap("prepare_data")
        if logger:
            if mining_stats:
                logger(None, len(self.data_loader), "data_mining",
                       mining_stats, "scalar/loss")
            logger(None, len(self.data_loader), "prepare_epoch",
                   watch.reset(include_total=False), "scalar/time")

    def validate(self, network, logger=None):
        """The per-batch losses; each is logged with its time."""
        network = self._frozen_overlay(network)
        watch = StopWatch()
        self._prepare(network, logger, watch)
        losses = []
        total = len(self.data_loader)
        for i, (images, targets) in enumerate(self.data_loader):
            watch.lap("prepare_data")
            loss = self._batch_loss(network, images, targets)
            watch.lap("process_batch")
            if logger:
                logger(i, total, "loss", {"total": loss}, "scalar/loss")
                logger(i, total, "iteration",
                       watch.reset(include_total=False), "scalar/time")
            losses.append(loss)
        return losses


class SingleValidation:
    """Yaml-facing factory: a score or a loss validation."""

    @classmethod
    def initialize(cls, params, data, params_data, default_criterion,
                   net_defaults):
        data_key = params.pop("data")
        criterion_section = params.pop("criterion")
        schedule = {"network_overlay": params.pop("network_overlay"),
                    "frequency": params.pop("frequency")}
        assert not params, params.keys()
        if criterion_section == "default" and default_criterion is None:
            raise ValueError("Criterion cannot be 'default' when default "
                             "criterion is not specified")
        if data_key is None:
            score = default_criterion if criterion_section == "default" \
                else initialize_score(get_dataset_params(criterion_section,
                                                         net_defaults))
            return ScoreValidation(score, **schedule)
        loader = initialize_dataset_loader(
            data, "val", get_dataset_params(params_data[data_key],
                                            net_defaults))
        criterion = default_criterion if criterion_section == "default" \
            else initialize_criterion(criterion_section)
        return LossValidation(loader, criterion, **schedule)


class MultiCriterialValidation:

    def __init__(self, decisive_criterion, validations):
        self.decisive_criterion = decisive_criterion
        self.vals = validations

    @classmethod
    def initialize(cls, params, **kwargs):
        decisive_criterion = params.pop("decisive_criterion")
        named = {key: initialize_validation(scenario, **kwargs)
                 for key, scenario in params.items()}
        return cls(decisive_criterion, named)

    def validations(self, epoch):
        return [(key, val) for key, val in self.vals.items()
                if val.should_validate(epoch)]


VALIDATIONS = {
    "SingleValidation": SingleValidation,
    "MultiCriterialValidation": MultiCriterialValidation,
}


def initialize_validation(params, **kwargs):
    if isinstance(params, bool) and not params:
        return NoValidation()
    return VALIDATIONS[params.pop("type")].initialize(params, **kwargs)
