"""The training epoch (``SupervisedEpoch``), as
``mdir_tpu/learning/epoch_iteration.py`` runs it: the dataset's
``prepare_epoch`` in eval mode before the epoch (hard-negative mining, or an
image-tuple dataset's picks), then one optimizer step per batch with the
reference's ``batch_average`` / criterion-reduction scaling of the
gradients and of the reported loss, the loss and time laps logged per
iteration and the mining statistics per epoch.

A composition (JAX ``:115-226``) computes gradients for the members that are
not frozen only, and its ``OptimizerAlternation`` steps the active ones;
live BatchNorm statistics stay in the modules. Dropout draws from one
``torch.Generator`` per ``SupervisedEpoch``, seeded with 0 when it is built
and not restored on resume, as the JAX package's ``PRNGKey(0)`` is.

On the JAX package's schedule (JAX ``:228-335``) it logs the network's
weights (``train_data``: histograms counted on the card by the event
broker) before the first epoch's first step and at every epoch's last step,
and image samples of the batch the step ran on the first step of the first
epoch and the last step of every fifth: the last tuple's images (raw uint8
from a device chain, shown as they are, else de-normalised with the
dataset's mean and std), and for an image-to-image batch the last image,
the net's output of it and its target.

A photometric transform that lowers to a device chain (CLAHE in lab, lsh
or luv, ``tospace``) always runs on the card: the dataset's items are raw
uint8 (``ops.preprocess.RawChainInput``) and the chain runs inside the step;
mining extracts through the dataset's own transform. A transform that does
not lower runs on the host in ``__getitem__``, its device transforms
(``data.transforms.on_device``) on the network's device. A training mesh
(``parallel: {data: N}``) raises (ROADMAP §1.7).
"""
import copy

import numpy as np
import torch

from ..data.datasets import TuplesDataset, initialize_dataset_loader
from ..data.transforms import on_device
from ..ops.preprocess import RawChainInput, chain_from_transform
from ..optim.criteria import initialize_criterion
from ..tools.stats import StopWatch
from ..tools.utils import get_dataset_params
from .train_step import TrainStep


class SupervisedEpoch:

    LOG_TRAINDATA_SAMPLE_EVERY = 5

    def __init__(self, data_loader, criterion, *, batch_average, fakebatch,
                 parallel=None, mean_std=None):
        del fakebatch  # the step picks per-tuple or whole-batch itself
        self.data_loader = data_loader
        self.criterion = criterion
        self.mean_std = mean_std
        self.epoch = None
        if not isinstance(batch_average, bool):
            raise TypeError("batch_average must be a bool, got %r"
                            % (batch_average,))
        self.batch_average = batch_average
        if parallel and parallel.get("data", 0) > 1:
            raise NotImplementedError(
                "training over several cards is not ported yet (ROADMAP "
                "§1.7)")
        assert criterion.reduction in {"mean", "sum"}, criterion.reduction
        self.criterion_mean_reduction = criterion.reduction == "mean"
        self._train_step = None
        self._generator = None  # the Dropout generator, made on the device
        self._sample = None  # (last image, its output, its target)

    @classmethod
    def initialize(cls, params_epoch, data, params_data, default_criterion,
                   net_defaults):
        data_key = params_epoch.pop("data")
        data_params = get_dataset_params(params_data[data_key], net_defaults)
        data_loader = initialize_dataset_loader(
            data, "train", copy.deepcopy(data_params), {"shuffle": True})
        dataset = data_loader.dataset
        chain = chain_from_transform(dataset.transform) \
            if isinstance(dataset, TuplesDataset) else None
        if chain is not None:
            dataset.item_transform = RawChainInput()
            dataset.device_chain = chain

        criterion_section = params_epoch.pop("criterion")
        if criterion_section == "default":
            if default_criterion is None:
                raise ValueError("Criterion cannot be 'default' when default "
                                 "criterion is not specified")
            criterion = default_criterion
        else:
            criterion = initialize_criterion(criterion_section)
        return cls(data_loader=data_loader, criterion=criterion,
                   mean_std=data_params.get("mean_std"), **params_epoch)

    def steps(self, epoch):
        self.epoch = epoch
        return self

    def _optimization_step(self, network, optimizer, batch_images,
                           batch_targets):
        if self._train_step is None:
            self._generator = torch.Generator(
                device=network.device).manual_seed(0)
            self._train_step = TrainStep(
                network, self.criterion,
                device_chain=getattr(self.data_loader.dataset,
                                     "device_chain", None),
                generator=self._generator)
        optimizer.zero_grad()
        loss, batch_size = self._train_step.gradients(batch_images,
                                                      batch_targets)
        # batch_average against the criterion's reduction, as the reference
        divide = self.batch_average > self.criterion_mean_reduction
        multiply = self.batch_average < self.criterion_mean_reduction
        if divide or multiply:
            with torch.no_grad():
                for param in network.trainables():
                    if param.grad is None:
                        continue
                    if divide:
                        param.grad.div_(batch_size)
                    else:
                        param.grad.mul_(batch_size)
        optimizer.step()
        self._sample = (batch_images[-1], self._train_step.last_output,
                        batch_targets[-1])

        value = float(loss)
        if divide:
            value /= batch_size
        elif multiply:
            value *= batch_size
        if not self.batch_average:
            value /= batch_size
        return {"total": value}

    @staticmethod
    def _log_parameter_weights(network, logger):
        for row in network.train_data():
            logger(row["key"], row["data"], row["dtype"])

    def _log_traindata_sample(self, image, logger, label):
        """One blob row of an image (or a tuple's images): RGB and each
        further channel as gray, the first three images' channels only."""
        if not isinstance(image, list):
            image = [image]
        dbg = {}
        for j, img in enumerate(image):
            img = img.detach().cpu().numpy() if torch.is_tensor(img) \
                else np.asarray(img)
            if img.ndim == 4:
                img = img[0]
            nchans = img.shape[-1]
            if img.dtype == np.uint8:  # raw device-chain input
                img = img.astype(np.float32) / 255.0
                mean = np.zeros(nchans, np.float32)
                std = np.ones(nchans, np.float32)
            else:
                mean = np.asarray(self.mean_std[0], np.float32)
                std = np.asarray(self.mean_std[1], np.float32)
            if nchans >= 3:
                dbg["image%s.rgb" % j] = {
                    "dtype": "image:rgb",
                    "data": img[..., :3] * std[:3] + mean[:3]}
                if j >= 3:
                    continue
            for k in range(3 if nchans >= 3 else 0, nchans):
                dbg["image%s.chan%s" % (j, k + 1)] = {
                    "dtype": "image:gray",
                    "data": img[..., k] * std[k] + mean[k]}
                if j >= 3:
                    break
        logger("data/%s" % label, dbg, "blob")

    def _log_samples(self, logger):
        """The step's input; an image-to-image batch's output and target
        too (a descriptor output is skipped, as in the reference)."""
        image, output, target = self._sample
        self._log_traindata_sample(image, logger, "input")
        if not isinstance(image, list) and output is not None \
                and output.dim() == np.ndim(image) + 1:
            self._log_traindata_sample(output[-1].permute(1, 2, 0), logger,
                                       "output")
            self._log_traindata_sample(target, logger, "target")

    def _mine_epoch_tuples(self, network, logger, watch):
        """Eval-mode hard-negative mining, its statistics and time."""
        dataset = self.data_loader.dataset
        if not hasattr(dataset, "prepare_epoch"):
            return
        network.eval()
        mining_stats = dataset.prepare_epoch(network)
        watch.lap("prepare_data")
        total = len(self.data_loader)
        if mining_stats:
            logger(None, total, "learning/data_mining", mining_stats,
                   "scalar/loss")
        logger(None, total, "learning/prepare_epoch",
               watch.reset(include_total=False), "scalar/time")

    def iterate(self, network, optimizer, logger):
        """Mine, then yield each step's ``{"total": loss}``."""
        loader = self.data_loader
        on_device(getattr(loader.dataset, "transform", None), network.device)
        stopwatch = StopWatch()
        self._mine_epoch_tuples(network, logger, stopwatch)
        size = len(loader)
        if self.epoch == 0:
            self._log_parameter_weights(
                network, lambda *row: logger(-1, size, *row))
        network.train()

        for i, (batch_images, batch_targets) in enumerate(loader):
            stopwatch.lap("prepare_data")
            losses = self._optimization_step(network, optimizer,
                                             batch_images, batch_targets)
            stopwatch.lap("process_batch")
            logger(i, size, "learning/loss", losses, "scalar/loss")
            row_logger = lambda *row, i=i: logger(i, size, *row)
            if i == size - 1:
                self._log_parameter_weights(network, row_logger)
            if (i == size - 1 and (self.epoch + 1)
                    % self.LOG_TRAINDATA_SAMPLE_EVERY == 0) \
                    or (i == 0 and self.epoch == 0):
                self._log_samples(row_logger)
            yield losses
            stopwatch.lap("take_statistics")
            logger(i, len(loader), "learning/iteration",
                   stopwatch.reset(include_total=False), "scalar/time")


EPOCH_ITERATIONS = {
    "SupervisedEpoch": SupervisedEpoch,
}


def initialize_epoch_iteration(params, **kwargs):
    return EPOCH_ITERATIONS[params.pop("type")].initialize(params, **kwargs)
