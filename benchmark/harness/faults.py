"""Faults planted under the timed path, to see the comparison fail.

Each is a context manager that breaks the port where it works, for the
fault test and for reading each fault's numbers on the card. ``FAULTS``
lists them by the harness whose cells can have them.

Eval:

* ``half_batch``: every chunk's second half of images reaches the trunk as
  zeros (half of the batch left out);
* ``altered_rank``: the first and the last entry of each ranking's first
  column trade places (an answer altered where it is produced);
* ``altered_map``: the mAP is scored on a ranking whose first column is
  reversed (the score's answer altered where it is produced).

Training:

* ``frozen_step``: the optimizer's step leaves the parameters as they are
  (a step that returns its state unchanged);
* ``frozen_window_step``: the same from the window on: epoch 0, which the
  set-up runs, steps as it should;
* ``half_tuples``: each step's gradients come from the first half of its
  tuples, the loss scaled to the whole batch (half of the batch left out,
  the mean taken over the rest);
* ``altered_picks``: each query's negatives are taken in reverse order of
  hardness (mining's answer altered where it is produced);
* ``half_batch``, as above, in mining's extraction.
"""
import contextlib
from unittest import mock


@contextlib.contextmanager
def half_batch():
    from mdir_tpu_torch.parallel import extract

    original = extract.fused_forward

    def broken(model, scales, batch, *args, **kwargs):
        batch = batch.clone()
        batch[(batch.shape[0] + 1) // 2:] = 0
        return original(model, scales, batch, *args, **kwargs)

    with mock.patch.object(extract, "fused_forward", broken):
        yield


@contextlib.contextmanager
def altered_rank():
    from mdir_tpu_torch.optim import scores

    original = scores.rank_database

    def broken(vecs, qvecs):
        ranks = original(vecs, qvecs).clone()
        first = ranks[0, 0].clone()
        ranks[0, 0] = ranks[-1, 0]
        ranks[-1, 0] = first
        return ranks

    with mock.patch.object(scores, "rank_database", broken):
        yield


@contextlib.contextmanager
def altered_map():
    from mdir_tpu_torch.optim import scores

    original = scores.compute_map_and_print

    def broken(dataset, ranks, gnd, *args, **kwargs):
        ranks = ranks.copy()
        ranks[:, 0] = ranks[::-1, 0]
        return original(dataset, ranks, gnd, *args, **kwargs)

    with mock.patch.object(scores, "compute_map_and_print", broken):
        yield


@contextlib.contextmanager
def frozen_step():
    from mdir_tpu_torch.optim import optimizers

    with mock.patch.object(optimizers.Optimizer, "step", lambda self: None):
        yield


@contextlib.contextmanager
def frozen_window_step():
    from mdir_tpu_torch.learning import epoch_iteration
    from mdir_tpu_torch.optim import optimizers

    original = epoch_iteration.SupervisedEpoch.iterate

    def broken(iteration, network, optimizer, logger):
        if iteration.epoch == 0:
            yield from original(iteration, network, optimizer, logger)
            return
        with mock.patch.object(optimizers.Optimizer, "step",
                               lambda self: None):
            yield from original(iteration, network, optimizer, logger)

    with mock.patch.object(epoch_iteration.SupervisedEpoch, "iterate",
                           broken):
        yield


@contextlib.contextmanager
def half_tuples():
    from mdir_tpu_torch.learning import train_step

    original = train_step.TrainStep.gradients

    def broken(step, batch_images, batch_targets):
        half = (len(batch_images) + 1) // 2
        loss, _ = original(step, batch_images[:half], batch_targets[:half])
        return loss * len(batch_images) / half, len(batch_images)

    with mock.patch.object(train_step.TrainStep, "gradients", broken):
        yield


@contextlib.contextmanager
def altered_picks():
    from mdir_tpu_torch.data import datasets

    original = datasets.TuplesDataset.create_epoch_tuples

    def broken(dataset, network):
        out = original(dataset, network)
        dataset.nidxs = [list(reversed(n)) for n in dataset.nidxs]
        return out

    with mock.patch.object(datasets.TuplesDataset, "create_epoch_tuples",
                           broken):
        yield


FAULTS = {
    "eval": {"half_batch": half_batch, "altered_rank": altered_rank,
             "altered_map": altered_map},
    "train": {"frozen_step": frozen_step,
              "frozen_window_step": frozen_window_step,
              "half_tuples": half_tuples,
              "altered_picks": altered_picks, "half_batch": half_batch},
}
