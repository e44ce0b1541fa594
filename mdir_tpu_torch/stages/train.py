"""train stage: the epoch loop of mine -> train -> validate -> close_epoch,
as ``mdir_tpu/stages/train.py``: ``epochs: 0`` saves the off-the-shelf
network (``<name>_notrain.ckpt``) and returns; a fresh run logs the
network's constants (its graph) before the first epoch; the resource
statistics are
taken at the last step of the last epoch; the result is
``(learning.metadata,)`` with the JAX package's metric keys, e.g.
``train/learning/loss:total_avg.4``.
"""
from ..device import resolve_device
from ..learning import initialize_learning


def train(params, data, device="cuda"):
    """Train the scenario's network on ``device`` (the card by default)."""
    learning = initialize_learning(params, data, resolve_device(device))

    if learning.training.epoch == -1 and not learning.training.remains_epochs:
        learning.checkpoints.save_notrain(learning.network.state_dict())
        return ({},)

    if learning.training.epoch == -1:
        for const_data in learning.network.const_data():
            learning.events.register_data(
                None, None, None, "net/%s" % const_data["key"],
                const_data["data"], const_data["dtype"])

    for epoch in learning:
        logger = (lambda e: lambda iteration, size, label, value, dtype:
                  learning.events.register_data(
                      e, iteration, size, "train/%s" % label, value, dtype)
                  )(epoch.epoch)
        steps = epoch.train.iterate(learning.network,
                                    learning.training.optimizer, logger)
        for i, _losses in enumerate(steps):
            if not learning.training.remains_epochs \
                    and i == len(epoch.train.data_loader) - 1:
                learning.resources.take_current_stats()

        for val, valtask in epoch.vals:
            logger = (lambda e, v: lambda iteration, size, label, value, dtype:
                      learning.events.register_data(
                          e, iteration, size,
                          "%s/learning/%s" % (v, label), value, dtype)
                      )(epoch.epoch, val)
            valtask.validate(learning.network, logger)

        learning.close_epoch()

    return (learning.metadata,)
