"""Network and training checkpoints in the JAX package's ``epochs/`` role
layout.

Reading: the JAX package's msgpack ``.ckpt`` files and torch pickles. A
``.ckpt`` from ``mdir_tpu`` is flax's msgpack encoding of a nested dict whose
arrays are msgpack ext values (code 1: an array as ``(shape, dtype name,
bytes)``; code 3: a numpy scalar, encoded the same way). ``msgpack`` and
``torch.load`` are imported inside the readers, off the path that only
extracts. Nothing is downloaded: a URL is read from its local file
(``tools/utils.py::resolve_artifact``, ``<data root>/networks/<basename>``,
hash-checked), and a missing one raises, naming where to put it.

Writing: the port writes ``torch.save`` files under the JAX package's names
(``net_epoch_%02d.ckpt``, ``learning_epoch_%02d.ckpt``, the
``_notrain/_frozen/_bestsofar/_best/_last`` role files and symlinks) with its
two cadences: ``store_every`` epochs are kept, ``checkpoint_every`` epochs
roll (the previous rolling checkpoint is deleted unless it was stored or is
the best so far), and the last epoch always persists. Every file is written
to a temporary name and moved into place with ``os.replace``.

A composition's checkpoint has two forms on disk, both read here
(``_expand_multinet``): the member payloads embedded under
``_networks_included`` in one file (the reference's single-file ``.pth``,
the paper's form), or ``_network_names`` naming sibling files of an
``epochs/`` directory (JAX ``checkpoints.py:100-150``). The port writes the
second, as the JAX package does: each member's payload in its own
``<member>_epoch_%02d.ckpt`` (a frozen member once, as
``<member>_frozen.ckpt``, and linked), and the ``net`` file the header with
``_network_names``; a resume reads the members back through it.
"""
import os
import pickle
from pathlib import Path

import numpy as np

from ..tools.utils import local_path

SUFFIX_NOTRAIN = "_notrain.ckpt"
SUFFIX_FROZEN = "_frozen.ckpt"
SUFFIX_EPOCH = "_epoch_%02d.ckpt"
SUFFIX_BEST_SO_FAR = "_bestsofar.ckpt"
SUFFIX_BEST = "_best.ckpt"
SUFFIX_LAST = "_last.ckpt"

FNAME_TRAINING = "learning_epoch_%02d.ckpt"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray(data):
    import msgpack

    shape, dtype, buffer = msgpack.unpackb(data, raw=False)
    return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape).copy()


def _unpack_ext(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError("unsupported msgpack ext type %d in checkpoint" % code)


def load_state(path):
    """A msgpack checkpoint written by ``mdir_tpu`` -> nested dict of numpy."""
    import msgpack

    with open(path, "rb") as handle:
        blob = handle.read()
    return msgpack.unpackb(blob, ext_hook=_unpack_ext, raw=False,
                           strict_map_key=False)


def load_torch_pickle(path):
    """A torch pickle on the CPU (tensors stay tensors)."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def load_checkpoint_any(path):
    """Load a checkpoint file: ``mdir_tpu``'s msgpack or a torch pickle."""
    path = str(path)
    with open(path, "rb") as handle:
        magic = handle.read(2)
    if magic == b"PK" or path.endswith((".pth", ".pt")):
        return load_torch_pickle(path)
    try:
        return load_state(path)
    except ValueError:
        with open(path, "rb") as handle:
            return pickle.load(handle)


def save_state(state, path):
    """``torch.save`` a nested dict to ``path`` through a temporary file."""
    import torch

    tmp = str(path) + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _expand_multinet(checkpoint, load_sibling=None):
    """A network checkpoint as ``{name: payload}``: ``net`` and, for a
    composition, its members (embedded, or siblings through
    ``load_sibling``)."""
    states = {"net": checkpoint}
    for name, state in checkpoint.pop("_networks_included", {}).items():
        if name in states:
            raise ValueError("member %r appears twice" % name)
        states[name] = state
    names = checkpoint.pop("_network_names", []) if load_sibling else []
    for name in names:
        if name in states:
            raise ValueError("member %r appears twice" % name)
        states[name] = load_sibling(name)
    return states


class _Cadence:
    """Which persistence actions epoch ``epoch`` triggers (reference
    ``mdir/learning/checkpoints.py:32-45``): ``store_every`` hits are
    permanent; ``checkpoint_every`` hits roll, the previous rolling
    checkpoint (``prev_epoch1``) going unless it was also a store hit. The
    last epoch always persists."""

    def __init__(self, epoch, store_every, checkpoint_every, is_last):
        self.epoch1 = epoch + 1
        self.stored = bool(store_every) and self.epoch1 % store_every == 0
        aligned = bool(checkpoint_every) \
            and self.epoch1 % checkpoint_every == 0
        self.checkpointed = aligned or is_last
        self.persists = self.checkpointed or self.stored
        self.prev_epoch1 = None
        self.prev_is_stored = False
        if self.checkpointed and checkpoint_every:
            back = self.epoch1 % checkpoint_every or checkpoint_every
            self.prev_epoch1 = self.epoch1 - back
            self.prev_is_stored = bool(store_every) \
                and self.prev_epoch1 % store_every == 0


class Checkpoints:

    def __init__(self, directory, store_every, checkpoint_every):
        self.directory = Path(directory) / "epochs"
        self.store_every = store_every
        self.checkpoint_every = checkpoint_every

    def _file(self, name):
        return self.directory / name

    def save_notrain(self, networks_state):
        """The off-the-shelf network, with the best and last roles."""
        os.makedirs(self.directory, exist_ok=True)
        for key, state in networks_state.items():
            assert "/" not in key
            save_state(state, self._file(key + SUFFIX_NOTRAIN))
            for role in (SUFFIX_BEST, SUFFIX_LAST):
                link = self._file(key + role)
                link.unlink(missing_ok=True)
                link.symlink_to(key + SUFFIX_NOTRAIN)

    def save_epoch(self, networks_state, training_state, epoch, is_best,
                   is_last):
        assert epoch >= 0
        when = _Cadence(epoch, self.store_every, self.checkpoint_every,
                        is_last)
        os.makedirs(self.directory, exist_ok=True)
        if len(networks_state) > 1:
            networks_state["net"]["_network_names"] = [
                name for name in networks_state if name != "net"]
        for key, state in networks_state.items():
            assert "/" not in key
            self._place_network(key, state, when, is_best, is_last)
        if when.persists:
            self._write_training(training_state, when)
        for key in networks_state:
            self._promote_and_roll(key, when, is_last)

    def _place_network(self, key, state, when, is_best, is_last):
        """Write (or symlink) this epoch's network file and its role links."""
        frozen_name = key + SUFFIX_FROZEN
        if state["frozen"] and not self._file(frozen_name).exists():
            save_state(state, self._file(frozen_name))

        epoch_name = key + SUFFIX_EPOCH % when.epoch1
        if when.persists:
            if state["frozen"]:
                self._file(epoch_name).symlink_to(frozen_name)
            else:
                save_state(state, self._file(epoch_name))

        roles = [SUFFIX_BEST_SO_FAR] * is_best + [SUFFIX_LAST] * is_last
        for role in roles:
            link = self._file(key + role)
            if link.exists() or link.is_symlink():
                link.unlink()
            if state["frozen"]:
                link.symlink_to(frozen_name)
            elif when.persists:
                link.symlink_to(epoch_name)
            else:
                save_state(state, link)  # the role file is the only copy

    def _write_training(self, training_state, when):
        """The training state; the previous rolling one is deleted."""
        save_state(training_state,
                   self._file(FNAME_TRAINING % when.epoch1))
        if when.checkpointed and when.prev_epoch1:
            stale = self._file(FNAME_TRAINING % when.prev_epoch1)
            if stale.exists():
                stale.unlink()

    def _promote_and_roll(self, key, when, is_last):
        """Turn a finished _best back into _bestsofar (resume), delete the
        previous rolling network file (moving it to _bestsofar if it is the
        best), and finish _bestsofar as _best on the last epoch."""
        best = self._file(key + SUFFIX_BEST_SO_FAR)
        if not best.exists():
            retired = self._file(key + SUFFIX_BEST)
            if retired.exists():
                retired.rename(best)

        if when.checkpointed and when.prev_epoch1 \
                and not when.prev_is_stored:
            victim = self._file(key + SUFFIX_EPOCH % when.prev_epoch1)
            if victim.exists():
                # resolved paths on both sides: the best checkpoint's target
                # is moved, not deleted
                if best.exists() and victim.resolve() == best.resolve():
                    best.unlink()
                    victim.rename(best)
                else:
                    victim.unlink()

        if is_last and best.exists():
            best.rename(self._file(key + SUFFIX_BEST))

    def load_latest_epoch(self, nepochs):
        """(network state, training state) of the latest epoch below
        ``nepochs`` with a training file, or None."""
        if not self.directory.exists():
            return None
        for epoch in reversed(range(nepochs)):
            training_path = self._file(FNAME_TRAINING % (epoch + 1))
            if training_path.exists():
                suffix = SUFFIX_EPOCH % (epoch + 1)
                sibling = lambda name: load_checkpoint_any(
                    self._file(name + suffix))
                return (_expand_multinet(sibling("net"), sibling),
                        load_checkpoint_any(training_path))
        return None

    @classmethod
    def load_network(cls, directory):
        """A network state ``{"net": payload, <member>: payload, ...}`` from
        a directory (its best checkpoint, with its siblings) or a file (with
        its embedded members); a URL names a file, read from
        ``<data root>/networks`` as the JAX package caches it."""
        path = Path(local_path(directory))
        if path.is_dir():
            suffix = SUFFIX_BEST
            if not (path / ("net" + suffix)).exists() \
                    and (path / "net_best.pth").exists():
                suffix = "_best.pth"
            sibling = lambda name: load_checkpoint_any(path / (name + suffix))
            return _expand_multinet(sibling("net"), sibling)
        return _expand_multinet(load_checkpoint_any(os.fspath(path)))
