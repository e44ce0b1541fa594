"""Loss validation (``learning/validation.py``: ``LossValidation``,
``SingleValidation`` with ``data:``) and whole epochs of the two image-model
trainings in the port against the JAX package.

* The batched eval loss of a tuple batch over a plain descriptor net (one
  padded bucket with its valid extents, eval mode, no gradient: on the card
  the ``gem_l2n`` kernel) within rtol 1e-5 of JAX's ``get_eval_loss_fn``,
  and of the port's own per-image wrapper route.
* Two epochs of each training through ``stages.train.train``, with loss
  validation after each epoch, from the same weights (the port's
  ``epochs: 0`` checkpoint, read by both packages): the translator alone on
  image pairs (a P2pUNet at 1 nested level, L1, ``RandomImageTuple`` through
  all six augmentations, validation on ``PregeneratedImageTuple`` pairs),
  and the translator jointly with an AlexNet-GeM embedder (``composition:
  alternation``, ``embed: null``, contrastive loss over mined
  ``CirTuples``, validation over the same tuples). Every per-batch train
  and validation loss within rtol 1e-5 of JAX's. SGD keeps the runs steady:
  adam's normalised update amplifies float32 differences of tiny
  gradients.
"""
import copy
import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.train_step import get_eval_loss_fn
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion
from mdir_tpu.stages.train import train as jax_train
from mdir_tpu.tools import events as jax_events

from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.learning.validation import (LossValidation,
                                                batched_eval_loss)
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.models.convert import to_jax_variables
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.stages.train import train
from mdir_tpu_torch.tools import events

Image = pytest.importorskip("PIL.Image")

MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
PLAIN = "pil2np | totensor | normalize"
CONTRASTIVE = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
ALEXNET = {"architecture": "cirnet", "cir_architecture": "alexnet",
           "local_whitening": False, "pooling": "gem", "regional": False,
           "whitening": False, "pretrained": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_no_jax_init():
    """JAX compiles out of the persistent cache, torch on one thread, and no
    JAX init compile: every JAX weight comes from the port's (shapes from
    ``jax.eval_shape``)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old, threads = getattr(jax.config, key), torch.get_num_threads()
    jax.config.update(key, 1e9)
    torch.set_num_threads(1)

    def init(self, rng, sample_hw=(64, 64)):
        dummy = jnp.zeros((1,) + tuple(sample_hw)
                          + (self.meta.get("in_channels", 3),), jnp.float32)
        shapes = jax.eval_shape(self.module.init, {"params": rng}, dummy)
        self.variables = jax.tree.map(
            lambda leaf: jnp.zeros(leaf.shape, leaf.dtype), shapes)
        return self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", init)
        yield
    jax.config.update(key, old)
    torch.set_num_threads(threads)


def test_batched_eval_loss_matches_jax_and_the_wrapper_route():
    port_model = initialize_model(dict(ALEXNET), device="cpu")
    runtime = {"wrappers": {"train": "cirfaketuplebatch",
                            "eval": "cirfaketuplebatch"},
               "data": {"mean_std": MEAN_STD}}
    port_net = CirNetwork(port_model, CirNetwork.NetworkParams(
        model=dict(ALEXNET), runtime=copy.deepcopy(runtime))).eval()
    model = jax_initialize_model(dict(ALEXNET))
    model.variables = jax.tree.map(jnp.asarray, to_jax_variables(
        port_model.state_dict(), jax.tree.map(np.asarray, model.variables)))
    jax_net = JaxCirNetwork(model, JaxCirNetwork.NetworkParams(
        model=dict(ALEXNET), runtime=copy.deepcopy(runtime)))

    rng = np.random.RandomState(4)
    images = [[rng.randn(rng.randint(48, 80), rng.randint(48, 80), 3)
               .astype(np.float32) for _ in range(4)] for _ in range(2)]
    targets = [np.array([-1, 1, 0, 0], np.float32)] * 2
    criterion = jax_criterion(CONTRASTIVE)
    batch, valid, tgt, _ = jax_prepare_batch(images, targets)
    want = float(get_eval_loss_fn(jax_net, criterion)(
        model.params, {}, batch, valid, tgt))
    port_criterion = initialize_criterion(CONTRASTIVE)
    got = batched_eval_loss(port_net, port_criterion, images, targets)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    validation = LossValidation(None, port_criterion, None, 1)
    per_batch = validation._batch_loss(port_net, images, targets)
    np.testing.assert_allclose(per_batch, want / 2, rtol=1e-5)
    with torch.no_grad():
        wrapped = float(port_criterion(port_net(images), targets)) / 2
    np.testing.assert_allclose(wrapped, per_batch, rtol=1e-5)


def _record(monkeypatch, module, into):
    """Every loss a stage logs, in order: (key, epoch, iteration, value)."""
    orig = module.EventBroker.register_data

    def register(self, epoch, iteration, size, key, data, dtype, *args,
                 **kwargs):
        if key.endswith("/loss"):
            into.append((key, epoch, iteration, data["total"]))
        return orig(self, epoch, iteration, size, key, data, dtype, *args,
                    **kwargs)

    monkeypatch.setattr(module.EventBroker, "register_data", register)


def _both(monkeypatch, make, root):
    """The port's ``epochs: 0`` checkpoint, then two epochs of ``make``'s
    scenario from it in each package; their logged losses."""
    train(make(root / "notrain", 0, None), (), device="cpu")
    logged = {"jax": [], "port": []}
    _record(monkeypatch, jax_events, logged["jax"])
    _record(monkeypatch, events, logged["port"])
    start = root / "notrain" / "epochs"
    jax_train(make(root / "jax", 2, start), ())
    train(make(root / "port", 2, start), (), device="cpu")
    return logged


def _assert_same_losses(logged, n_train, n_val):
    jax_losses, port_losses = logged["jax"], logged["port"]
    assert [x[:3] for x in port_losses] == [x[:3] for x in jax_losses]
    keys = [x[0] for x in port_losses]
    assert keys.count("train/learning/loss") == 2 * n_train
    assert keys.count("val/learning/loss") == 2 * n_val
    np.testing.assert_allclose([x[3] for x in port_losses],
                               [x[3] for x in jax_losses], rtol=1e-5)


@pytest.fixture(scope="module")
def image_pairs(tmp_path_factory):
    """8 places of 3 shots of 40x48 each, in a tsv of json rows."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(7)
    rows = []
    for i in range(8):
        rows.append([])
        for j in range(3):
            name = "p%d_%d.png" % (i, j)
            Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)) \
                .save(root / name)
            rows[-1].append(name)
    with open(root / "tuples.tsv", "w") as handle:
        handle.write("pair\n")
        for row in rows:
            handle.write(json.dumps(row) + "\n")
    return root


def test_translator_epochs_with_loss_validation_match_jax(
        image_pairs, tmp_path, monkeypatch):
    ms = [[0.5] * 3, [0.5] * 3]
    augment = "pil2np | downscale:36 | scalecrop:32_32:0.9_1 | mirror | " \
              "random_crop:32 | gaussian_noise:0.02 | totensor | normalize"
    held_out = "pil2np | center_crop:32 | totensor | normalize"

    def data(label, idx, transforms, batch_size):
        return {"mean_std": ms, "transforms": transforms,
                "dataset": {"name": label,
                            "dataset": str(image_pairs / "tuples.tsv"),
                            "data_key": "pair",
                            "image_dir": str(image_pairs), "idx": idx},
                "loader": {"batch_size": batch_size, "num_workers": 0}}

    def scenario(directory, epochs, start):
        network = {"type": "SingleNetwork", "path": None,
                   "model": {"architecture": "p2p_unet", "in_channels": 3,
                             "out_channels": 3, "nested_levels": 1},
                   "initialize": {"weights": "normal_p2p", "seed": 0},
                   "runtime": {"wrappers": "",
                               "data": {"mean_std": ms,
                                        "transforms": augment}}}
        if start is not None:
            network = {"type": "SingleNetwork",
                       "path": str(start / "net_notrain.ckpt"),
                       "runtime": "load_from_checkpoint"}
        return {
            "network": network,
            "learning": {
                "type": "TrainValLearning",
                "checkpoints": {"directory": str(directory),
                                "store_every": 0, "checkpoint_every": 1},
                "training": {
                    "type": "EpochTraining", "epochs": epochs,
                    "deterministic": True, "seed": 0,
                    "criterion": {"loss": "l1"},
                    "optimizer": {"algorithm": "sgd", "lr": 0.05,
                                  "momentum": 0.9, "weight_decay": 1e-4},
                    "scheduler": {"algorithm": "const"},
                    "epoch_iteration": {
                        "type": "SupervisedEpoch", "data": "train",
                        "criterion": "default", "batch_average": True,
                        "fakebatch": False}},
                "validation": {"type": "SingleValidation", "data": "val",
                               "criterion": "default",
                               "network_overlay": None, "frequency": 1}},
            "output": {"learning": {"progress": {"print_each": 100}}},
            "data": {"train": data("RandomImageTuple", "any_different",
                                   augment, 3),
                     "val": data("PregeneratedImageTuple", "0_-1",
                                 held_out, 4)}}

    logged = _both(monkeypatch, scenario, tmp_path)
    _assert_same_losses(logged, n_train=3, n_val=2)


def test_joint_epochs_with_loss_validation_match_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(5)
    cids = []
    for i in range(12):
        cids.append(str(tmp_path / ("im%02d.png" % i)))
        Image.fromarray(rng.randint(0, 256, (48, 48, 3)).astype(np.uint8)) \
            .save(cids[-1])
    db = tmp_path / "db.pkl"
    with open(db, "wb") as handle:
        pickle.dump({"train": {"cids": cids,
                               "cluster": [i // 2 for i in range(12)],
                               "qidxs": [0, 2, 4], "pidxs": [1, 3, 5]}},
                    handle)

    def scenario(directory, epochs, start):
        translate = {"type": "SingleNetwork", "path": None,
                     "model": {"architecture": "pixelconv_regr",
                               "in_channels": 3, "out_channels": 3,
                               "hidden": [8]},
                     "initialize": {"weights": "he_normal", "seed": 0},
                     "runtime": {"wrappers": "",
                                 "data": {"mean_std": MEAN_STD,
                                          "transforms": PLAIN}}}
        embed = {"type": "CirNetwork", "path": None, "model": dict(ALEXNET),
                 "initialize": {"weights": "default", "seed": 0},
                 "runtime": {"wrappers": {"train": "cirfaketuplebatch",
                                          "eval": "cirfaketuplebatch"}}}
        if start is not None:
            translate, embed = ({"type": kind, "runtime":
                                 "load_from_checkpoint",
                                 "path": str(start / ("%s_notrain.ckpt"
                                                      % name))}
                                for kind, name in (("SingleNetwork",
                                                    "translate"),
                                                   ("CirNetwork", "embed")))
        dataset = {"name": "CirTuples", "dataset": "retrieval-SfM-mem",
                   "split": "train", "image_size": 48, "neg_num": 1,
                   "dataset_pkl": str(db), "image_dir": None,
                   "query_size": 3, "pool_size": 12}
        return {
            "network": {"type": "SequentialNetwork",
                        "sequence": "translate,embed",
                        "translate": translate, "embed": embed},
            "learning": {
                "type": "TrainValLearning",
                "checkpoints": {"directory": str(directory),
                                "store_every": 0, "checkpoint_every": 1},
                "training": {
                    "type": "EpochTraining", "epochs": epochs,
                    "deterministic": True, "seed": 0,
                    "criterion": CONTRASTIVE,
                    "optimizer": {
                        "composition": {"type": "alternation",
                                        "alternate_iteration": None,
                                        "order": None},
                        "translate": {"algorithm": "sgd", "lr": 1e-3,
                                      "momentum": 0.9, "weight_decay": 0},
                        "embed": None},
                    "scheduler": None,
                    "epoch_iteration": {
                        "type": "SupervisedEpoch", "data": "train",
                        "criterion": "default", "batch_average": False,
                        "fakebatch": True}},
                "validation": {"type": "SingleValidation", "data": "train",
                               "criterion": "default",
                               "network_overlay": None, "frequency": 1}},
            "output": {"learning": {"progress": {"print_each": 100}}},
            "data": {"train": {
                "mean_std": MEAN_STD, "transforms": PLAIN,
                "dataset": dataset,
                "loader": {"batch_size": 3, "num_workers": 0}}}}

    logged = _both(monkeypatch, scenario, tmp_path)
    _assert_same_losses(logged, n_train=1, n_val=1)
