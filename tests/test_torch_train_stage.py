"""The train stage of the port (``stages/train.py``) against the JAX
package's on a synthetic retrieval-SfM-style database (16 JPEGs of 48x64,
two crops of one smooth colour field per cluster, 4 query/positive pairs),
AlexNet-GeM, contrastive loss:

* hard-negative mining picks the same queries, positives and negatives in
  two consecutive epochs (seeds 0 and 1), for the plain and the lab CLAHE
  transform, and the score gaps the JAX package's picks relied on exceed
  1e-4, so no tie decides the comparison;
* two epochs of the stage from one JAX checkpoint (the JAX stage's
  ``epochs: 0`` output) give the same per-epoch losses (rtol 1e-4) and final
  weights (atol 1e-5 + rtol 1e-4), with sgd at lr 1e-2 so that the update is
  far above the tolerance;
* two epochs resumed to three equal three straight epochs;
* ``epochs: 0`` writes the off-the-shelf checkpoint, and the checkpoint
  files, roles and cadences are the JAX package's.
"""
import os
import pickle

import numpy as np
import pytest

import jax
import torch

from mdir_tpu.data.datasets import TuplesDataset as JaxTuplesDataset
from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.learning import checkpoints as jax_checkpoints
from mdir_tpu.learning.checkpoints import load_state
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.stages.train import train as jax_train

from mdir_tpu_torch.data.datasets import TuplesDataset, selection_gap
from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning import checkpoints
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.stages.train import train

MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
PLAIN = "pil2np | totensor | normalize"
CLAHE = "pil2np | apply_clahe:4:lab:8 | totensor | normalize"
MODEL = {"architecture": "cirnet", "cir_architecture": "alexnet",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
LOSS = "train/learning/loss:total_avg.4"
MINING = "train/learning/data_mining:average_negative_distance_avg.4"


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def db_pkl(tmp_path_factory):
    """16 JPEGs in 8 clusters of 2 (two 48x64 crops of one smooth random
    colour field, with noise); queries 0, 2, 4, 6."""
    from PIL import Image

    root = tmp_path_factory.mktemp("sfm")
    rng = np.random.RandomState(3)
    fields = torch.nn.functional.interpolate(
        torch.from_numpy(rng.rand(8, 3, 3, 4).astype(np.float32)),
        size=(64, 80), mode="bilinear", align_corners=False).numpy()
    cids = []
    for i in range(16):
        y, x = rng.randint(0, 17), rng.randint(0, 17)
        img = fields[i // 2, :, y:y + 48, x:x + 64].transpose(1, 2, 0) * 255
        img = np.clip(img + rng.randn(48, 64, 3) * 8, 0, 255)
        name = str(root / ("im%03d.jpg" % i))
        Image.fromarray(img.astype(np.uint8)).save(name)
        cids.append(name)
    split = {"cids": cids, "cluster": [i // 2 for i in range(16)],
             "qidxs": [0, 2, 4, 6], "pidxs": [1, 3, 5, 7]}
    path = root / "retrieval-SfM-tiny.pkl"
    with open(path, "wb") as handle:
        pickle.dump({"train": split, "val": split}, handle)
    return str(path)


def scenario(directory, db, epochs, path=None, seed=0):
    """The stage's scenario: from a checkpoint ``path``, or from scratch."""
    network = {"type": "CirNetwork", "path": path,
               "runtime": "load_from_checkpoint"}
    if path is None:
        network.update({
            "model": dict(MODEL),
            "initialize": {"weights": "default", "seed": seed},
            "runtime": {"wrappers": {"train": "cirfaketuplebatch",
                                     "eval": ""},
                        "data": {"mean_std": MEAN_STD, "transforms": PLAIN}}})
    return {
        "network": network,
        "learning": {
            "type": "TrainValLearning",
            "checkpoints": {"directory": str(directory), "store_every": 0,
                            "checkpoint_every": 1},
            "training": {
                "type": "EpochTraining", "epochs": epochs,
                "deterministic": True, "seed": seed,
                "criterion": {"loss": "contrastive", "margin": 0.7,
                              "eps": 1e-6},
                "optimizer": {"algorithm": "sgd", "lr": 1e-2,
                              "momentum": 0.9, "weight_decay": 1e-4},
                "scheduler": {"algorithm": "gamma", "gamma": "exp(-0.01)"},
                "epoch_iteration": {"type": "SupervisedEpoch", "data": "train",
                                    "criterion": "default",
                                    "batch_average": False,
                                    "fakebatch": True},
            },
            "validation": False,
        },
        "output": {"learning": {"progress": {"print_each": 100}}},
        "data": {"train": {
            "mean_std": MEAN_STD, "transforms": PLAIN,
            "dataset": {"name": "CirTuples", "dataset": "retrieval-SfM-tiny",
                        "split": "train", "image_size": 64, "neg_num": 2,
                        "dataset_pkl": db, "image_dir": None,
                        "query_size": 4, "pool_size": 16},
            "loader": {"batch_size": 2, "num_workers": 0}}},
    }


@pytest.fixture(scope="module")
def jax_checkpoint(db_pkl, tmp_path_factory):
    """The JAX stage's off-the-shelf checkpoint (``epochs: 0``)."""
    directory = tmp_path_factory.mktemp("jax_notrain")
    assert jax_train(scenario(directory, db_pkl, 0), ()) == ({},)
    return str(directory / "epochs" / "net_notrain.ckpt")


def networks(checkpoint):
    model = jax_initialize_model(dict(MODEL))
    model.variables = jax.tree.map(
        jax.numpy.asarray, load_state(checkpoint)["model_state"])
    runtime = {"wrappers": "", "data": {"mean_std": MEAN_STD}}
    jax_net = JaxCirNetwork(model, JaxCirNetwork.NetworkParams(
        model=dict(MODEL), runtime=dict(runtime)))
    port_model = initialize_model(dict(MODEL), device="cpu")
    port_model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, model.variables)))
    return jax_net, CirNetwork(port_model, CirNetwork.NetworkParams(
        model=dict(MODEL), runtime=dict(runtime)))


# descriptor atol and distance rtol: the JAX package's CLAHE chain compiled
# by XLA on the CPU is not bit-exact (tests/test_torch_train_step.py), as in
# tests/test_torch_extract.py's CLAHE case
@pytest.mark.parametrize("transform,atol,rtol", [(PLAIN, 1e-5, 1e-4),
                                                 (CLAHE, 1e-4, 1e-3)])
def test_mining_matches_jax(db_pkl, jax_checkpoint, monkeypatch, transform,
                            atol, rtol):
    from mdir_tpu.parallel import extract as jax_extract

    jax_net, port_net = networks(jax_checkpoint)
    kwargs = dict(name="retrieval-SfM-tiny", mode="train", imsize=64,
                  nnum=2, qsize=4, poolsize=16, dataset_pkl=db_pkl)
    jax_ds = JaxTuplesDataset(transform=jax_transforms(transform, MEAN_STD),
                              **kwargs)
    port_ds = TuplesDataset(
        transform=initialize_transforms(transform, MEAN_STD), **kwargs)

    seen = []  # the JAX package's mining descriptors: (images, (D, N))
    extract = jax_extract.extract_vectors_network
    monkeypatch.setattr(jax_extract, "extract_vectors_network",
                        lambda net, images, *a, **k: seen.append(
                            (list(images), np.asarray(extract(
                                net, images, *a, **k)))) or seen[-1][1])
    for epoch in range(2):
        np.random.seed(epoch)
        stats_jax = jax_ds.create_epoch_tuples(jax_net.eval())
        np.random.seed(epoch)
        stats = port_ds.create_epoch_tuples(port_net)
        assert port_ds.qidxs == jax_ds.qidxs
        assert port_ds.pidxs == jax_ds.pidxs
        assert port_ds.nidxs == jax_ds.nidxs
        np.testing.assert_allclose(stats["average_negative_distance"],
                                   stats_jax["average_negative_distance"],
                                   rtol=rtol)

        (_, qvecs), (pool, poolvecs) = seen[-2:]
        np.testing.assert_allclose(port_ds.mined["qvecs"], qvecs, atol=atol)
        np.testing.assert_allclose(port_ds.mined["poolvecs"], poolvecs,
                                   atol=atol)
        scores = poolvecs.T @ qvecs
        ranks = np.argsort(-scores, axis=0, kind="stable")
        pool_idx = [jax_ds.images.index(path) for path in pool]
        positions = [[list(np.asarray(pool_idx)[ranks[:, q]]).index(n)
                      for n in nidxs] for q, nidxs in enumerate(jax_ds.nidxs)]
        assert selection_gap(scores, ranks, positions) > 1e-4


def test_mining_pool_exhaustion_raises(db_pkl):
    """8 clusters: a query's pool has at most 7 others, not 10."""
    port_net = CirNetwork(initialize_model(dict(MODEL), device="cpu"),
                          CirNetwork.NetworkParams(model=dict(MODEL),
                                                   runtime={"wrappers": ""}))
    dataset = TuplesDataset("retrieval-SfM-tiny", "train", imsize=64,
                            nnum=10, qsize=1, poolsize=16,
                            transform=initialize_transforms(PLAIN, MEAN_STD),
                            dataset_pkl=db_pkl)
    np.random.seed(0)
    with pytest.raises(ValueError, match="exhausted the pool"):
        dataset.create_epoch_tuples(port_net)


def _port_weights(directory, role="net_last.ckpt"):
    return checkpoints.load_checkpoint_any(
        os.path.join(directory, "epochs", role))["model_state"]


def test_train_stage_matches_jax(db_pkl, jax_checkpoint, tmp_path):
    meta_jax, = jax_train(scenario(tmp_path / "jax", db_pkl, 2,
                                   jax_checkpoint), ())
    meta, = train(scenario(tmp_path / "port", db_pkl, 2, jax_checkpoint), (),
                  device="cpu")
    assert meta["metrics"].keys() == meta_jax["metrics"].keys()
    assert len(meta["metrics"][LOSS]) == 2
    np.testing.assert_allclose(meta["metrics"][LOSS],
                               meta_jax["metrics"][LOSS], rtol=1e-4)
    np.testing.assert_allclose(meta["metrics"][MINING],
                               meta_jax["metrics"][MINING], rtol=1e-4)

    start = from_jax_variables(load_state(jax_checkpoint)["model_state"])
    want = from_jax_variables(load_state(
        tmp_path / "jax" / "epochs" / "net_last.ckpt")["model_state"])
    got = _port_weights(tmp_path / "port")
    assert got.keys() == want.keys()
    for name in want:
        assert (want[name] - start[name]).abs().max() > 1e-4, name
        torch.testing.assert_close(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, msg=name)


def test_resume_equals_a_straight_run(db_pkl, tmp_path):
    straight, = train(scenario(tmp_path / "straight", db_pkl, 3), (),
                      device="cpu")
    first, = train(scenario(tmp_path / "resumed", db_pkl, 2), (),
                   device="cpu")
    resumed, = train(scenario(tmp_path / "resumed", db_pkl, 3), (),
                     device="cpu")
    assert first["metrics"][LOSS] == straight["metrics"][LOSS][:2]
    np.testing.assert_allclose(resumed["metrics"][LOSS],
                               straight["metrics"][LOSS], rtol=1e-6)
    want = _port_weights(tmp_path / "straight")
    got = _port_weights(tmp_path / "resumed")
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-6,
                                   atol=1e-8, msg=name)
    epochs = sorted(os.listdir(tmp_path / "resumed" / "epochs"))
    # checkpoint_every 1 rolls the earlier epochs away; no validation, so
    # no best role; the image samples' blobs beside them, as JAX's
    assert epochs == ["blobs", "learning_epoch_03.ckpt", "net_epoch_03.ckpt",
                      "net_last.ckpt"], epochs


def test_epochs_0_writes_the_notrain_checkpoint(db_pkl, tmp_path):
    assert train(scenario(tmp_path, db_pkl, 0, seed=5), (),
                 device="cpu") == ({},)
    directory = tmp_path / "epochs"
    assert sorted(os.listdir(directory)) == [
        "net_best.ckpt", "net_last.ckpt", "net_notrain.ckpt"]
    assert os.readlink(directory / "net_best.ckpt") == "net_notrain.ckpt"
    state = checkpoints.load_checkpoint_any(directory / "net_notrain.ckpt")
    params = scenario(tmp_path, db_pkl, 0, seed=5)["network"]
    params.pop("type")
    fresh = CirNetwork.initialize(params, device="cpu")
    for name, value in fresh.state_dict()["net"]["model_state"].items():
        assert torch.equal(state["model_state"][name], value), name
    assert state["type"] == "CirNetwork" and not state["frozen"]


def test_checkpoint_roles_and_cadences_match_jax(tmp_path):
    """The same save_epoch calls write the same files and role links."""
    listings = []
    for module in (jax_checkpoints, checkpoints):
        store = module.Checkpoints(tmp_path / module.__name__, store_every=3,
                                   checkpoint_every=2)
        for epoch, best in enumerate([True, False, True, False, False, True,
                                      False]):
            store.save_epoch({"net": {"frozen": False,
                                      "w": np.full(2, epoch, np.float32)}},
                             {"epoch": epoch}, epoch, best, epoch == 6)
        root = store.directory
        listings.append(sorted(
            (name, os.readlink(root / name)
             if os.path.islink(root / name) else None)
            for name in os.listdir(root)))
        latest = store.load_latest_epoch(7)
        assert latest[1]["epoch"] == 6
    assert listings[0] == listings[1]
