"""Several cards on ``torch.distributed`` (``mdir_tpu_torch/parallel/mesh.py``
and the sharded paths), run here as 2 and 3 CPU processes in a gloo group
(``mesh.launch``), against the JAX package on its virtual 8-device mesh
(``tests/conftest.py``), from the same numpy-seeded inputs and the JAX
package's weights carried across (``models/convert.py``):

* sharded extraction of the plain and the lab CLAHE routes and of a
  translator -> embedder composition against JAX's
  ``extract_vectors_network(mesh=make_mesh(8))`` (rtol 1e-4, atol 1e-6, as
  ``tests/test_extract.py:129`` holds JAX's own; the CLAHE route at that
  tolerance against the port's one-process run, and at atol 1e-4 against
  JAX, whose XLA CLAHE on the CPU is not bit-exact);
* ``rank_database_sharded`` over 11 columns, equal to JAX's;
* the ZeRO rule dimension by dimension against ``zero_shardings``;
* two adam steps of data parallelism and of ZeRO against
  ``tests/test_zero_sharding.py::_grads_and_step`` (the first batch's
  gradients, summed over the ranks, at rtol 1e-4, atol 1e-6; loss rtol
  1e-5, each parameter's update at cosine >= 0.9999; ZeRO bit for bit
  against data parallelism), a ZeRO state dict saved at world 2 and
  resumed at world 1;
* one epoch of the train stage at world 2 (ZeRO, sgd with momentum) against
  the same epoch in one process;
* the bfloat16 guards on a mesh (one process playing rank 0 of two, rank
  1's part of each collective given): the extraction guard judges the
  gathered chunk and the train guard the summed batch, so rank 1's drift
  rejects bfloat16 although rank 0's own rows and gradients pass;
* what raises: a mesh wider than the group or the cards, a whole batch
  that does not split over the ranks, ZeRO with an optimizer that keeps no
  sharded state; and what ran into those raises until whole-batch data
  parallelism was ported: a composition's step at world 2 equals one
  process's, and ZeRO under a one-member ``composition`` section (an
  ``OptimizerAlternation``) trains an epoch at world 2 as one process
  does;
* ``dryrun_multicard(2, "cpu")`` on a ResNet18.

Each world is one launch of ``dryrun.in_turn`` (the ranks run the package's
own parts, so they import no JAX); every launch has a timeout and kills its
processes when it passes.
"""
import copy
import functools
import os
import pickle
import types

import numpy as np
import pytest

import jax
import torch

from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.network import SequentialNetwork as JaxSequential
from mdir_tpu.learning.network import SingleNetwork as JaxSingleNetwork
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.ops.ranking import rank_database_sharded as jax_rank_sharded
from mdir_tpu.parallel.extract import \
    extract_vectors_network as jax_extract
from mdir_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mdir_tpu.parallel.mesh import zero_shardings

from mdir_tpu_torch import dryrun
from mdir_tpu_torch.learning.checkpoints import load_checkpoint_any
from mdir_tpu_torch.learning.epoch_iteration import SupervisedEpoch
from mdir_tpu_torch.learning.network import (CirNetwork, SequentialNetwork,
                                             SingleNetwork)
from mdir_tpu_torch.learning.train_step import TrainStep
from mdir_tpu_torch.models import initialize_model, trunks
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.ops import dtypes as dtype_policy
from mdir_tpu_torch.ops.ranking import rank_database
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.parallel.extract import StreamingExtractor
from mdir_tpu_torch.parallel.mesh import Mesh, launch, make_mesh, zero_dims
from mdir_tpu_torch.stages.train import train

from test_train_step import _make_network, _tuple_batch
from test_zero_sharding import _grads_and_step, _sharded_dim

WORLDS = (2, 3)
TIMEOUT_S = 300
MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
ALEXNET = {"architecture": "cirnet", "cir_architecture": "alexnet",
           "local_whitening": False, "pooling": "gem", "regional": False,
           "whitening": False, "pretrained": False}
TRANSLATOR = {"architecture": "pixelconv_regr", "in_channels": 3,
              "out_channels": 3, "hidden": [4]}
EVAL = {"wrappers": {"train": None, "eval": {
    "1_cirmultiscale": {"scales": [1, 2 ** -0.5]}}}}
ROUTES = {"plain": "pil2np | totensor | normalize",
          "lab_clahe": "pil2np | apply_clahe:4:lab:8 | totensor | normalize",
          "composed": "pil2np | totensor | normalize"}
# nine images, so that the last chunk of 2 or 3 has padding rows; three
# composed chunk keys (the same pads to 16 at both scales) of three shapes
SHAPES = [(120, 100), (118, 98), (117, 97), (100, 127), (99, 126),
          (98, 125), (127, 127), (126, 125), (125, 124)]
IMAGE_SIZE = 127
ADAM = {"algorithm": "adam", "lr": 1e-3, "weight_decay": 0}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def _shapes_only_init(self, rng, sample_hw=(64, 64)):
    """JAX ``Model.init`` making zeros of the variables' shapes, without
    the XLA compile of the real init (``test_torch_composition``)."""
    dummy = jax.numpy.zeros((1,) + tuple(sample_hw) + (3,), np.float32)
    shapes = jax.eval_shape(self.module.init, {"params": rng}, dummy)
    self.variables = jax.tree.map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype), shapes)
    return self


def _port_net(jax_model, runtime, cls=CirNetwork, params=ALEXNET):
    model = initialize_model(dict(params), device="cpu")
    model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jax_model.variables)), strict=True)
    return cls(model, cls.NetworkParams(model=dict(params),
                                        runtime=copy.deepcopy(runtime)))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        path = str(root / ("im%02d.png" % i))
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path)
        paths.append(path)
    return paths


def _seeded(model, rng):
    """``model`` with every variable drawn from ``rng`` (kernels N(0,
    1/fan_in), GeM's p 3, the rest around 0), built without the XLA
    compile of its init."""
    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            value = rng.randn(*leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif name == "p":
            value = np.full(leaf.shape, 3.0)
        else:
            value = 0.1 * rng.randn(*leaf.shape)
        return value.astype(np.float32)

    model.variables = jax.tree_util.tree_map_with_path(draw, model.variables)
    return model


@pytest.fixture(scope="module")
def networks():
    """route -> (JAX network, the port's checkpoint state), one AlexNet-GeM
    (scales 1 and 2^-1/2) and a pixelconv translator before it, on weights
    drawn from a seed."""
    rng = np.random.RandomState(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", _shapes_only_init)
        jax_model = _seeded(jax_initialize_model(dict(ALEXNET)), rng)
        jax_t = _seeded(jax_initialize_model(dict(TRANSLATOR)), rng)

    def jax_net():
        return JaxCirNetwork(jax_model, JaxCirNetwork.NetworkParams(
            model=dict(ALEXNET), runtime=copy.deepcopy(EVAL)), frozen=True)

    single = jax_net()
    port_state = _port_net(jax_model, EVAL).state_dict()
    # a composition takes its embedder's wrappers: new members for it
    pad = {"wrappers": "reflectpad_divisible:16"}
    translator = JaxSingleNetwork(jax_t, JaxSingleNetwork.NetworkParams(
        model=dict(TRANSLATOR), runtime=dict(pad)))
    jax_composed = JaxSequential({"translate": translator,
                                  "embed": jax_net()},
                                 ["translate", "embed"]).eval()
    port_composed = SequentialNetwork(
        {"translate": _port_net(jax_t, pad, SingleNetwork, TRANSLATOR),
         "embed": _port_net(jax_model, EVAL)}, ["translate", "embed"])
    return {"plain": (single, port_state),
            "lab_clahe": (single, port_state),
            "composed": (jax_composed, port_composed.state_dict()),
            "port_composed": port_composed}


@pytest.fixture(scope="module")
def ranking_inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(32, 11).astype(np.float32),
            rng.randn(32, 4).astype(np.float32))


def _adam_batches():
    """``_grads_and_step``'s two batches: 4 tuples of 4 64x64 images."""
    rng = np.random.RandomState(0)
    return [_tuple_batch(rng, n_tuples=4, tuple_len=4, hw=64)
            for _ in range(2)]


@pytest.fixture(scope="module")
def adam_state():
    """``_grads_and_step``'s network (AlexNet-GeM, JAX's default init) as
    the port's checkpoint state; ``param_sharding`` -> state."""
    jax_net = _make_network()
    states = {}
    for sharding in (None, "zero"):
        runtime = {"wrappers": ""}
        if sharding:
            runtime["param_sharding"] = sharding
        states[sharding] = _port_net(jax_net.model, runtime).state_dict()
    return states


def _sfm_db(root):
    """16 PNGs in 8 clusters of 2 (two 48x64 crops of one smooth colour
    field, with noise); queries 0, 2, 4, 6 (``test_torch_train_stage``'s
    database)."""
    from PIL import Image

    rng = np.random.RandomState(3)
    fields = torch.nn.functional.interpolate(
        torch.from_numpy(rng.rand(8, 3, 3, 4).astype(np.float32)),
        size=(64, 80), mode="bilinear", align_corners=False).numpy()
    cids = []
    for i in range(16):
        y, x = rng.randint(0, 17), rng.randint(0, 17)
        img = fields[i // 2, :, y:y + 48, x:x + 64].transpose(1, 2, 0) * 255
        img = np.clip(img + rng.randn(48, 64, 3) * 8, 0, 255)
        name = str(root / ("im%03d.png" % i))
        Image.fromarray(img.astype(np.uint8)).save(name)
        cids.append(name)
    split = {"cids": cids, "cluster": [i // 2 for i in range(16)],
             "qidxs": [0, 2, 4, 6], "pidxs": [1, 3, 5, 7]}
    path = root / "retrieval-SfM-tiny.pkl"
    with open(path, "wb") as handle:
        pickle.dump({"train": split}, handle)
    return str(path)


SGD = {"algorithm": "sgd", "lr": 1e-2, "momentum": 0.9,
       "weight_decay": 1e-4}


def _train_scenario(directory, db, parallel=None, optimizer=SGD):
    """One epoch of AlexNet-GeM from seed 0, contrastive, sgd with
    momentum (or ``optimizer``), 2 tuples a batch, under ZeRO when
    ``parallel`` is set."""
    epoch = {"type": "SupervisedEpoch", "data": "train",
             "criterion": "default", "batch_average": False,
             "fakebatch": True}
    if parallel:
        epoch["parallel"] = {"data": parallel}
    return {
        "network": {
            "type": "CirNetwork", "path": None, "model": dict(ALEXNET),
            "initialize": {"weights": "default", "seed": 0},
            "runtime": {"wrappers": {"train": "cirfaketuplebatch",
                                     "eval": ""},
                        "data": {"mean_std": MEAN_STD,
                                 "transforms": ROUTES["plain"]},
                        "param_sharding": "zero"}},
        "learning": {
            "type": "TrainValLearning",
            "checkpoints": {"directory": str(directory), "store_every": 0,
                            "checkpoint_every": 1},
            "training": {
                "type": "EpochTraining", "epochs": 1, "deterministic": True,
                "seed": 0,
                "criterion": {"loss": "contrastive", "margin": 0.7,
                              "eps": 1e-6},
                "optimizer": copy.deepcopy(optimizer),
                "scheduler": {"algorithm": "gamma", "gamma": "exp(-0.01)"},
                "epoch_iteration": epoch},
            "validation": False},
        "output": {"learning": {"progress": {"print_each": 100}}},
        "data": {"train": {
            "mean_std": MEAN_STD, "transforms": ROUTES["plain"],
            "dataset": {"name": "CirTuples", "dataset": "retrieval-SfM-tiny",
                        "split": "train", "image_size": 64, "neg_num": 2,
                        "dataset_pkl": db, "image_dir": None,
                        "query_size": 4, "pool_size": 16},
            "loader": {"batch_size": 2, "num_workers": 0}}},
    }


# a composition's optimizer section: sgd on the translator, the embedder
# frozen
COMPOSED_SGD = {"composition": {"type": "alternation",
                                "alternate_iteration": None, "order": None},
                "translate": dict(SGD), "embed": None}


def _composed_batches():
    """One batch of 2 tuples of 4 64x64 float images (4 a rank at world
    2)."""
    return [_tuple_batch(np.random.RandomState(7), n_tuples=2, tuple_len=4,
                         hw=64)]


def _extraction_calls(networks, images):
    return [(dryrun.sharded_descriptors,
             (networks[route][1], images, IMAGE_SIZE, ROUTES[route],
              MEAN_STD, 2)) for route in ROUTES]


@pytest.fixture(autouse=True, scope="module")
def launched(networks, images, ranking_inputs, adam_state, tmp_path_factory):
    """The launches, started before the first test on threads beside the
    JAX work: one a world (the three routes' descriptors and the ranks; at
    world 2 also the adam steps (DP, ZeRO, and ZeRO's first step alone),
    one train-stage epoch, the dry run in place and a composition's step),
    the dry run, and a train-stage epoch of ZeRO under an optimizer
    alternation. ``launched[key]()`` waits."""
    import concurrent.futures

    root = tmp_path_factory.mktemp("parallel_train")
    db = _sfm_db(root)
    batches = _adam_batches()
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 2)
    futures = {}
    for world in WORLDS:
        calls = _extraction_calls(networks, images) + [
            (dryrun.sharded_ranks, ranking_inputs)]
        if world == 2:
            calls += [
                (dryrun.train_steps, (adam_state[None], batches, ADAM)),
                (dryrun.train_steps, (adam_state["zero"], batches, ADAM)),
                (dryrun.train_steps, (adam_state["zero"], batches[:1],
                                      ADAM)),
                (train, (_train_scenario(root / "world2", db, world), ())),
                (functools.partial(dryrun.dryrun_multicard,
                                   architecture="resnet18"), (world,)),
                (dryrun.train_steps, (networks["port_composed"].state_dict(),
                                      _composed_batches(), COMPOSED_SGD))]
        futures[world] = pool.submit(launch, dryrun.in_turn, world, "cpu",
                                     args=(calls,), timeout=TIMEOUT_S)
    futures["dryrun"] = pool.submit(dryrun.dryrun_multicard, 2, "cpu",
                                    "resnet18", TIMEOUT_S)
    # ZeRO with a one-member composition section: its optimizer (an
    # OptimizerAlternation) keeps no sharded state
    alternation = {"composition": {"type": "alternation",
                                   "alternate_iteration": None,
                                   "order": None}, "net": dict(SGD)}
    futures["zero_alternation"] = pool.submit(
        launch, train, 2, "cpu", args=(_train_scenario(
            root / "zero_alternation", db, 2, alternation), ()),
        timeout=TIMEOUT_S)
    yield dict({key: future.result for key, future in futures.items()},
               root=root, db=db)
    pool.shutdown(wait=True)


def _ranks(launched, world):
    """Each rank's results at ``world`` (waits for the launch): call it
    after a test's JAX work, which then runs beside the launches."""
    return launched[world]()


def test_make_mesh_raises_beyond_the_group_or_the_cards():
    assert make_mesh(1, "cpu").size == 1
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="cards"):
        make_mesh(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="cards"):
        launch(dryrun.in_turn, torch.cuda.device_count() + 1, "cuda",
               args=([],))


def test_whole_batch_net_under_parallel_raises(networks, launched):
    """A composition (the whole-batch route) under ``parallel`` raised
    before anything ran until its data parallelism was ported; now its
    step at world 2 (a translator trained, the embedder frozen) gives
    every rank one process's loss and update, and only a whole batch whose
    images do not split over the ranks raises, with JAX's message, before
    any collective."""
    composed = networks["port_composed"]
    runs = [rank[9] for rank in _ranks(launched, 2)]
    one = dryrun.train_steps(composed.state_dict(), _composed_batches(),
                             COMPOSED_SGD, device=torch.device("cpu"))
    assert one["grads"] and all(k.startswith("translate.")
                                for k in one["grads"])
    for run in runs:
        np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-5)
        for name, value in one["grads"].items():
            np.testing.assert_allclose(run["grads"][name].numpy(),
                                       value.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        for name, value in one["model"].items():
            np.testing.assert_allclose(run["model"][name].numpy(),
                                       value.numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=name)
        for name, value in runs[0]["model"].items():
            assert torch.equal(run["model"][name], value), name
    criterion = initialize_criterion({"loss": "contrastive", "margin": 0.7,
                                      "eps": 1e-6})
    step = TrainStep(composed, criterion, mesh=_RankZeroOfTwo())
    assert step.whole
    images, targets = _tuple_batch(np.random.RandomState(8), n_tuples=1,
                                   tuple_len=4, hw=64)
    images[0].append(images[0][0])
    with pytest.raises(ValueError, match="batch size 5 not divisible by 2 "
                       "devices"):
        step.gradients(images, [np.append(targets[0], 0.0)])


class _RankZeroOfTwo(Mesh):
    """Rank 0 of a world of two in this process: each collective takes
    rank 1's part from ``theirs``, in call order (none left: rank 1 adds
    nothing)."""

    def __init__(self, theirs=()):
        super().__init__(2, 0, "cpu", group="rank 1 given")
        self.theirs = list(theirs)

    def all_gather_rows(self, local):
        return torch.cat([local, self.theirs.pop(0).to(local.dtype)])

    def all_reduce(self, tensors):
        for t, other in zip(tensors, self.theirs.pop(0) if self.theirs
                            else ()):
            t.add_(other)
        return tensors


@pytest.fixture
def on_a_card(monkeypatch):
    """``auto`` resolves as on a card (bfloat16 under the guard); the
    guards' verdicts are forgotten after the test."""
    monkeypatch.setattr(dtype_policy, "on_accelerator", lambda device: True)
    yield
    dtype_policy._GUARD_DECISIONS.clear()


def test_extraction_guard_judges_every_ranks_rows(on_a_card):
    """The first chunk of four images, two a rank: rank 1's bfloat16 rows
    are its float32 rows negated, so the gathered chunk fails the cosine
    bar although rank 0's own rows pass it; every rank then keeps the
    float32 chunk."""
    model = initialize_model(dict(ALEXNET), device="cpu", seed=0)
    rng = np.random.RandomState(5)
    arrays = [(rng.rand(64, 64, 3) * 255).astype(np.uint8) for _ in range(4)]

    def extracted(**kwargs):
        ext = StreamingExtractor(model, max_batch=4,
                                 normalize_mean_std=MEAN_STD, **kwargs)
        for i, arr in enumerate(arrays):
            ext.add(i, arr)
        return ext.finish(len(arrays)), ext

    f32, _ = extracted()
    theirs = torch.from_numpy(np.ascontiguousarray(f32[:, 2:].T))
    ours, ext = extracted(compute_dtype=torch.bfloat16, dtype_guard=True,
                          mesh=_RankZeroOfTwo([-theirs, theirs]))
    own, _ = extracted(compute_dtype=torch.bfloat16)
    assert dtype_policy.cosine_rows_ok(own[:, :2].T, f32[:, :2].T)
    assert ext.guard_report["ok"] is False
    assert ext.guard_report["min_cosine"] < -0.99
    assert ext.compute_dtype is None
    assert dtype_policy.guard_decision(model) is False
    np.testing.assert_array_equal(ours[:, 2:], f32[:, 2:])
    np.testing.assert_allclose(ours[:, :2], f32[:, :2], rtol=1e-5,
                               atol=1e-6)


def test_train_guard_judges_the_whole_batch(on_a_card):
    """Two tuples, one a rank: rank 1's bfloat16 gradient is three times
    rank 0's float32 gradient negated (its float32 gradient rank 0's), so
    the summed gradients fail the cosine bar although rank 0's own pass
    it; the step keeps float32 from then on."""
    model = initialize_model(dict(ALEXNET), device="cpu", seed=0)
    network = CirNetwork(model, CirNetwork.NetworkParams(
        model={}, runtime={"wrappers": ""}))
    criterion = initialize_criterion({"loss": "contrastive", "margin": 0.7,
                                      "eps": 1e-6})
    rng = np.random.RandomState(6)
    images = [[rng.rand(64, 64, 3).astype(np.float32) for _ in range(3)]
              for _ in range(2)]
    targets = [np.array([-1.0, 1.0, 0.0], np.float32)] * 2

    def flat_grad(step):
        model.zero_grad(set_to_none=True)
        loss, _ = step.gradients(images, targets)
        return loss, torch.cat([p.grad.reshape(-1)
                                for p in model.parameters()])

    _, exact = flat_grad(TrainStep(network, criterion,
                                   compute_dtype="float32",
                                   mesh=_RankZeroOfTwo()))
    _, fast = flat_grad(TrainStep(network, criterion,
                                  compute_dtype="bfloat16",
                                  mesh=_RankZeroOfTwo()))
    assert float(dtype_policy.row_cosines(fast, exact)) \
        >= dtype_policy.TRAIN_GUARD_MIN_COSINE
    zero = torch.zeros(1)
    guarded = TrainStep(network, criterion, mesh=_RankZeroOfTwo(
        [[zero, zero, -3 * exact, exact]]))
    assert guarded.compute_dtype == torch.bfloat16 and guarded.guard_pending
    flat_grad(guarded)
    report = guarded.guard_reports[-1]
    assert report["ok"] is False and report["grad_cosine"] < -0.99
    assert guarded.compute_dtype is None
    assert dtype_policy.guard_decision(model, "train") is False


def test_zero_with_an_unsharded_optimizer_raises_at_world_two(launched):
    """ZeRO leaves each rank's gradients to the optimizer to reduce, so an
    optimizer without ``shard_state`` would step on a rank's share alone:
    the epoch raises before its first step. An ``OptimizerAlternation`` (a
    one-member ``composition`` section) raised so until it took
    ``shard_state``; now its epoch at world 2 equals one process's."""
    root, db = launched["root"], launched["db"]
    alternation = {"composition": {"type": "alternation",
                                   "alternate_iteration": None,
                                   "order": None}, "net": dict(SGD)}
    single, = train(_train_scenario(root / "zero_alternation1", db,
                                    optimizer=alternation), (),
                    device="cpu")
    metas = [rank[0] for rank in launched["zero_alternation"]()]
    assert all(meta == metas[0] for meta in metas)
    loss = "train/learning/loss:total_avg.4"
    np.testing.assert_allclose(metas[0]["metrics"][loss],
                               single["metrics"][loss], rtol=1e-5)
    ckpts = [root / run / "epochs" / "net_epoch_01.ckpt"
             for run in ("zero_alternation", "zero_alternation1")]
    ours, theirs = (load_checkpoint_any(c)["model_state"] for c in ckpts)
    for name, value in theirs.items():
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)

    network = CirNetwork(initialize_model(dict(ALEXNET), device="cpu",
                                          seed=0),
                         CirNetwork.NetworkParams(model=dict(ALEXNET),
                                                  runtime={
                                                      "wrappers": "",
                                                      "param_sharding":
                                                          "zero"}))
    epoch = SupervisedEpoch(types.SimpleNamespace(dataset=None),
                            initialize_criterion({"loss": "contrastive",
                                                  "margin": 0.7,
                                                  "eps": 1e-6}),
                            batch_average=False, fakebatch=True,
                            parallel={"data": 2})
    epoch.mesh = _RankZeroOfTwo()
    images, targets = _tuple_batch(np.random.RandomState(9), n_tuples=2,
                                   tuple_len=4, hw=64)
    with pytest.raises(TypeError, match="needs an optimizer with "
                       "shard_state, not a object"):
        epoch._optimization_step(network, object(), images, targets)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_zero_rule_matches_jax_on_its_tree(n):
    """``test_zero_shardings_rule``'s tree, at the worlds and JAX's 8."""
    tree = {"w": np.zeros((16, 3), np.float32),
            "b": np.zeros((3,), np.float32),
            "big": np.zeros((8, 24, 5), np.float32),
            "scalar": np.zeros((), np.float32)}
    shardings = zero_shardings(jax_make_mesh(n), tree)
    ours = zero_dims(((k, torch.from_numpy(v)) for k, v in tree.items()), n)
    assert ours == {k: _sharded_dim(s) for k, s in shardings.items()}


@pytest.mark.parametrize("n", WORLDS)
def test_zero_rule_matches_jax_on_a_short_resnet(n):
    """Every parameter of a (1, 1, 1, 1) ResNet101-GeM: the size of the
    dimension the port splits equals the size of the one JAX splits (the
    layouts differ, e.g. HWIO against OIHW kernels, so equal sizes are the
    rule's layout-free reading; 0 for none)."""
    params = dict(ALEXNET, cir_architecture="resnet101")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                   (jax_trunks.Bottleneck, (1, 1, 1, 1)))
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, (1, 1, 1, 1)))
        mp.setattr(JaxModel, "init", _shapes_only_init)
        jax_params = jax_initialize_model(dict(params)).params
        port_model = initialize_model(dict(params), device="cpu")
    shardings = zero_shardings(jax_make_mesh(n), jax_params)
    sizes = jax.tree.map(
        lambda leaf, s: np.full(leaf.shape, 0 if _sharded_dim(s) is None
                                else leaf.shape[_sharded_dim(s)], np.float32),
        jax_params, shardings)
    jax_sizes = {name: int(t.reshape(-1)[0]) if t.numel() else 0
                 for name, t in from_jax_variables({"params": sizes}).items()}
    named = list(port_model.named_parameters())
    ours = zero_dims(named, n)
    assert {name for name, _ in named} <= set(jax_sizes)
    split = 0
    for name, param in named:
        size = 0 if ours[name] is None else param.shape[ours[name]]
        assert size == jax_sizes[name], (name, size, jax_sizes[name])
        split += size > 0
    assert split > 0


@pytest.mark.parametrize("sharding", [None, "zero"])
def test_two_adam_steps_match_jax(launched, adam_state, sharding):
    """Two adam steps at world 2 against ``_grads_and_step``: the first
    batch's gradients, summed over the ranks, within rtol 1e-4, atol 1e-6
    of JAX's (the scale of the reduction: a sum of local means or a factor
    of the world would show here); the second step's loss within rtol
    1e-5, and each parameter's two-step update at cosine >= 0.9999 of
    JAX's. Elementwise the parameters do not hold rtol 1e-4, atol 1e-6:
    where one package's float32 gradient is exactly 0 and the other's
    ~5e-9 (the summation orders differ), adam's eps of 1e-8 turns the noise
    into up to a third of an update (about 50 of 600,000 elements of a
    conv, measured). ZeRO is held bit for bit against data parallelism
    instead, and its moments are split."""
    jax_grads = []  # each step's gradients, as JAX's step returns them
    gradients = JaxTrainStep.gradients

    def recording(self, *args, **kwargs):
        out = gradients(self, *args, **kwargs)
        jax_grads.append(jax.tree.map(np.asarray, out[1]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainStep, "gradients", recording)
        params, _grads, _opt, loss = _grads_and_step(jax_make_mesh(8),
                                                     sharding)
    index = 4 if sharding is None else 5
    ranks = _ranks(launched, 2)
    runs = [rank[index] for rank in ranks]
    run = runs[0]
    ref_grads = from_jax_variables({"params": jax_grads[0]})
    assert ref_grads.keys() == run["grads"].keys()
    for name, value in ref_grads.items():
        np.testing.assert_allclose(run["grads"][name].numpy(),
                                   value.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(run["losses"][-1], loss, rtol=1e-5)
    ref = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    start = adam_state[sharding]["net"]["model_state"]
    assert ref.keys() <= run["model"].keys()
    for name in ref:
        ours, theirs = (t.double() - start[name].double()
                        for t in (run["model"][name], ref[name]))
        cosine = float((ours * theirs).sum() / (ours.norm() * theirs.norm()))
        assert cosine >= 0.9999, (name, cosine)
    for other in runs[1:]:  # the same losses and parameters on every rank
        assert other["losses"] == run["losses"]
        for name, value in run["grads"].items():
            assert torch.equal(other["grads"][name], value), name
        for name, value in run["model"].items():
            assert torch.equal(other["model"][name], value), name
    if sharding == "zero":
        dp = ranks[0][4]
        assert run["losses"] == dp["losses"]
        for name, value in dp["model"].items():
            assert torch.equal(run["model"][name], value), name
        ours, theirs = (r["optimizer"]["torch_state"]["state"]
                        for r in (run, dp))
        for index, entry in theirs.items():
            for key, value in entry.items():
                assert torch.equal(ours[index][key], value), (index, key)
        for other in runs:  # each rank's moments: split tensors halved
            assert other["moment_shapes"] != dp["moment_shapes"]
            assert all(a == b or np.prod(a) * 2 == np.prod(b) for a, b
                       in zip(other["moment_shapes"], dp["moment_shapes"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_extraction_matches_jax(networks, images, launched, route,
                                        world):
    """Every rank returns the whole matrix. The plain and composed routes
    agree with JAX's 8-device run within rtol 1e-4, atol 1e-6. On the lab
    CLAHE route JAX's chain compiled by XLA on the CPU moves single CLAHE
    pixels by one level (``tests/test_torch_train_step.py``), about 1e-5 in
    the descriptors, so there the sharded run is held within rtol 1e-4,
    atol 1e-6 of the port's single-process run (cv2-exact,
    ``tests/test_torch_clahe.py``) and within ``test_torch_extract``'s
    CLAHE tolerance (atol 1e-4) of JAX's."""
    jax_net, state = networks[route]
    ref = jax_extract(jax_net, images, IMAGE_SIZE,
                      jax_transforms(ROUTES[route], MEAN_STD), batch_size=2,
                      mesh=jax_make_mesh(8))
    ranks = _ranks(launched, world)
    index = list(ROUTES).index(route)
    for rank in ranks:  # every rank holds the whole matrix
        np.testing.assert_array_equal(rank[index], ranks[0][index])
    ours = ranks[0][index]
    assert ours.shape == (256, len(images))
    if route != "lab_clahe":
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
        return
    single = dryrun.sharded_descriptors(state, images, IMAGE_SIZE,
                                        ROUTES[route], MEAN_STD, 2,
                                        device=torch.device("cpu"))
    np.testing.assert_allclose(ours, single, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ranks_equal_jax(launched, ranking_inputs, world):
    vecs, qvecs = ranking_inputs
    ref = np.asarray(jax_rank_sharded(vecs, qvecs, jax_make_mesh(8)))
    single = rank_database(torch.from_numpy(vecs),
                           torch.from_numpy(qvecs)).numpy()
    for rank in _ranks(launched, world):
        np.testing.assert_array_equal(rank[3], ref)
        np.testing.assert_array_equal(rank[3], single)


def test_zero_state_dict_resumes_at_world_one(launched, adam_state):
    """ZeRO's first step at world 2, its gathered state dict resumed in one
    process for the second step: the two-step world-2 run's parameters
    and moments."""
    first = _ranks(launched, 2)[0][6]
    straight = _ranks(launched, 2)[0][5]
    batches = _adam_batches()
    state = {"net": dict(adam_state["zero"]["net"],
                         model_state=first["model"])}
    resumed = dryrun.train_steps(state, batches[1:], ADAM,
                                 optimizer_state=first["optimizer"],
                                 device=torch.device("cpu"))
    np.testing.assert_allclose(resumed["losses"], straight["losses"][1:],
                               rtol=1e-5)
    for name, value in straight["model"].items():
        np.testing.assert_allclose(resumed["model"][name].numpy(),
                                   value.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    ours, theirs = (run["optimizer"]["torch_state"]["state"]
                    for run in (resumed, straight))
    assert ours.keys() == theirs.keys()
    for index, entry in theirs.items():
        for key, value in entry.items():
            assert ours[index][key].shape == value.shape, (index, key)
            np.testing.assert_allclose(ours[index][key].numpy(),
                                       value.numpy(), rtol=1e-4, atol=1e-9)


def test_train_stage_epoch_at_world_two_equals_one_process(launched):
    """One epoch of the train stage (mining, 2 steps, ZeRO) at world 2:
    every rank returns the same metadata, and rank 0's checkpoint equals
    the one-process run's."""
    root, db = launched["root"], launched["db"]
    single, = train(_train_scenario(root / "world1", db), (), device="cpu")
    metas = [rank[7][0] for rank in _ranks(launched, 2)]
    assert all(meta == metas[0] for meta in metas)
    loss = "train/learning/loss:total_avg.4"
    np.testing.assert_allclose(metas[0]["metrics"][loss],
                               single["metrics"][loss], rtol=1e-5)
    ckpts = {w: root / ("world%d" % w) / "epochs" for w in (1, 2)}
    net = {w: load_checkpoint_any(ckpts[w] / "net_epoch_01.ckpt")
           for w in ckpts}
    for name, value in net[1]["model_state"].items():
        np.testing.assert_allclose(net[2]["model_state"][name].numpy(),
                                   value.numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)
    training = {w: load_checkpoint_any(ckpts[w] / "learning_epoch_01.ckpt")
                for w in ckpts}
    moments = {w: training[w]["training"]["optimizer_state"]["torch_state"]
               ["state"] for w in ckpts}
    assert moments[1].keys() == moments[2].keys()
    for index, entry in moments[1].items():
        np.testing.assert_allclose(
            moments[2][index]["momentum_buffer"].numpy(),
            entry["momentum_buffer"].numpy(), rtol=1e-4, atol=1e-7)
    assert sorted(os.listdir(ckpts[2])) == sorted(os.listdir(ckpts[1]))


def test_dryrun_multicard_on_two_cpu_processes(launched):
    """Launched on two fresh processes, and run in place by the ranks of a
    group of two (as a ``torchrun`` job would): the same lines."""
    lines = launched["dryrun"]()
    assert len(lines) == 4 and all("dryrun_multicard(2)" in x for x in lines)
    assert "ZeRO step" in lines[-1]
    for rank in _ranks(launched, 2):
        assert rank[8] == lines

def test_entry_forward_on_the_cpu():
    """``dryrun.entry``: the ResNet101-GeM forward (layers cut to (1, 1, 1,
    1)) on its padded pair, noise in each valid extent; the second image's
    row equals its valid crop's alone (the masks keep the zero padding
    inert)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, (1, 1, 1, 1)))
        forward, (batch, valid) = dryrun.entry("cpu")
        h, w = valid[1].tolist()
        x = batch + torch.rand(batch.shape,
                               generator=torch.Generator().manual_seed(0))
        x[1, :, h:], x[1, :, :, w:] = 0, 0
        out = forward(x, valid)
        alone = forward(x[1:, :, :h, :w].contiguous(), valid[1:])
    assert out.shape == (2, 2048) and torch.isfinite(out).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(out, dim=1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(out[1:], alone, rtol=1e-4, atol=1e-5)
