"""Data parallelism of whole-batch networks on ``torch.distributed``: live
BatchNorm over the group, the joint N/D step of a composition and the
image-pair step of a U-Net on a mesh, and ZeRO under an optimizer
alternation. The port runs as gloo worlds of CPU processes
(``parallel/mesh.py::launch``), held against one process and against the
JAX package's whole-batch ``TrainStep`` on its virtual CPU mesh
(``tests/conftest.py``), from the same numpy-seeded inputs and weights:

* (a) ``BatchNorm2d`` at world 2 on unequal halves with zero-padded cells,
  against one process on the whole batch (rtol 1e-5) and against flax's
  ``nn.BatchNorm`` (atol 1e-5): outputs, input and affine gradients,
  running statistics;
* (b) the joint step (a P2pUNet translator at one nested level, its
  BatchNorm live, then a frozen AlexNet-GeM; adam through
  ``OptimizerAlternation``) at world 2, DP and ZeRO, against JAX's step on
  a 2-device mesh, both in float64, on 3 tuples of 2 images (a tuple cut
  across the ranks): losses at rtol 1e-5, the first batch's gradients at
  rtol 1e-4, atol 1e-6 (a wrong scale of the reduction shows there), the
  weights and BatchNorm statistics after two adam steps within 1e-5;
* (c) the translator's L1 step on image pairs the same way;
* (d) the alternation's ZeRO state dict at world 2 (``alternate_iteration``
  1, both members trained; float64): the single-card format, resumed at
  world 1;
* (e) the train stage on JAX's ZeRO scenario
  (``tests/test_e2e_joint_train.py:169-240``: 3 tuples of 3 images over 3
  ranks) against one process, rank 0 writing the checkpoint;
* (f) with dropout 0.5, each rank draws its masks from seed 0 plus its
  rank, and a world of one from seed 0, as before.

The ranks run ``dryrun.train_steps`` and the parts of
``tests/whole_batch_ranks.py``, which import no JAX. Each world is one
launch, started before the first test beside the JAX work.
"""
import concurrent.futures
import functools
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as jnn
from jax import enable_x64

from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.learning.network import SequentialNetwork as JaxSequential
from mdir_tpu.learning.network import SingleNetwork as JaxSingle
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.ops.preprocess import chain_from_transform as jax_chain
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion
from mdir_tpu.optim.optimizers import initialize_optimizer as \
    jax_initialize_optimizer
from mdir_tpu.parallel.mesh import make_mesh as jax_make_mesh

import whole_batch_ranks as parts
from mdir_tpu_torch import dryrun
from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning.checkpoints import load_checkpoint_any
from mdir_tpu_torch.learning.network import (SequentialNetwork,
                                             SingleNetwork,
                                             initialize_network)
from mdir_tpu_torch.models.convert import (from_jax_variables,
                                           to_jax_variables)
from mdir_tpu_torch.models.layers import BatchNorm2d
from mdir_tpu_torch.ops.preprocess import RawChainInput, chain_from_transform
from mdir_tpu_torch.parallel.mesh import launch
from mdir_tpu_torch.stages.train import train

WORLD = 2
TIMEOUT_S = 300
CPU = torch.device("cpu")
MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
PLAIN = "pil2np | totensor | normalize"
CONTRASTIVE = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
L1 = {"loss": "l1"}
ADAM = {"algorithm": "adam", "lr": 1e-3, "weight_decay": 0}
ALEXNET = {"architecture": "cirnet", "cir_architecture": "alexnet",
           "local_whitening": False, "pooling": "gem", "regional": False,
           "whitening": False, "pretrained": False}
UNET = {"architecture": "p2p_unet", "in_channels": 3, "out_channels": 3,
        "nested_levels": 1}
LOSS = "train/learning/loss:total_avg.4"


@pytest.fixture(autouse=True, scope="module")
def _one_thread_no_jax_init():
    """JAX compiles out of the persistent cache, torch on one thread, and no
    JAX init compile (every JAX weight is the port's)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old, threads = getattr(jax.config, key), torch.get_num_threads()
    jax.config.update(key, 1e9)
    torch.set_num_threads(1)

    def init(self, rng, sample_hw=(64, 64)):
        dummy = jnp.zeros((1,) + tuple(sample_hw)
                          + (self.meta.get("in_channels", 3),), jnp.float32)
        shapes = jax.eval_shape(self.module.init, {"params": rng}, dummy)
        self.variables = jax.tree.map(
            lambda leaf: np.zeros(leaf.shape, leaf.dtype), shapes)
        return self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", init)
        yield
    jax.config.update(key, old)
    torch.set_num_threads(threads)


def translator(model=UNET, runtime=None):
    return {"type": "SingleNetwork", "path": None, "model": dict(model),
            "initialize": {"weights": "default", "seed": 0},
            "runtime": dict(runtime or {}, wrappers="",
                            data={"mean_std": MEAN_STD, "transforms": PLAIN})}


def single(cls, spec):
    """A network of ``cls`` from a member's section."""
    spec.pop("type")
    return cls.initialize(spec, "cpu") if cls is SingleNetwork \
        else cls.initialize(spec)


def composition(runtime=None):
    """The joint N/D composition at test size (``test_torch_joint_train``'s)
    with an optional composition-level runtime."""
    params = {
        "sequence": "translate,embed", "translate": translator(),
        "embed": {"type": "CirNetwork", "path": None, "model": dict(ALEXNET),
                  "initialize": {"weights": "default", "seed": 0},
                  "runtime": {"wrappers": {"train": "cirfaketuplebatch",
                                           "eval": "cirfaketuplebatch"}}}}
    if runtime:
        params["runtime"] = dict(runtime)
    return params


def alternation(embed=False, alternate=None, order=None):
    """Adam on the translator, the embedder frozen unless ``embed``."""
    return {"composition": {"type": "alternation",
                            "alternate_iteration": alternate,
                            "order": order},
            "translate": dict(ADAM), "embed": dict(ADAM) if embed else None}


ALTERNATING = alternation(embed=True, alternate=1, order="translate,embed")


@pytest.fixture(scope="module")
def states():
    """The port's checkpoint states, from seed 0: the composition (its
    translator's BatchNorm terms and statistics moved off their defaults)
    and the same under ZeRO (the composition's runtime routed to its tail),
    that translator alone (and under ZeRO), and a translator with dropout
    0.5 at five nested levels."""
    rng = np.random.RandomState(2)
    joint = SequentialNetwork.initialize(composition(), device="cpu")
    unet = joint.networks["translate"].model
    with torch.no_grad():
        for bn in (m for m in unet.modules() if type(m) is BatchNorm2d):
            for t in (bn.weight, bn.bias):
                t.add_(torch.from_numpy(0.1 * rng.randn(*t.shape)))
            for t in (bn.running_mean, bn.running_var):
                t.copy_(torch.from_numpy(rng.rand(*t.shape) * 0.5 + 0.1))
    out = {"joint": joint.state_dict()}
    zero = SequentialNetwork.initialize(composition(
        {"param_sharding": "zero"}), device="cpu")
    assert zero.network_params.runtime["param_sharding"] == "zero"
    zero.networks["translate"].model.load_state_dict(unet.state_dict())
    out["joint_zero"] = zero.state_dict()
    for key, runtime in (("pairs", None),
                         ("pairs_zero", {"param_sharding": "zero"})):
        net = single(SingleNetwork, translator(runtime=runtime))
        net.model.load_state_dict(unet.state_dict())
        out[key] = net.state_dict()
    out["dropout"] = single(SingleNetwork, translator(dict(
        UNET, nested_levels=5, dropout=0.5))).state_dict()
    return out


def joint_batches():
    """Two batches of 3 tuples of 2 uint8 images, 40-64 px: one 64 x 64
    bucket each."""
    out = []
    for seed in (0, 1):
        rng = np.random.RandomState(seed)
        out.append(([[rng.randint(0, 256, (rng.randint(40, 65),
                                           rng.randint(40, 65), 3))
                      .astype(np.uint8) for _ in range(2)]
                     for _ in range(3)],
                    [np.array([-1, 1], np.float32)] * 3))
    return out


def raw(batches):
    """The port's items of a lowered chain: raw uint8 tuples."""
    return [([RawChainInput()(*tpl) for tpl in images], targets)
            for images, targets in batches]


def pair_batches(count=2, n=4, side=32):
    """``count`` batches of ``n`` (input, target) float64 image pairs."""
    rng = np.random.RandomState(3)
    return [([rng.rand(side, side, 3) * 2 - 1 for _ in range(n)],
             [rng.rand(side, side, 3) * 2 - 1 for _ in range(n)])
            for _ in range(count)]


def dropout_pairs():
    """Two float32 pairs of 64 x 64 images: the five-level U-Net's
    smallest input."""
    inputs, targets = pair_batches(1, 2, 64)[0]
    return ([a.astype(np.float32) for a in inputs],
            [a.astype(np.float32) for a in targets])


def bn_inputs():
    """(N, C, H, W) float32 in halves of unequal content with zero-padded
    cells, an upstream gradient, and a BatchNorm state off its defaults."""
    rng = np.random.RandomState(4)
    x = (rng.randn(6, 5, 7, 6) * 2 + 0.5).astype(np.float32)
    x[3:] = x[3:] * 0.3 - 1.5
    x[1, :, 5:], x[4, :, :, 4:] = 0, 0
    up = rng.randn(*x.shape).astype(np.float32)
    state = {"weight": rng.rand(5) + 0.5, "bias": rng.randn(5),
             "running_mean": rng.randn(5), "running_var": rng.rand(5) + 0.2}
    return x, up, {k: torch.from_numpy(v.astype(np.float32))
                   for k, v in state.items()}


def _png_db(root):
    """12 PNGs (48 x 48, 6 clusters of 2 of one base colour) and their
    split: queries 0, 2, 4."""
    from PIL import Image

    rng = np.random.RandomState(5)
    cids = []
    for i in range(12):
        if i % 2 == 0:
            base = rng.randint(0, 200, (1, 1, 3))
        img = np.clip(base + rng.randint(0, 56, (48, 48, 3)), 0, 255)
        cids.append(str(root / ("im%02d.png" % i)))
        Image.fromarray(img.astype(np.uint8)).save(cids[-1])
    path = root / "db.pkl"
    with open(path, "wb") as handle:
        pickle.dump({"train": {"cids": cids,
                               "cluster": [i // 2 for i in range(12)],
                               "qidxs": [0, 2, 4], "pidxs": [1, 3, 5]}},
                    handle)
    return str(path)


def stage_scenario(directory, db, parallel=None):
    """JAX's ``test_joint_training_alternation_zero_sharded``: a pixelconv
    translator and a frozen AlexNet-GeM, ``param_sharding: zero`` on the
    composition, adam, contrastive, 3 tuples of 3 images a batch, one
    epoch."""
    epoch = {"type": "SupervisedEpoch", "data": "train",
             "criterion": "default", "batch_average": False,
             "fakebatch": True}
    if parallel:
        epoch["parallel"] = {"data": parallel}
    network = composition({"param_sharding": "zero"})
    network["translate"]["model"] = {
        "architecture": "pixelconv_regr", "in_channels": 3,
        "out_channels": 3, "hidden": [8]}
    network["translate"]["initialize"] = {"weights": "he_normal", "seed": 0}
    optimizer = alternation()
    optimizer["translate"]["lr"] = 1e-4
    return {
        "network": dict(network, type="SequentialNetwork"),
        "learning": {
            "type": "TrainValLearning",
            "checkpoints": {"directory": str(directory), "store_every": 0,
                            "checkpoint_every": 1},
            "training": {
                "type": "EpochTraining", "epochs": 1, "deterministic": True,
                "seed": 0, "criterion": dict(CONTRASTIVE),
                "optimizer": optimizer, "scheduler": None,
                "epoch_iteration": epoch},
            "validation": False},
        "output": {"learning": {"progress": {"print_each": 100}}},
        "data": {"train": {
            "mean_std": MEAN_STD, "transforms": PLAIN,
            "dataset": {"name": "CirTuples", "dataset": "retrieval-SfM-tiny",
                        "split": "train", "image_size": 48, "neg_num": 1,
                        "dataset_pkl": db, "image_dir": None,
                        "query_size": 3, "pool_size": 12},
            "loader": {"batch_size": 3, "num_workers": 0}}},
    }


CHAIN = chain_from_transform(initialize_transforms(PLAIN, MEAN_STD))
JOINT64 = functools.partial(parts.in_float64, functools.partial(
    dryrun.train_steps, criterion=CONTRASTIVE, chain=CHAIN))
PAIRS64 = functools.partial(parts.in_float64, functools.partial(
    dryrun.train_steps, criterion=L1))
# world 2's calls, in order; ``_rank_results(launched, name)`` reads one
CALLS = ("batchnorm", "joint_dp", "joint_zero", "pairs_dp", "pairs_zero",
         "alternating_first", "alternating", "dropout")


@pytest.fixture(autouse=True, scope="module")
def launched(states, tmp_path_factory):
    """The launches, on threads beside the JAX work: world 2 runs CALLS in
    turn, world 3 the train stage (e). ``launched[world]()`` waits for a
    world's results."""
    root = tmp_path_factory.mktemp("whole_batch")
    db = _png_db(root)
    x, up, bn_state = bn_inputs()
    joint = raw(joint_batches())
    inputs, targets = dropout_pairs()
    args = {
        "batchnorm": (parts.batchnorm_rank, (bn_state, x, up)),
        "joint_dp": (JOINT64, (states["joint"], joint, alternation())),
        "joint_zero": (JOINT64, (states["joint_zero"], joint,
                                 alternation())),
        "pairs_dp": (PAIRS64, (states["pairs"], pair_batches(), ADAM)),
        "pairs_zero": (PAIRS64, (states["pairs_zero"], pair_batches(),
                                 ADAM)),
        "alternating_first": (JOINT64, (states["joint_zero"], joint[:1],
                                        ALTERNATING)),
        "alternating": (JOINT64, (states["joint_zero"], joint,
                                  ALTERNATING)),
        "dropout": (parts.dropout_step, (states["dropout"], inputs, targets,
                                         ADAM))}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {
        WORLD: pool.submit(launch, dryrun.in_turn, WORLD, "cpu", args=(
            [args[name] for name in CALLS],), timeout=TIMEOUT_S),
        3: pool.submit(launch, train, 3, "cpu", args=(
            stage_scenario(root / "world3", db, 3), ()), timeout=TIMEOUT_S)}
    yield dict({key: future.result for key, future in futures.items()},
               root=root, db=db)
    pool.shutdown(wait=True)


def _rank_results(launched, name):
    """Each rank's result of world 2's call ``name``."""
    return [rank[CALLS.index(name)] for rank in launched[WORLD]()]


def _close(ours, ref, rtol, atol, what):
    assert ours.keys() == ref.keys(), (what, sorted(ours), sorted(ref))
    for name, value in ref.items():
        np.testing.assert_allclose(np.asarray(ours[name], np.float64),
                                   np.asarray(value, np.float64), rtol=rtol,
                                   atol=atol, err_msg="%s %s" % (what, name))


def test_batchnorm_over_the_group_is_the_whole_batchs(launched):
    """(a) Each rank's rows of the output and of the input gradient, the
    affine gradients summed over the ranks, and the running statistics
    (equal on both ranks), against one process on the whole batch and
    against flax; a deep copy of the layer keeps its mesh (a process group
    cannot be copied)."""
    x, up, state = bn_inputs()
    halves = _rank_results(launched, "batchnorm")
    assert all(h.pop("copy_shares_mesh") for h in halves)
    ours = {"out": np.concatenate([h["out"] for h in halves]),
            "x_grad": np.concatenate([h["x_grad"] for h in halves]),
            "weight_grad": sum(h["weight_grad"] for h in halves),
            "bias_grad": sum(h["bias_grad"] for h in halves),
            "running_mean": halves[0]["running_mean"],
            "running_var": halves[0]["running_var"]}
    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(halves[1][key], halves[0][key])
    one = parts.batchnorm_rank(state, x, up, device=CPU)
    del one["copy_shares_mesh"]
    _close(ours, one, 1e-5, 1e-6, "one process")

    params = {"scale": state["weight"].numpy(), "bias": state["bias"].numpy()}
    stats = {"mean": state["running_mean"].numpy(),
             "var": state["running_var"].numpy()}
    bn = jnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)

    def forward(p, h):
        return bn.apply({"params": p, "batch_stats": stats}, h,
                        mutable=["batch_stats"])

    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    out, mutated = forward(params, nhwc)
    _, pullback = jax.vjp(lambda p, h: forward(p, h)[0], params, nhwc)
    grads, x_grad = pullback(jnp.asarray(up.transpose(0, 2, 3, 1)))
    flax = {"out": np.asarray(out).transpose(0, 3, 1, 2),
            "x_grad": np.asarray(x_grad).transpose(0, 3, 1, 2),
            "weight_grad": np.asarray(grads["scale"]),
            "bias_grad": np.asarray(grads["bias"]),
            "running_mean": np.asarray(mutated["batch_stats"]["mean"]),
            "running_var": np.asarray(mutated["batch_stats"]["var"])}
    _close(ours, flax, 0, 1e-5, "flax")


def _jax_steps(jax_net, models, batches, optimizer_params, criterion,
               chain):
    """JAX's whole-batch step on a 2-device mesh in float64, each batch's
    update and BatchNorm statistics written back, as JAX's epoch does:
    the losses, the first batch's gradients and the trained members'
    variables after the last batch (``models``: trained member -> its
    Model; a single net's as ``"net"``)."""
    composed = hasattr(jax_net, "networks")
    with enable_x64():
        every = [m.model for m in jax_net.networks.values()] if composed \
            else [jax_net.model]
        for model in every:
            model.variables = jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), model.variables)
        optimizer = jax_initialize_optimizer(jax_net, dict(optimizer_params))
        step = JaxTrainStep(jax_net, jax_criterion(criterion),
                            batch_average=False, device_chain=chain,
                            mesh=jax_make_mesh(WORLD))
        losses, first = [], None
        for images, targets in batches:
            if chain is not None:
                images = [[chain.host_input(img) for img in tpl]
                          for tpl in images]
            batch, valid, tgt, _ = jax_prepare_batch(images, targets)
            params = {name: m.params for name, m in models.items()} \
                if composed else models["net"].params
            (loss, aux), grads = step.gradients(params, batch, valid, tgt,
                                                jax.random.PRNGKey(0))
            losses.append(float(loss))
            if first is None:
                first = jax.tree.map(np.asarray, grads)
            new = optimizer.apply(params, grads)
            for name, model in models.items():
                model.replace_params(new[name] if composed else new)
                stats = aux.get(name)
                if stats is not None:
                    model.variables = {**model.variables,
                                       "batch_stats": stats}
        variables = {name: jax.tree.map(np.asarray, m.variables)
                     for name, m in models.items()}
    if not composed:
        first = {"net": first}
    prefix = "translate." if composed else ""
    return (losses,
            {prefix + k: v.numpy() for name in first for k, v in
             from_jax_variables({"params": first[name]}).items()},
            {prefix + k: v.numpy() for name in variables for k, v in
             from_jax_variables(variables[name]).items()})


def _carried(port_model, jax_model):
    """The port model's weights in the JAX model."""
    jax_model.variables = to_jax_variables(
        port_model.state_dict(), jax.tree.map(np.asarray,
                                              jax_model.variables))


@pytest.fixture(scope="module")
def jax_joint(states):
    """(b) JAX's joint step on a 2-device mesh, translator trained."""
    jax_net = JaxSequential.initialize(composition())
    port = initialize_network(None, "cpu", states["joint"])
    for name in jax_net.sequence:
        _carried(port.networks[name].model, jax_net.networks[name].model)
    return _jax_steps(jax_net, {"translate": jax_net.networks[
        "translate"].model}, joint_batches(), alternation(), CONTRASTIVE,
        jax_chain(jax_transforms(PLAIN, MEAN_STD)))


@pytest.fixture(scope="module")
def jax_pairs(states):
    """(c) JAX's L1 step of the translator on the pairs, on the mesh."""
    jax_net = single(JaxSingle, translator())
    _carried(initialize_network(None, "cpu", states["pairs"]).model,
             jax_net.model)
    return _jax_steps(jax_net, {"net": jax_net.model},
                      [(np.stack(images), np.stack(targets))
                       for images, targets in pair_batches()],
                      ADAM, L1, None)


def _held_against_jax(runs, ref):
    """Every rank alike; losses rtol 1e-5, first gradients rtol 1e-4 /
    atol 1e-6, weights and BatchNorm statistics after two adam steps
    within 1e-5 of JAX's."""
    losses, grads, variables = ref
    for other in runs[1:]:
        assert other["losses"] == runs[0]["losses"]
        for name, value in runs[0]["model"].items():
            assert torch.equal(other["model"][name], value), name
    run = runs[0]
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)
    _close({k: v.numpy() for k, v in run["grads"].items()}, grads, 1e-4,
           1e-6, "first gradients")
    assert any(k.endswith("running_var") for k in variables)
    _close({k: run["model"][k].numpy() for k in variables}, variables, 0,
           1e-5, "after two steps")


@pytest.mark.parametrize("call", ["joint_dp", "joint_zero"])
def test_joint_step_matches_jax_mesh(launched, jax_joint, states, call):
    """(b) The joint step at world 2, DP and ZeRO; the frozen embedder gets
    no gradient and does not move."""
    runs = _rank_results(launched, call)
    _held_against_jax(runs, jax_joint)
    assert not any(k.startswith("embed.") for k in runs[0]["grads"])
    start = initialize_network(None, "cpu", states["joint"])
    for name, value in start.networks["embed"].model.state_dict().items():
        assert torch.equal(runs[0]["model"]["embed." + name].float(),
                           value), name


@pytest.mark.parametrize("call", ["pairs_dp", "pairs_zero"])
def test_image_pair_step_matches_jax_mesh(launched, jax_pairs, call):
    """(c) The translator's L1 step on 4 pairs at world 2, DP and ZeRO."""
    _held_against_jax(_rank_results(launched, call), jax_pairs)


def test_alternation_zero_state_resumes_at_world_one(launched, states):
    """(d) Alternating every step, both members trained, ZeRO at world 2:
    the first step's gathered state dict has the single-card format and
    values, and resumed in one process for the second step (the embedder
    stepping) gives the two-step world-2 run's losses, weights and
    moments."""
    first = _rank_results(launched, "alternating_first")[0]
    straight = _rank_results(launched, "alternating")[0]
    joint = raw(joint_batches())
    single = JOINT64(states["joint_zero"], joint[:1], ALTERNATING,
                     device=CPU)
    ours, theirs = first["optimizer"], single["optimizer"]
    assert ours.keys() == theirs.keys() == {"translate", "embed",
                                            "alternation"}
    assert ours["alternation"] == {"iteration": 1, "optimizer": 1}
    for member in ("translate", "embed"):
        a, b = (s[member]["torch_state"] for s in (ours, theirs))
        assert a["param_groups"] == b["param_groups"]
        assert a["state"].keys() == b["state"].keys()
        for index, entry in b["state"].items():
            for key, value in entry.items():
                assert a["state"][index][key].shape == value.shape
                np.testing.assert_allclose(a["state"][index][key].numpy(),
                                           value.numpy(), rtol=1e-4,
                                           atol=1e-9, err_msg=(member, key))
    assert not theirs["embed"]["torch_state"]["state"]  # not stepped yet

    with parts.float64():  # the first step's weights kept in float64
        network = initialize_network(None, "cpu", states["joint_zero"])
        for name in network.sequence:
            network.networks[name].model.load_state_dict({
                k[len(name) + 1:]: v for k, v in first["model"].items()
                if k.startswith(name + ".")})
        state = network.state_dict()
    resumed = JOINT64(state, joint[1:], ALTERNATING, optimizer_state=ours,
                      device=CPU)
    np.testing.assert_allclose(resumed["losses"], straight["losses"][1:],
                               rtol=1e-5)
    _close({k: v.numpy() for k, v in resumed["model"].items()},
           {k: v.numpy() for k, v in straight["model"].items()}, 1e-4, 1e-6,
           "resumed weights")
    for member in ("translate", "embed"):
        a, b = (run["optimizer"][member]["torch_state"]["state"]
                for run in (resumed, straight))
        assert a.keys() == b.keys() and b
        for index, entry in b.items():
            for key, value in entry.items():
                np.testing.assert_allclose(a[index][key].numpy(),
                                           value.numpy(), rtol=1e-4,
                                           atol=1e-9, err_msg=(member, key))
    assert resumed["optimizer"]["alternation"] \
        == straight["optimizer"]["alternation"] \
        == {"iteration": 2, "optimizer": 0}


def test_train_stage_zero_scenario_at_world_three_equals_one(launched):
    """(e) JAX's ZeRO scenario at world 3 (one tuple of 3 images a rank):
    every rank returns the same metadata, its loss within rtol 1e-5 of one
    process's, and rank 0's checkpoint files and weights those of the
    one-process run."""
    root, db = launched["root"], launched["db"]
    single, = train(stage_scenario(root / "world1", db), (), device="cpu")
    metas = [rank[0] for rank in launched[3]()]
    assert all(meta == metas[0] for meta in metas)
    np.testing.assert_allclose(metas[0]["metrics"][LOSS],
                               single["metrics"][LOSS], rtol=1e-5)
    ckpts = {w: root / ("world%d" % w) / "epochs" for w in (1, 3)}
    assert sorted(os.listdir(ckpts[3])) == sorted(os.listdir(ckpts[1]))
    nets = {w: load_checkpoint_any(ckpts[w] / "translate_epoch_01.ckpt")
            ["model_state"] for w in ckpts}
    _close({k: v.numpy() for k, v in nets[3].items()},
           {k: v.numpy() for k, v in nets[1].items()}, 1e-4, 1e-7,
           "translator")
    moments = {w: load_checkpoint_any(ckpts[w] / "learning_epoch_01.ckpt")[
        "training"]["optimizer_state"]["translate"]["torch_state"]["state"]
        for w in ckpts}
    assert moments[3].keys() == moments[1].keys() and moments[1]
    for index, entry in moments[1].items():
        np.testing.assert_allclose(moments[3][index]["exp_avg"].numpy(),
                                   entry["exp_avg"].numpy(), rtol=1e-4,
                                   atol=1e-9)


def test_dropout_masks_per_rank(launched, states):
    """(f) Dropout 0.5 in a step at world 2: rank r's mask is drawn from
    seed r (the ranks' masks differ), the update is the same on both ranks;
    a world of one draws from seed 0, as before."""
    runs = _rank_results(launched, "dropout")
    inputs, targets = dropout_pairs()
    one = parts.dropout_step(states["dropout"], inputs, targets, ADAM,
                             device=CPU)
    for seed, run in [(0, one)] + list(enumerate(runs)):
        assert run["seed"] == seed
        drawn = torch.rand(run["kept"].shape, generator=torch.Generator()
                           .manual_seed(seed)).numpy() < 0.5
        nonzero = run["nonzero"]
        assert nonzero.mean() > 0.9
        np.testing.assert_array_equal(run["kept"][nonzero], drawn[nonzero])
    assert not np.array_equal(runs[0]["kept"], runs[1]["kept"])
    for name, value in runs[0]["model"].items():
        assert torch.equal(runs[1]["model"][name], value), name
