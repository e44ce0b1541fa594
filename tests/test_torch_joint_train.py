"""Training the composition (the paper's "U-Net jointly N/D"): a P2pUNet
translator, then an AlexNet-GeM embedder, as a ``SequentialNetwork`` under
an ``OptimizerAlternation``, in the port against the JAX package.

* One joint step (translator trained, ``embed: null``) on a tuple batch of
  mixed sizes, raw uint8 through the normalize chain, the whole batch as one
  bucket (the embedder without valid extents, as JAX's step runs it), from
  the same weights in float64: the loss at rtol 1e-5, the translator's
  weights after an SGD step and its BatchNorm statistics within 1e-5, the
  embedder's weights bit-unchanged and given no gradient.
* Alternation with both members trained (``alternate_iteration`` 1, and 2):
  which member moves at each step, and the counters, equal the JAX
  package's ``OptimizerAlternation``; a member's optimizer state and the
  counters survive ``state_dict``.
* A multi-network checkpoint: two epochs resumed to three equal three
  straight epochs (losses, every member's weights and statistics), with the
  JAX package's files (``_network_names``, the frozen member stored once).
* ``cirnet_branched``, the next slice's net, still raises.
"""
import copy
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import enable_x64

from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.learning.network import SequentialNetwork as JaxSequential
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.ops.preprocess import chain_from_transform as jax_chain
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion
from mdir_tpu.optim.optimizers import OptimizerAlternation as JaxAlternation
from mdir_tpu.optim.optimizers import initialize_optimizer as \
    jax_initialize_optimizer

from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning import checkpoints, train_step
from mdir_tpu_torch.learning.network import SequentialNetwork
from mdir_tpu_torch.learning.train_step import TrainStep
from mdir_tpu_torch.models.convert import from_jax_variables, \
    to_jax_variables
from mdir_tpu_torch.ops.preprocess import RawChainInput, chain_from_transform
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.optim.optimizers import (OptimizerAlternation,
                                             initialize_optimizer)
from mdir_tpu_torch.stages.train import train

MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
PLAIN = "pil2np | totensor | normalize"
CRITERION = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
LR = 0.05
LOSS = "train/learning/loss:total_avg.4"


@pytest.fixture(autouse=True, scope="module")
def _one_thread_no_jax_cache():
    """JAX compiles out of the persistent cache, torch on one thread, and no
    JAX init compile: every JAX weight is overwritten with the port's (the
    shapes come from ``jax.eval_shape``)."""
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


def composition(embed_wrappers=None):
    return {
        "sequence": "translate,embed",
        "translate": {
            "type": "SingleNetwork", "path": None,
            "model": {"architecture": "p2p_unet", "in_channels": 3,
                      "out_channels": 3, "nested_levels": 1},
            "initialize": {"weights": "default", "seed": 0},
            "runtime": {"wrappers": "",
                        "data": {"mean_std": MEAN_STD, "transforms": PLAIN}}},
        "embed": {
            "type": "CirNetwork", "path": None,
            "model": {"architecture": "cirnet", "cir_architecture": "alexnet",
                      "local_whitening": False, "pooling": "gem",
                      "regional": False, "whitening": False,
                      "pretrained": False},
            "initialize": {"weights": "default", "seed": 0},
            "runtime": {"wrappers": embed_wrappers or {
                "train": "cirfaketuplebatch", "eval": "cirfaketuplebatch"}}},
    }


def optimizer_params(embed=None, alternate=None, order=None):
    sgd = {"algorithm": "sgd", "lr": LR, "momentum": 0, "weight_decay": 0}
    return {"composition": {"type": "alternation",
                            "alternate_iteration": alternate,
                            "order": order},
            "translate": dict(sgd), "embed": embed}


@pytest.fixture(scope="module")
def jax_variables():
    """Both members' weights as flax trees (the port's seeded
    initialisation), the translator's BatchNorm terms and statistics moved
    off their defaults."""
    net = JaxSequential.initialize(composition())
    port = SequentialNetwork.initialize(composition(), device="cpu")
    out = {name: to_jax_variables(
        port.networks[name].model.state_dict(),
        jax.tree.map(np.asarray, net.networks[name].model.variables))
        for name in net.sequence}
    rng = np.random.RandomState(2)
    out["translate"]["batch_stats"] = jax.tree.map(
        lambda v: (rng.rand(*v.shape) * 0.5 + 0.1).astype(np.float32),
        out["translate"]["batch_stats"])
    out["translate"]["params"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        if path[-2].key == "bn" else v, out["translate"]["params"])
    return out


def networks(variables):
    jax_net = JaxSequential.initialize(composition())
    port_net = SequentialNetwork.initialize(composition(), device="cpu")
    for name in ("translate", "embed"):
        jax_net.networks[name].model.variables = jax.tree.map(
            jnp.asarray, variables[name])
        port_net.networks[name].model.load_state_dict(
            from_jax_variables(variables[name]))
    return jax_net, port_net


def tuple_batch(seed, n_tuples=2, nnum=2):
    rng = np.random.RandomState(seed)
    images = [[rng.randint(0, 256, (rng.randint(40, 65), rng.randint(40, 65),
                                    3)).astype(np.uint8)
               for _ in range(2 + nnum)] for _ in range(n_tuples)]
    targets = [np.array([-1, 1] + [0] * nnum, np.float32)] * n_tuples
    return images, targets


def test_joint_step_matches_jax(jax_variables):
    jax_net, port_net = networks(jax_variables)
    images, targets = tuple_batch(0)
    chain = jax_chain(jax_transforms(PLAIN, MEAN_STD))
    raw = [[chain.host_input(img) for img in tpl] for tpl in images]
    batch, valid, tgt, _ = jax_prepare_batch(raw, targets)
    jax_initialize_optimizer(jax_net, optimizer_params())  # freezes embed
    with enable_x64():
        for name in jax_net.sequence:
            jax_net.networks[name].model.variables = jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), jax_variables[name])
        step = JaxTrainStep(jax_net, jax_criterion(CRITERION),
                            batch_average=False, device_chain=chain)
        params = {"translate": jax_net.networks["translate"].model.params}
        (loss_jax, aux), grads = step.gradients(
            params, batch, valid, tgt, jax.random.PRNGKey(0))
        assert set(grads) == {"translate"}
        after = {"params": jax.tree.map(
            lambda w, g: np.asarray(w) - LR * np.asarray(g),
            params["translate"], grads["translate"]),
            "batch_stats": jax.tree.map(np.asarray, aux["translate"])}
        loss_jax = float(loss_jax)

    embed_before = {k: v.clone() for k, v in
                    port_net.networks["embed"].model.state_dict().items()}
    optimizer = initialize_optimizer(port_net, optimizer_params())
    assert port_net.networks["embed"].frozen
    assert optimizer.active_names() == ["translate"]
    for name in port_net.sequence:
        port_net.networks[name].model.double()
    port_chain = chain_from_transform(initialize_transforms(PLAIN, MEAN_STD))
    step = TrainStep(port_net, initialize_criterion(CRITERION),
                     device_chain=port_chain)
    assert step.whole
    port_net.train()
    optimizer.zero_grad()
    with pytest.MonkeyPatch.context() as mp:  # the chain's float32, widened
        mask = train_step.apply_valid_mask
        mp.setattr(train_step, "apply_valid_mask",
                   lambda x, v: mask(x.double(), v))
        loss, n = step.gradients([RawChainInput()(*tpl) for tpl in images],
                                 targets)
    optimizer.step()
    assert n == len(images)
    np.testing.assert_allclose(float(loss), loss_jax, rtol=1e-5)

    got = to_jax_variables(
        port_net.networks["translate"].model.state_dict(), after)
    for collection in after:
        err = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                           got[collection], after[collection])
        assert max(jax.tree.leaves(err)) <= 1e-5, (collection, err)
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                         after["params"], jax_variables["translate"]["params"])
    assert max(jax.tree.leaves(moved)) > 1e-3
    embed = port_net.networks["embed"].model
    for name, value in embed.state_dict().items():
        assert torch.equal(value.to(embed_before[name].dtype),
                           embed_before[name]), name
    assert all(p.grad is None for p in embed.parameters())


class _Params:
    """A member's weights for the JAX package's optimizers."""

    def __init__(self):
        self.params = {"w": jnp.zeros((2,))}

    def parameters(self, _opts, _net=None):
        return {"params": self.params,
                "labels": jax.tree.map(lambda _: "default", self.params),
                "opts": {}}


@pytest.mark.parametrize("alternate,order", [(1, "translate,embed"),
                                             (2, "embed,translate")])
def test_alternation_matches_jax(jax_variables, alternate, order):
    _, port_net = networks(jax_variables)
    port_opt = initialize_optimizer(port_net, optimizer_params(
        embed=optimizer_params()["translate"], alternate=alternate,
        order=order))
    assert isinstance(port_opt, OptimizerAlternation)
    from mdir_tpu.optim.optimizers import initialize_base_optimizer

    members = {"translate": _Params(), "embed": _Params()}
    jax_opt = JaxAlternation(
        {name: initialize_base_optimizer(members[name].parameters(None),
                                         optimizer_params()["translate"])
         for name in members}, alternate_iteration=alternate, order=order)
    params = {name: m.params for name, m in members.items()}
    step = TrainStep(port_net, initialize_criterion(CRITERION),
                     device_chain=chain_from_transform(
                         initialize_transforms(PLAIN, MEAN_STD)))
    images, targets = tuple_batch(1, n_tuples=1, nnum=1)
    raw = [RawChainInput()(*tpl) for tpl in images]
    for i in range(4):
        before = {name: [p.detach().clone() for p in
                         port_net.networks[name].model.parameters()]
                  for name in port_net.sequence}
        assert port_opt.active_names() == jax_opt.active_names()
        port_net.train()
        port_opt.zero_grad()
        step.gradients(raw, targets)
        for name in port_net.sequence:  # both members get gradients
            assert all(p.grad is not None for p in
                       port_net.networks[name].model.parameters()), (i, name)
        port_opt.step()
        new = jax_opt.apply(params, {name: {"w": jnp.ones((2,))}
                                     for name in params})
        jax_moved = {name for name in params
                     if not np.array_equal(new[name]["w"], params[name]["w"])}
        params = new
        port_moved = {name for name in port_net.sequence if any(
            not torch.equal(a, b) for a, b in zip(
                before[name], port_net.networks[name].model.parameters()))}
        assert port_moved == jax_moved, (i, port_moved, jax_moved)
        assert (port_opt.current_iteration, port_opt.current_optimizer) \
            == (jax_opt.current_iteration, jax_opt.current_optimizer)
    state = port_opt.state_dict()
    again = initialize_optimizer(port_net, optimizer_params(
        embed=optimizer_params()["translate"], alternate=alternate,
        order=order))
    again.load_state_dict(copy.deepcopy(state))
    assert (again.current_iteration, again.current_optimizer) \
        == (port_opt.current_iteration, port_opt.current_optimizer)
    assert state["alternation"] == {"iteration": 4, "optimizer":
                                    port_opt.current_optimizer}


_IMAGES = {"im%02d" % i: np.random.RandomState(i).randint(
    0, 256, (48, 48, 3)).astype(np.uint8) for i in range(12)}


def load_image(path):
    """The in-memory database's loader (it is pickled with the scenario)."""
    return _IMAGES[os.path.basename(path)]


@pytest.fixture(scope="module")
def sfm_db(tmp_path_factory):
    """12 in-memory 48x48 images in 6 clusters, 3 query/positive pairs."""
    root = tmp_path_factory.mktemp("joint_db")
    with open(root / "db.pkl", "wb") as handle:
        pickle.dump({"train": {"cids": ["/mem/%s" % n
                                        for n in sorted(_IMAGES)],
                               "cluster": [i // 2 for i in range(12)],
                               "qidxs": [0, 2, 4], "pidxs": [1, 3, 5]}},
                    handle)
    return str(root / "db.pkl")


def scenario(directory, db, loader, epochs):
    return {
        "network": dict(composition(), type="SequentialNetwork"),
        "learning": {
            "type": "TrainValLearning",
            "checkpoints": {"directory": str(directory), "store_every": 0,
                            "checkpoint_every": 1},
            "training": {
                "type": "EpochTraining", "epochs": epochs,
                "deterministic": True, "seed": 0, "criterion": CRITERION,
                "optimizer": optimizer_params(), "scheduler": None,
                "epoch_iteration": {"type": "SupervisedEpoch",
                                    "data": "train", "criterion": "default",
                                    "batch_average": False,
                                    "fakebatch": True}},
            "validation": False},
        "output": {"learning": {"progress": {"print_each": 100}}},
        "data": {"train": {
            "mean_std": MEAN_STD, "transforms": PLAIN,
            "dataset": {"name": "CirTuples", "dataset": "retrieval-SfM-mem",
                        "split": "train", "image_size": 48, "neg_num": 1,
                        "dataset_pkl": db, "image_dir": None,
                        "query_size": 3, "pool_size": 12, "loader": loader},
            "loader": {"batch_size": 3, "num_workers": 0}}},
    }


def test_resume_equals_a_straight_run(sfm_db, tmp_path):
    db, load = sfm_db, load_image
    straight, = train(scenario(tmp_path / "straight", db, load, 3), (),
                      device="cpu")
    first, = train(scenario(tmp_path / "resumed", db, load, 2), (),
                   device="cpu")
    files = sorted(os.listdir(tmp_path / "resumed" / "epochs"))
    assert files == ["embed_epoch_02.ckpt", "embed_frozen.ckpt",
                     "embed_last.ckpt", "learning_epoch_02.ckpt",
                     "net_epoch_02.ckpt", "net_last.ckpt",
                     "translate_epoch_02.ckpt", "translate_last.ckpt"], files
    header = checkpoints.load_checkpoint_any(
        tmp_path / "resumed" / "epochs" / "net_epoch_02.ckpt")
    assert header["_network_names"] == ["translate", "embed"]
    resumed, = train(scenario(tmp_path / "resumed", db, load, 3), (),
                     device="cpu")
    assert first["metrics"][LOSS] == straight["metrics"][LOSS][:2]
    np.testing.assert_allclose(resumed["metrics"][LOSS],
                               straight["metrics"][LOSS], rtol=1e-6)
    for member in ("translate", "embed"):
        want, got = (checkpoints.load_checkpoint_any(
            tmp_path / run / "epochs" / ("%s_last.ckpt" % member))
            ["model_state"] for run in ("straight", "resumed"))
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=1e-6,
                                       atol=1e-8, msg=name)
    start = SequentialNetwork.initialize(composition(), device="cpu")
    for name, value in start.networks["embed"].model.state_dict().items():
        assert torch.equal(want[name], value), name


def test_branched_net_still_raises():
    """``cirnet_branched`` (ROADMAP queue 1 item 6.3) raises, naming why."""
    from mdir_tpu_torch.models import initialize_model

    with pytest.raises(NotImplementedError, match="6.3"):
        initialize_model({"architecture": "cirnet_branched"}, device="cpu")
