"""Image-to-image training in the port against the JAX package: the live
BatchNorm and Dropout of the U-Nets (``models/layers.py``), the P2pUNet's
bucket sides, and one L1 step of ``learning/train_step.py``'s whole-batch
route on image pairs.

* Live BatchNorm: one train-mode call's output and both running statistics
  (the biased variance) within 1e-5 of flax's ``nn.BatchNorm``; eval mode
  is the running-statistics normalisation.
* Dropout (the port's alone: the JAX package's masks come from threefry):
  the rate within a binomial bound, the ``1 / (1 - p)`` scale, eval the
  identity, the same generator state the same output.
* The P2pUNet's skip concatenation runs where the JAX package's runs and
  fails where it fails (sides that are multiples of 2^(levels + 1)).
* One L1 step of ``pixelconv_regr`` and of a P2pUNet at 1 nested level
  (BatchNorm, dropout 0) from the same weights in float64 (ReLU inputs near
  zero flip between float32 runs): the loss at rtol 1e-5, the weights after
  an SGD step and the BatchNorm statistics within 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import enable_x64

from mdir_tpu.learning.network import SingleNetwork as JaxSingleNetwork
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models.layers import BatchNorm as JaxBatchNorm
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion

from mdir_tpu_torch.learning.network import SingleNetwork
from mdir_tpu_torch.learning.train_step import TrainStep, prepare_batch
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.models.convert import from_jax_variables, \
    to_jax_variables
from mdir_tpu_torch.models.layers import BatchNorm2d, Dropout
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.optim.optimizers import initialize_optimizer

LR = 0.5
MODELS = {
    "pixelconv_regr": {"architecture": "pixelconv_regr", "in_channels": 3,
                       "out_channels": 3, "hidden": [8]},
    "p2p_unet": {"architecture": "p2p_unet", "in_channels": 3,
                 "out_channels": 3, "nested_levels": 1, "dropout": 0.0},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_no_jax_cache():
    """Keep this module's JAX compiles out of the persistent cache, and
    torch on one thread beside the other workers."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old, threads = getattr(jax.config, key), torch.get_num_threads()
    jax.config.update(key, 1e9)
    torch.set_num_threads(1)
    yield
    jax.config.update(key, old)
    torch.set_num_threads(threads)


def test_live_batchnorm_matches_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 6, 5, 4) * 2 + 0.5).astype(np.float32)  # NHWC
    variables = {"params": {"bn": {"scale": rng.rand(4).astype(np.float32)
                                   + 0.5,
                                   "bias": rng.randn(4).astype(np.float32)}},
                 "batch_stats": {"bn": {"mean": rng.randn(4).astype(
                     np.float32), "var": rng.rand(4).astype(np.float32)
                     + 0.2}}}
    out, mutated = JaxBatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm2d(4)
    bn.load_state_dict({k[len("bn."):]: v for k, v in from_jax_variables(
        {"params": {"bn": variables["params"]},
         "batch_stats": {"bn": variables["batch_stats"]}}).items()})
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(out), rtol=0, atol=1e-5)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-5)
    # flax keeps the biased variance; torch's BatchNorm2d the unbiased one
    biased = x.reshape(-1, 4).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * variables[
        "batch_stats"]["bn"]["var"] + 0.1 * biased, rtol=1e-5)
    bn.eval()
    ref = JaxBatchNorm(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": mutated[
            "batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(
        bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        .detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_dropout_rate_scale_eval_and_generator():
    p = 0.3
    drop = Dropout(p)
    x = torch.full((200, 50), 2.0)
    drop.train()
    drop.generator = torch.Generator().manual_seed(7)
    out = drop(x)
    kept = out != 0
    n = x.numel()
    # the kept share within 5 standard deviations of a Binomial(n, 1 - p)
    assert abs(kept.sum().item() - n * (1 - p)) <= 5 * (n * p * (1 - p)) ** .5
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          2.0 / (1 - p)))
    drop.generator = torch.Generator().manual_seed(7)
    torch.testing.assert_close(drop(x), out)
    assert not torch.equal(drop(x), out)  # the generator moved on
    drop.eval()
    assert drop(x) is x


@pytest.fixture(scope="module")
def p2p_unets():
    """The JAX module traced by ``jax.eval_shape`` (the concatenation fails
    while tracing; a shape that traces runs), and the port's net."""
    params = MODELS["p2p_unet"]
    model = jax_initialize_model(dict(params))
    apply = lambda v, x: jax.eval_shape(
        lambda v, x: model.module.apply(v, x, train=False), v, x)
    return model.variables, apply, initialize_model(dict(params), "cpu")


@pytest.mark.parametrize("side", [(32, 32), (34, 36), (36, 40), (44, 30)])
def test_p2p_unet_sides_fail_where_jax_fails(p2p_unets, side):
    """At 1 nested level (2 stride-2 stages) the skip concatenation needs
    sides that are multiples of 4; the JAX package and the port run and
    fail alike (at the paper's 7 levels: multiples of 256)."""
    variables, apply, port = p2p_unets
    x = np.random.RandomState(0).rand(1, *side, 3).astype(np.float32)
    try:
        apply(variables, jnp.asarray(x))
        jax_ok = True
    except (TypeError, ValueError):
        jax_ok = False
    try:
        with torch.no_grad():
            port(torch.from_numpy(x).permute(0, 3, 1, 2))
        port_ok = True
    except RuntimeError:
        port_ok = False
    assert port_ok == jax_ok == (side[0] % 4 == 0 and side[1] % 4 == 0)


def networks(name):
    """The JAX package's network and the port's on the same weights, with
    BatchNorm statistics moved off their defaults."""
    params = MODELS[name]
    model = jax_initialize_model(dict(params))
    rng = np.random.RandomState(1)
    variables = jax.tree.map(np.asarray, model.variables)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree.map(
            lambda v: (rng.rand(*v.shape) * 0.5 + 0.1).astype(np.float32),
            variables["batch_stats"])
    model.variables = jax.tree.map(jnp.asarray, variables)
    runtime = {"wrappers": "", "data": {"mean_std": [[0.5] * 3, [0.5] * 3]}}
    jax_net = JaxSingleNetwork(model, JaxSingleNetwork.NetworkParams(
        model=dict(params), runtime=dict(runtime)))
    port_model = initialize_model(dict(params), device="cpu")
    port_model.load_state_dict(from_jax_variables(variables))
    port_net = SingleNetwork(port_model, SingleNetwork.NetworkParams(
        model=dict(params), runtime=dict(runtime)))
    return jax_net, port_net, variables


def image_pairs(seed, n=3, side=32):
    rng = np.random.RandomState(seed)
    inputs = (rng.rand(n, side, side, 3) * 2 - 1).astype(np.float32)
    targets = np.tanh(inputs[..., ::-1] * 1.5).astype(np.float32)
    return inputs, targets


@pytest.mark.parametrize("name", sorted(MODELS))
def test_l1_step_matches_jax(name):
    jax_net, port_net, variables = networks(name)
    inputs, targets = image_pairs(0)
    with enable_x64():
        jax_net.model.variables = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), variables)
        step = JaxTrainStep(jax_net, jax_criterion({"loss": "l1"}),
                            batch_average=True)
        batch, valid, tgt, n = jax_prepare_batch(inputs, targets)
        assert valid is None and n == 3
        (loss_jax, aux), grads = step.gradients(
            jax_net.model.variables["params"], batch.astype(np.float64),
            valid, tgt.astype(np.float64), jax.random.PRNGKey(0))
        after = {"params": jax.tree.map(
            lambda w, g: np.asarray(w) - LR * np.asarray(g),
            jax_net.model.variables["params"], grads)}
        if aux.get("net") is not None:
            after["batch_stats"] = jax.tree.map(np.asarray, aux["net"])
        loss_jax = float(loss_jax)

    port_net.model.double()
    optimizer = initialize_optimizer(port_net, {
        "algorithm": "sgd", "lr": LR, "momentum": 0, "weight_decay": 0})
    (bucket, valid, tgt), = prepare_batch(inputs, targets)
    assert valid is None and tgt.shape == (3, 32, 32, 3)
    port_net.train()
    optimizer.zero_grad()
    loss, n = TrainStep(port_net, initialize_criterion({"loss": "l1"})) \
        .gradients(inputs.astype(np.float64), targets.astype(np.float64))
    optimizer.step()
    assert n == 3
    np.testing.assert_allclose(float(loss), loss_jax, rtol=1e-5)
    got = to_jax_variables(port_net.model.state_dict(), after)
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                         after["params"], variables["params"])
    assert max(jax.tree.leaves(moved)) > 1e-3
    for collection in after:
        err = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                           got[collection], after[collection])
        assert max(jax.tree.leaves(err)) <= 1e-5, (collection, err)
    if name == "p2p_unet":  # live BatchNorm moved its statistics
        shift = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                             after["batch_stats"], variables["batch_stats"])
        assert min(jax.tree.leaves(shift)) > 1e-3
