"""The port's criteria, optimizers and schedulers (``mdir_tpu_torch/optim``)
against the JAX package's on the same numpy-seeded inputs: the contrastive
and triplet losses and their gradients (``jax.grad``) over 1-3 tuples with
0-5 negatives, two optimizer steps of sgd and adam with CirNetwork's pool
group against optax, and the learning-rate factors of the schedulers over 5
epochs, fresh and resumed."""
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.optim import criteria as jax_criteria
from mdir_tpu.optim import optimizers as jax_optimizers
from mdir_tpu.optim import schedulers as jax_schedulers

from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.optim import criteria, optimizers, schedulers

MODEL = {"architecture": "cirnet", "cir_architecture": "alexnet",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def _columns(seed, n_tuples, nnum, dim=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(dim, n_tuples * (2 + nnum)).astype(np.float32)
    x /= np.linalg.norm(x, axis=0, keepdims=True)
    labels = np.tile(np.array([-1, 1] + [0] * nnum, np.float32), n_tuples)
    return x, labels


@pytest.mark.parametrize("loss", [
    {"loss": "contrastive", "margin": 0.7, "eps": 1e-6},
    {"loss": "triplet", "margin": 0.5}])
@pytest.mark.parametrize("n_tuples,nnum", [(1, 0), (1, 5), (2, 1), (3, 3)])
def test_tuple_losses_and_gradients_match_jax(loss, n_tuples, nnum):
    x, labels = _columns(n_tuples * 10 + nnum, n_tuples, nnum)
    jax_fn = jax_criteria.initialize_criterion(loss)
    fn = criteria.initialize_criterion(loss)
    assert fn.reduction == jax_fn.reduction == "sum"

    ref, ref_grad = jax.value_and_grad(lambda v: jax_fn(v, labels))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt, [labels[i:i + 2 + nnum]
                  for i in range(0, labels.size, 2 + nnum)])
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["l1", "mse"])
def test_mean_losses_match_jax(name):
    rng = np.random.RandomState(1)
    x, y = rng.randn(2, 8, 5).astype(np.float32)
    ref = jax_criteria.initialize_criterion({"loss": name})(
        jnp.asarray(x), jnp.asarray(y))
    fn = criteria.initialize_criterion({"loss": name})
    assert fn.reduction == "mean"
    np.testing.assert_allclose(
        fn(torch.from_numpy(x), torch.from_numpy(y)).item(), float(ref),
        rtol=1e-6)


@pytest.fixture(scope="module")
def jax_model():
    return jax_initialize_model(dict(MODEL))


def _random_grads(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * 0.1, tree)


@pytest.mark.parametrize("spec", [
    {"algorithm": "sgd", "lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4},
    {"algorithm": "sgd", "lr": 1e-2, "momentum": 0.0, "weight_decay": 0.0},
    {"algorithm": "adam", "lr": 1e-3, "weight_decay": 1e-6}])
def test_optimizer_steps_match_optax(jax_model, spec):
    """Two steps (the second from a state_dict round trip) on the same
    weights and gradients; the pool ``p`` at 10x lr and no decay."""
    params = jax.tree.map(np.asarray, jax_model.params)
    jax_net = SimpleNamespace(frozen=False,
                              model=SimpleNamespace(params=params))
    jax_opt = jax_optimizers.initialize_base_optimizer(
        JaxCirNetwork.parameters(jax_net, {}), dict(spec))

    model = initialize_model(dict(MODEL), device="cpu")
    model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jax_model.variables)))
    network = CirNetwork(model, CirNetwork.NetworkParams(
        model=dict(MODEL), runtime={"wrappers": ""}))
    opt = optimizers.initialize_optimizer(network, dict(spec))
    lrs = opt.learning_rates
    assert lrs["pool"] == pytest.approx(10 * spec["lr"])
    assert lrs["default"] == pytest.approx(spec["lr"])
    assert lrs == pytest.approx(jax_opt.learning_rates)

    jparams = jax.tree.map(jnp.asarray, params)
    for step in range(2):
        grads = _random_grads(params, step)
        jparams = jax_opt.apply(jparams, jax.tree.map(jnp.asarray, grads))
        for name, grad in from_jax_variables({"params": grads}).items():
            dict(model.named_parameters())[name].grad = grad
        opt.step()
        if step == 0:  # resume the optimizer from its state
            state = opt.state_dict()
            opt = optimizers.initialize_optimizer(network, dict(spec))
            opt.load_state_dict(state)
    # atol: one float32 rounding of a weight near 1 (adam moves entries
    # near zero by the full lr, where rtol alone would ask for exact bits)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, jparams)})
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-7, err_msg=name)


class _Recorder:
    """Optimizer stand-in that records the learning-rate factors."""

    def __init__(self):
        self.factors = []

    def set_lr_factor(self, factor):
        self.factors.append(factor)


SCHEDULERS = [{"algorithm": "const"},
              {"algorithm": "gamma", "gamma": "exp(-0.01)"},
              {"algorithm": "gamma", "gamma": 0.5},
              {"algorithm": "lambda", "fixed_ratio": 0.4}]


@pytest.mark.parametrize("spec", SCHEDULERS)
@pytest.mark.parametrize("last_epoch", [-1, 2])
def test_scheduler_factors_match_jax(spec, last_epoch):
    """Factors over 5 epochs from a fresh start (-1) and after a resume at
    epoch 2, which continues the fresh run's sequence."""
    runs = []
    for module in (jax_schedulers, schedulers):
        rec = _Recorder()
        sched = module.initialize_scheduler(rec, dict(spec), nepochs=5,
                                            last_epoch=last_epoch)
        for _ in range(4 - last_epoch):
            sched.step()
        runs.append(rec.factors)
    assert runs[0] == runs[1]
    if last_epoch != -1 and spec["algorithm"] != "const":
        rec = _Recorder()
        sched = schedulers.initialize_scheduler(rec, dict(spec), nepochs=5)
        for _ in range(5):
            sched.step()
        assert rec.factors[last_epoch + 1:] == runs[1]


def test_scheduler_set_steps_each_optimizer():
    recs = {"a": _Recorder(), "b": _Recorder()}
    sched = schedulers.initialize_scheduler(
        recs, {"composition": {"type": "set"},
               "a": {"algorithm": "gamma", "gamma": 0.5},
               "b": {"algorithm": "lambda", "fixed_ratio": 0.5}},
        nepochs=4)
    sched.step()
    assert recs["a"].factors == [1.0, 0.5]
    assert recs["b"].factors == [1.0, 1.0]
    assert schedulers.initialize_scheduler(None, SCHEDULERS[1], 4) is None
