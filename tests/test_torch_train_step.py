"""One training step of the port (``learning/train_step.py``, one tuple at a
time with accumulated gradients) against the JAX package's whole-batch
``TrainStep`` on the same weights and tuple batch: AlexNet and a ResNet cut
to (1, 1, 1, 1) blocks (frozen BatchNorm's affine terms are trained), with
the plain normalize chain and the lab CLAHE device chain. The loss agrees
within rtol 1e-4 and each parameter's gradient within 1e-4 of the JAX
gradient's largest magnitude. The JAX package's step pads the whole batch
into one bucket and the port each tuple into its own, so the test also
holds the per-tuple accumulation against the whole-batch program.

Two things of the CPU are kept out of the comparison, each measured:

* the JAX package's CLAHE chain compiled by XLA on the CPU is not bit-exact
  (FMA contraction moves single CLAHE pixels by one level), while its eager
  chain agrees with the port's within 1e-5
  (``tests/test_torch_preprocess.py``): the JAX side runs its chain eagerly
  and its step on the chain's output;
* a ReLU input within float32 rounding of zero flips between two float32
  runs and moves the gradients of the tensors before it far beyond the
  tolerance; the short ResNet has hundreds of thousands of ReLU inputs at
  these sizes and often holds one (AlexNet, with far fewer, did not in the
  batches tried). The ResNet cases run both packages in float64 (the same
  programs, JAX with x64 on); AlexNet runs in float32, the path's own
  dtype.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import enable_x64

from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.ops.clahe import clahe_bucket_aux as jax_clahe_bucket_aux
from mdir_tpu.ops.preprocess import chain_from_transform as jax_chain
from mdir_tpu.ops.preprocess import make_bucketed_chain as \
    jax_make_bucketed_chain
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion

from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning import train_step
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.learning.train_step import (TrainStep, pad_image_batch,
                                                prepare_batch)
from mdir_tpu_torch.models import initialize_model, trunks
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.ops.preprocess import RawChainInput, chain_from_transform
from mdir_tpu_torch.optim.criteria import initialize_criterion

MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
CRITERION = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
TRANSFORMS = ["pil2np | totensor | normalize",
              "pil2np | apply_clahe:4:lab:8 | totensor | normalize"]
ARCHS = ["alexnet", "resnet101"]
LAYERS = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True, scope="module")
def short_resnet101():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                   (jax_trunks.Bottleneck, LAYERS))
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, LAYERS))
        yield


def _model_params(arch):
    return {"architecture": "cirnet", "cir_architecture": arch,
            "local_whitening": False, "pooling": "gem", "regional": False,
            "whitening": False, "pretrained": False}


def networks(arch):
    """The JAX package's network and the port's on the same weights (the
    JAX package's own initialisation, carried across), p = 2.5."""
    model = jax_initialize_model(_model_params(arch))
    params = dict(model.params)
    params["pool"] = {"p": np.full((1,), 2.5, np.float32)}
    model.replace_params(jax.tree.map(jax.numpy.asarray, params))
    runtime = {"wrappers": "", "data": {"mean_std": MEAN_STD}}
    jax_net = JaxCirNetwork(model, JaxCirNetwork.NetworkParams(
        model=_model_params(arch), runtime=dict(runtime)))
    port_model = initialize_model(_model_params(arch), device="cpu")
    port_model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, model.variables)))
    port_net = CirNetwork(port_model, CirNetwork.NetworkParams(
        model=_model_params(arch), runtime=dict(runtime)))
    return jax_net, port_net


def port_network(arch="alexnet"):
    """The port's network on its own seeded weights."""
    model = initialize_model(_model_params(arch), device="cpu")
    return CirNetwork(model, CirNetwork.NetworkParams(
        model=_model_params(arch),
        runtime={"wrappers": "", "data": {"mean_std": MEAN_STD}}))


def tuple_batch(seed, n_tuples=2, nnum=3):
    """Raw uint8 tuples of mixed sizes (up to 64 px) and their targets."""
    rng = np.random.RandomState(seed)
    images = [[rng.randint(0, 256, (rng.randint(33, 65), rng.randint(33, 65),
                                    3)).astype(np.uint8)
               for _ in range(2 + nnum)] for _ in range(n_tuples)]
    targets = [np.array([-1, 1] + [0] * nnum, np.float32)] * n_tuples
    return images, targets


def jax_step(jax_net, transform, images, targets, dtype):
    """The JAX package's whole-batch step: its chain run eagerly on the
    padded batch and masked to the valid extents, then its TrainStep."""
    chain = jax_chain(jax_transforms(transform, MEAN_STD))
    raw = [[chain.host_input(img) for img in tpl] for tpl in images]
    batch, valid, tgt, _ = jax_prepare_batch(raw, targets)
    aux = None
    if chain.clahe_params is not None:
        clip, grid = chain.clahe_params
        aux = {k: jnp.asarray(v) for k, v in jax_clahe_bucket_aux(
            [tuple(v) for v in valid], batch.shape[1:3], clip_limit=clip,
            grid=grid).items() if k not in ("th", "tw")}
    x = np.asarray(jax_make_bucketed_chain(chain)(jnp.asarray(batch), aux))
    rows = np.arange(x.shape[1])[None, :, None] < valid[:, 0, None, None]
    cols = np.arange(x.shape[2])[None, None, :] < valid[:, 1, None, None]
    x = x * (rows & cols)[..., None]
    step = JaxTrainStep(jax_net, jax_criterion(CRITERION),
                        batch_average=False)
    with enable_x64(dtype == "float64"):
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                              jax_net.model.params)
        (loss, _), grads = step.gradients(params, x.astype(dtype), valid,
                                          tgt, jax.random.PRNGKey(0))
        grads = jax.tree.map(np.asarray, grads)
    return float(loss), from_jax_variables({"params": grads})


def port_step(port_net, transform, images, targets, dtype="float32"):
    """The port's step on the network's parameters' dtype."""
    chain = chain_from_transform(initialize_transforms(transform, MEAN_STD))
    raw = [RawChainInput()(*tpl) for tpl in images]
    step = TrainStep(port_net, initialize_criterion(CRITERION),
                     device_chain=chain)
    port_net.train()
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float64":  # the chain's float32 output, widened
            port_net.model.double()
            mask = train_step.apply_valid_mask
            mp.setattr(train_step, "apply_valid_mask",
                       lambda x, v: mask(x.double(), v))
        loss, n_tuples = step.gradients(raw, targets)
    assert n_tuples == len(images)
    return float(loss), {name: p.grad for name, p
                         in port_net.model.named_parameters()}


@pytest.mark.parametrize("arch,dtype", [("alexnet", "float32"),
                                        ("resnet101", "float64")])
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_train_step_matches_jax(arch, dtype, transform):
    jax_net, port_net = networks(arch)
    images, targets = tuple_batch(0)
    loss_jax, grads_jax = jax_step(jax_net, transform, images, targets,
                                   dtype)
    loss, grads = port_step(port_net, transform, images, targets, dtype)

    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, loss_jax, rtol=1e-4)
    assert grads.keys() == grads_jax.keys()
    for name, grad in grads.items():
        ref = grads_jax[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(grad.double().numpy() - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)
    if arch == "resnet101":  # frozen BN: its affine terms train
        assert grads["features.1.weight"].abs().max() > 0


def jax_step_in_step_chain(jax_net, transform, images, targets):
    """The JAX package's step as ``SupervisedEpoch._optimization_step``
    drives it: raw uint8 tuples, the chain inside its ``TrainStep``
    (``device_chain``), CLAHE aux from ``clahe_bucket_aux`` when the chain
    has CLAHE."""
    chain = jax_chain(jax_transforms(transform, MEAN_STD))
    raw = [[chain.host_input(img) for img in tpl] for tpl in images]
    batch, valid, tgt, _ = jax_prepare_batch(raw, targets)
    clahe_aux = None
    if chain.clahe_params is not None:
        clip, grid = chain.clahe_params
        clahe_aux = jax_clahe_bucket_aux(
            [tuple(int(x) for x in v) for v in valid], batch.shape[1:3],
            clip_limit=clip, grid=grid)
    step = JaxTrainStep(jax_net, jax_criterion(CRITERION),
                        batch_average=False, device_chain=chain)
    (loss, _), grads = step.gradients(jax_net.model.params, batch, valid,
                                      tgt, jax.random.PRNGKey(0),
                                      clahe_aux=clahe_aux)
    grads = jax.tree.map(np.asarray, grads)
    return float(loss), from_jax_variables({"params": grads})


def test_train_step_matches_jax_in_step_chain():
    """The plain normalize chain run inside the JAX package's own step (its
    in-step chain and valid mask, not the eager assembly above): XLA's
    normalize is exact, so this part of the JAX program is compared end
    to end."""
    transform = TRANSFORMS[0]
    jax_net, port_net = networks("alexnet")
    images, targets = tuple_batch(3)
    loss_jax, grads_jax = jax_step_in_step_chain(jax_net, transform, images,
                                                 targets)
    loss, grads = port_step(port_net, transform, images, targets)

    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, loss_jax, rtol=1e-4)
    assert grads.keys() == grads_jax.keys()
    for name, grad in grads.items():
        ref = grads_jax[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(grad.double().numpy() - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)


def test_per_tuple_accumulation_is_the_batch_sum():
    """The port's batch step is the sum of its tuples' steps, each tuple in
    its own bucket, and a tuple's step does not depend on its bucket."""
    port_net = port_network()
    transform = TRANSFORMS[1]
    images, targets = tuple_batch(1, n_tuples=3)
    loss, grads = port_step(port_net, transform, images, targets)
    grads = {k: v.clone() for k, v in grads.items()}

    losses = []
    acc = {k: torch.zeros_like(v) for k, v in grads.items()}
    for tpl, target in zip(images, targets):
        port_net.model.zero_grad()
        one, one_grads = port_step(port_net, transform, [tpl], [target])
        losses.append(one)
        for k in acc:
            acc[k] += one_grads[k]
    np.testing.assert_allclose(loss, sum(losses), rtol=1e-6)
    for k in acc:
        torch.testing.assert_close(grads[k], acc[k], rtol=1e-5, atol=1e-7)

    # one tuple's bucket padded much further: the same loss and gradients
    step = TrainStep(port_net, initialize_criterion(CRITERION),
                     device_chain=chain_from_transform(initialize_transforms(
                         transform, MEAN_STD)))
    tpl = RawChainInput()(*images[0])
    batch, valid = pad_image_batch(tpl)
    wide = np.zeros((batch.shape[0], 128, 160, 3), np.uint8)
    wide[:, :batch.shape[1], :batch.shape[2]] = batch
    port_net.model.zero_grad()
    step.tuple_loss(wide, valid, targets[0]).backward()
    wide_grads = {k: p.grad.clone()
                  for k, p in port_net.model.named_parameters()}
    port_net.model.zero_grad()
    loss_one = step.tuple_loss(batch, valid, targets[0])
    loss_one.backward()
    np.testing.assert_allclose(loss_one.item(), losses[0], rtol=1e-6)
    for k, p in port_net.model.named_parameters():
        torch.testing.assert_close(p.grad, wide_grads[k], rtol=1e-4,
                                   atol=1e-6)


def test_prepare_batch_pads_each_tuple():
    images, targets = tuple_batch(2)
    buckets = prepare_batch(images, targets)
    assert len(buckets) == 2
    for (batch, valid, target), tpl in zip(buckets, images):
        assert batch.dtype == np.uint8
        assert batch.shape[1] % 32 == 0 and batch.shape[2] % 32 == 0
        for img, (h, w), got in zip(tpl, valid, batch):
            assert (h, w) == img.shape[:2]
            np.testing.assert_array_equal(got[:h, :w], img)
            assert not got[h:].any() and not got[:, w:].any()
        np.testing.assert_array_equal(target, [-1, 1, 0, 0, 0])
    with pytest.raises(NotImplementedError):
        prepare_batch([images[0][0]], [targets[0]])


@pytest.mark.parametrize("runtime", [{"compute_dtype": "float8"},
                                     {"param_sharding": "zero"}])
def test_unported_runtime_raises(runtime):
    """A compute dtype neither package runs, and ZeRO sharding (bfloat16
    and float16 are ported: ``tests/test_torch_dtypes.py``)."""
    port_net = port_network()
    port_net.network_params.runtime.update(runtime)
    error, match = (ValueError, "unknown compute_dtype") \
        if "compute_dtype" in runtime else (NotImplementedError, "ROADMAP")
    with pytest.raises(error, match=match):
        TrainStep(port_net, initialize_criterion(CRITERION))


@pytest.mark.parametrize("tensor", [
    [["q0", "p0", "n0"], ["q1", "p1", "n1"]],  # two tuples of three
    [["q0", "p0"]],  # one pair
    ["a", "b", "c"],  # a flat list passes through
    "one image"])
def test_cir_fake_tuple_batch_flattens_as_jax(tensor):
    """The train wrapper of the CirNetwork scenarios flattens a two-level
    tuple list as the JAX package's does: the same list, the same meta."""
    from mdir_tpu.learning.wrappers import initialize_wrappers as jax_wrappers

    from mdir_tpu_torch.learning.wrappers import (CirFakeTupleBatch,
                                                  initialize_wrappers)

    ours, = initialize_wrappers("cirfaketuplebatch").wrappers
    theirs, = jax_wrappers("cirfaketuplebatch").wrappers
    assert isinstance(ours, CirFakeTupleBatch)
    assert ours.preprocess(tensor, None) == theirs.preprocess(tensor, None)
    if isinstance(tensor, list) and isinstance(tensor[0], list):
        assert ours.preprocess(tensor, None) == (
            [x for tpl in tensor for x in tpl], len(tensor[0]))
    else:
        assert ours.preprocess(tensor, None) == (tensor, False)


@pytest.mark.parametrize("weights", ["normal", "normal_p2p", "he_normal"])
def test_weight_initialisations(weights):
    """``initialize: weights`` on a network built from scratch: seeded and
    deterministic, on the tensors each scheme names (the JAX package's
    rules); GeM's p and the BatchNorm statistics keep their values."""
    def build(scheme, seed=3):
        params = {"model": _model_params("resnet101"),
                  "initialize": {"weights": scheme, "seed": seed},
                  "runtime": {"wrappers": ""}}
        return CirNetwork.initialize(params, device="cpu").model.state_dict()

    state, again, default = build(weights), build(weights), build("default")
    assert not torch.equal(state["features.0.weight"],
                           build(weights, seed=4)["features.0.weight"])
    for name, value in state.items():
        assert torch.equal(value, again[name]), name
        is_bn = name.endswith(("running_mean", "running_var")) \
            or (name.rsplit(".", 1)[0] + ".running_mean") in state
        if name == "pool.p" or name.endswith(("running_mean",
                                              "running_var")):
            assert torch.equal(value, default[name]), name
        elif is_bn and weights != "normal_p2p":
            assert torch.equal(value, default[name]), name
        elif is_bn and name.endswith("weight"):
            assert (value - 1).abs().max() < 0.2, name
        elif is_bn:
            assert not value.any(), name
        else:  # a convolution weight
            assert not torch.equal(value, default[name]), name
            std = {"normal": 1.0, "normal_p2p": 0.02,
                   "he_normal": (2.0 / value[0].numel()) ** 0.5}[weights]
            assert abs(float(value.std()) / std - 1) < 0.1, (name, std)
