"""Port trunks and retrieval nets against the JAX package, weights carried
from the flax variables by ``from_jax_variables``.

A bottleneck ResNet of layers (1, 1, 1, 1) at full widths (64..2048
channels), on 64x64 inputs, and the full VGG16 and AlexNet trunks on
96-pixel inputs, each plain and as a masked bucket.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.models import retrievalnet as jax_retrievalnet
from mdir_tpu.models import trunks as jax_trunks

from mdir_tpu_torch.models import convert, trunks
from mdir_tpu_torch.models.retrievalnet import ImageRetrievalNet

LAYERS = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def _randomize(tree, rng, path=()):
    """numpy copy of a flax tree with BatchNorm state and scale/bias drawn
    from ``rng`` (flax initialises them to the identity)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize(value, rng, path + (key,))
            continue
        value = np.asarray(value, np.float32)
        n = value.shape
        if key == "mean":
            value = (0.1 * rng.randn(*n)).astype(np.float32)
        elif key == "var":
            value = (0.5 + rng.rand(*n)).astype(np.float32)
        elif key == "scale":
            value = (0.8 + 0.4 * rng.rand(*n)).astype(np.float32)
        elif key == "bias" and path and path[-1] == "bn":
            value = (0.1 * rng.randn(*n)).astype(np.float32)
        out[key] = value
    return out


@pytest.fixture(scope="module")
def trunk_pair():
    rng = np.random.RandomState(0)
    jax_trunk = jax_trunks.ResNetFeatures(jax_trunks.Bottleneck, LAYERS)
    variables = jax.jit(jax_trunk.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3)))
    variables = {k: _randomize(v, rng) for k, v in variables.items()}
    state = convert.from_jax_variables(
        {k: {"features": v} for k, v in variables.items()})
    port_trunk = trunks.ResNetFeatures(trunks.Bottleneck, LAYERS)
    port_trunk.load_state_dict(
        {k[len("features."):]: v for k, v in state.items()}, strict=True)
    return jax_trunk, variables, port_trunk.eval()


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_state_dict_names_are_cirtorch(trunk_pair):
    names = set(trunk_pair[2].state_dict())
    assert {"0.weight", "1.running_var", "4.0.conv1.weight",
            "4.0.downsample.0.weight", "7.0.bn3.bias"} <= names


@pytest.mark.parametrize("masked", [False, True])
def test_resnet_trunk_matches_jax(trunk_pair, masked):
    jax_trunk, variables, port_trunk = trunk_pair
    rng = np.random.RandomState(1)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    valid = None
    if masked:
        valid = np.asarray([[64, 64], [40, 52]], np.int32)
        x[1, 40:] = 0.0
        x[1, :, 52:] = 0.0
    ref, ref_valid = jax.jit(jax_trunk.apply)(
        variables, jnp.asarray(x),
        None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        ours, ours_valid = port_trunk(
            _nhwc_to_nchw(x),
            None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(np.asarray(ref).transpose(0, 3, 1, 2),
                               ours.numpy(), rtol=1e-4, atol=1e-4)
    if masked:
        np.testing.assert_array_equal(np.asarray(ref_valid),
                                      ours_valid.numpy())
        assert tuple(ours_valid[1].tolist()) == trunks.trunk_valid_extent(
            "resnet101", (40, 52))


def test_masked_bucket_equals_native_size(trunk_pair):
    """The port's own invariant: an image padded into a bucket gives what it
    gives at its own size, on its valid extent."""
    port_trunk = trunk_pair[2]
    rng = np.random.RandomState(2)
    img = rng.randn(1, 3, 40, 52).astype(np.float32)
    bucket = np.zeros((1, 3, 64, 64), np.float32)
    bucket[..., :40, :52] = img
    with torch.no_grad():
        native, _ = port_trunk(torch.from_numpy(img))
        padded, valid = port_trunk(torch.from_numpy(bucket),
                                   torch.tensor([[40, 52]], dtype=torch.int32))
    vh, vw = valid[0].tolist()
    assert (vh, vw) == tuple(native.shape[-2:])
    torch.testing.assert_close(padded[..., :vh, :vw], native,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pooling,whitening", [("gem", True),
                                               ("mac", False)])
def test_retrieval_net_matches_jax(monkeypatch, pooling, whitening):
    monkeypatch.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                        (jax_trunks.Bottleneck, LAYERS))
    monkeypatch.setitem(trunks.RESNET_LAYERS, "resnet101",
                        (trunks.Bottleneck, LAYERS))
    rng = np.random.RandomState(3)
    jax_net, _ = jax_retrievalnet.init_retrieval_net(
        "resnet101", pooling=pooling, whitening=whitening, p_init=3.0)
    variables = jax.jit(jax_net.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3)))
    variables = {k: _randomize(v, rng) for k, v in variables.items()}
    if pooling == "gem":
        variables["params"]["pool"]["p"] = np.asarray([2.6], np.float32)
    port_net = ImageRetrievalNet("resnet101", pooling=pooling,
                                 whitening=whitening)
    port_net.load_state_dict(convert.from_jax_variables(variables),
                             strict=True)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    valid = np.asarray([[64, 96], [50, 70]], np.int32)
    ref = jax.jit(jax_net.apply)(variables, jnp.asarray(x),
                                 jnp.asarray(valid))
    with torch.no_grad():
        ours = port_net.eval()(_nhwc_to_nchw(x), torch.from_numpy(valid))
    np.testing.assert_allclose(np.asarray(ref), ours.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=["vgg16", "alexnet"])
def sequential_pair(request):
    """A full-width VGG16 or AlexNet trunk in both packages, the port's
    weights carried from the JAX variables."""
    arch = request.param
    jax_trunk = jax_trunks.make_trunk(arch)
    variables = jax.jit(jax_trunk.init)(jax.random.PRNGKey(1),
                                        jnp.zeros((1, 96, 96, 3)))
    variables = {k: _randomize(v, np.random.RandomState(4))
                 for k, v in variables.items()}
    state = convert.from_jax_variables(
        {k: {"features": v} for k, v in variables.items()})
    port_trunk = trunks.make_trunk(arch)
    port_trunk.load_state_dict(
        {k[len("features."):]: v for k, v in state.items()}, strict=True)
    return arch, jax_trunk, variables, port_trunk.eval()


@pytest.mark.parametrize("masked", [False, True])
def test_sequential_trunk_matches_jax(sequential_pair, masked):
    arch, jax_trunk, variables, port_trunk = sequential_pair
    assert "0.weight" in port_trunk.state_dict()
    assert "0.bias" in port_trunk.state_dict()
    rng = np.random.RandomState(5)
    x = rng.randn(2, 96, 80, 3).astype(np.float32)
    valid = None
    if masked:
        valid = np.asarray([[96, 80], [61, 47]], np.int32)
        x[1, 61:] = 0.0
        x[1, :, 47:] = 0.0
    ref, ref_valid = jax.jit(jax_trunk.apply)(
        variables, jnp.asarray(x),
        None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        ours, ours_valid = port_trunk(
            _nhwc_to_nchw(x),
            None if valid is None else torch.from_numpy(valid))
    assert ours.shape[1] == trunks.OUTPUT_DIM[arch]
    np.testing.assert_allclose(np.asarray(ref).transpose(0, 3, 1, 2),
                               ours.numpy(), rtol=1e-4, atol=1e-4)
    if masked:
        np.testing.assert_array_equal(np.asarray(ref_valid),
                                      ours_valid.numpy())
        assert tuple(ours_valid[1].tolist()) == trunks.trunk_valid_extent(
            arch, (61, 47)) == jax_trunks.trunk_valid_extent(arch, (61, 47))


def test_sequential_masked_bucket_equals_native_size(sequential_pair):
    port_trunk = sequential_pair[3]
    rng = np.random.RandomState(6)
    img = rng.randn(1, 3, 61, 47).astype(np.float32)
    bucket = np.zeros((1, 3, 96, 80), np.float32)
    bucket[..., :61, :47] = img
    with torch.no_grad():
        native, _ = port_trunk(torch.from_numpy(img))
        padded, valid = port_trunk(torch.from_numpy(bucket),
                                   torch.tensor([[61, 47]], dtype=torch.int32))
    vh, vw = valid[0].tolist()
    assert (vh, vw) == tuple(native.shape[-2:])
    torch.testing.assert_close(padded[..., :vh, :vw], native,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["vgg16", "alexnet"])
def test_sequential_retrieval_net_matches_jax(arch):
    """GeM + whitening head over the sequential trunk; the cirnet factory's
    meta (mean/std, dims) equals the JAX factory's."""
    from mdir_tpu_torch.models import initialize_model

    rng = np.random.RandomState(7)
    jax_net, jax_meta = jax_retrievalnet.init_retrieval_net(
        arch, pooling="gem", whitening=True, p_init=3.0)
    variables = jax.jit(jax_net.init)(jax.random.PRNGKey(2),
                                      jnp.zeros((1, 96, 96, 3)))
    variables = {k: _randomize(v, rng) for k, v in variables.items()}
    variables["params"]["pool"]["p"] = np.asarray([2.8], np.float32)
    port_net = initialize_model(
        {"architecture": "cirnet", "cir_architecture": arch,
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": True, "pretrained": False}, device="cpu")
    for key in ("mean", "std", "outputdim", "in_channels", "out_channels"):
        assert port_net.meta[key] == jax_meta[key], key
    port_net.load_state_dict(convert.from_jax_variables(variables),
                             strict=True)
    x = rng.randn(2, 96, 112, 3).astype(np.float32)
    valid = np.asarray([[96, 112], [70, 81]], np.int32)
    ref = jax.jit(jax_net.apply)(variables, jnp.asarray(x),
                                 jnp.asarray(valid))
    with torch.no_grad():
        ours = port_net(_nhwc_to_nchw(x), torch.from_numpy(valid))
    np.testing.assert_allclose(np.asarray(ref), ours.numpy(),
                               rtol=1e-4, atol=1e-5)
