"""Port RMAC and Rpool against the JAX package: the float32 region grid,
the static and the batched (boxed) pools, and ``ImageRetrievalNet`` with
``pooling: rmac`` and ``regional: true``, unmasked and as a masked bucket
with region boxes, its weights a cirtorch-named ``-r`` state dict loaded
strictly by the port and by the JAX package's importer.

The JAX nets are never initialised by a compiled ``init``: their variable
tree comes from ``jax.eval_shape`` and every leaf from the state dict.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.models import retrievalnet as jax_retrievalnet
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.models.torch_import import import_state_dict
from mdir_tpu.ops import pooling as jax_pooling

from mdir_tpu_torch.models import initialize_model, trunks
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.models.torch_import import import_model_state
from mdir_tpu_torch.ops import pooling

LAYERS = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small tensors gain nothing from intra-op threads, and beside
    the other test workers the threads' barriers cost seconds a case."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("h", range(1, 49))
def test_region_grid_matches_jax(h):
    """cirtorch's float32 grid and the boxes, equal for every (h, w) in
    1..48."""
    for w in range(1, 49):
        assert pooling._rmac_region_grid(h, w) \
            == jax_pooling._rmac_region_grid(h, w), (h, w)
        assert pooling.rmac_region_boxes(h, w) \
            == jax_pooling.rmac_region_boxes(h, w), (h, w)


def _boxes(extents, r_multiple=8):
    """(B, R, 4) int32 boxes of each extent, R rounded up (padding)."""
    per_img = [pooling.rmac_region_boxes(h, w) for h, w in extents]
    r = -(-max(map(len, per_img)) // r_multiple) * r_multiple
    out = np.zeros((len(per_img), r, 4), np.int32)
    for i, boxes in enumerate(per_img):
        out[i, :len(boxes)] = boxes
    return out


REGION_FNS = {
    "mac": (lambda f, m: jax_pooling.mac(f, mask=m),
            lambda f, m: pooling.mac(f, mask=m)),
    "spoc": (lambda f, m: jax_pooling.spoc(f, mask=m),
             lambda f, m: pooling.spoc(f, mask=m)),
    "gem": (lambda f, m: jax_pooling.gem(f, p=2.6, mask=m),
            lambda f, m: pooling.gem(f, p=2.6, mask=m)),
}


@pytest.mark.parametrize("name", sorted(REGION_FNS))
def test_region_pools_match_jax(rng, name):
    """roipool (static grid) and region_vectors (boxes with padded slots)
    within 1e-5 of JAX's."""
    jax_fn, port_fn = REGION_FNS[name]
    x = rng.rand(3, 9, 13, 16).astype(np.float32)
    ref = jax.jit(lambda a: jax_pooling.roipool(
        a, lambda r: jax_fn(r, None)))(jnp.asarray(x))
    ours = pooling.roipool(_nchw(x), lambda r: port_fn(r, None))
    np.testing.assert_allclose(np.asarray(ref), ours.numpy(),
                               rtol=1e-5, atol=1e-6)
    boxes = _boxes([(9, 13), (5, 7), (1, 1)])
    assert (boxes[..., 2] == 0).any()  # padded slots
    ref = jax.jit(lambda a, b: jax_pooling.region_vectors(a, b, jax_fn))(
        jnp.asarray(x), jnp.asarray(boxes))
    ours = pooling.region_vectors(_nchw(x), torch.from_numpy(boxes), port_fn)
    real = boxes[..., 2] > 0
    np.testing.assert_allclose(np.asarray(ref)[real], ours.numpy()[real],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmac_masked_empty_slots_match_jax(rng, dtype):
    """A padded slot's MAC is finfo.min in every channel; L2N then the
    zeroing give no NaN, in float32 and bfloat16, and the sum is JAX's."""
    x = rng.rand(2, 6, 11, 32).astype(np.float32)
    boxes = _boxes([(6, 11), (3, 4)])
    jx = jnp.asarray(x).astype(dtype)
    tx = _nchw(x).to(getattr(torch, dtype))
    ref = np.asarray(jax_pooling.rmac_masked(jx, jnp.asarray(boxes)),
                     np.float32)
    ours = pooling.rmac_masked(tx, torch.from_numpy(boxes)).float().numpy()
    assert np.isfinite(ours).all()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ref, ours, rtol=tol, atol=tol)
    # the padded slots' vectors themselves are finite before the zeroing
    vecs = pooling.l2n(pooling.region_vectors(
        tx, torch.from_numpy(boxes), lambda f, m: pooling.mac(f, mask=m)))
    assert torch.isfinite(vecs).all()


def test_powerlaw_matches_jax(rng):
    x = rng.randn(4, 33).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax_pooling.powerlaw(jnp.asarray(x))),
        pooling.powerlaw(torch.from_numpy(x)).numpy(), rtol=1e-6, atol=1e-7)


# the three nets: (architecture, pooling, regional, whitening), and the
# bucket and the smaller image's size (feature extents 5 x 7 and 3 x 5 on
# AlexNet, 2 x 3 and 1 x 2 on the ResNet)
NETS = {
    "alexnet-rmac": ("alexnet", "rmac", False, True),
    "alexnet-mac-r": ("alexnet", "mac", True, False),
    "resnet101-gem-r": ("resnet101", "gem", True, True),
}
SIZES = {"alexnet": [(96, 128), (70, 97)], "resnet101": [(64, 96), (30, 50)]}


def _model_params(arch, pool, regional, whitening):
    return {"architecture": "cirnet", "cir_architecture": arch,
            "local_whitening": False, "pooling": pool, "regional": regional,
            "whitening": whitening, "pretrained": False}


def cirtorch_state(port_net, rng):
    """The port net's state dict (cirtorch names) with random BatchNorm
    statistics and affines, GeM p 2.6 and whitening biases: what an
    official ``-r`` checkpoint's ``state_dict`` holds."""
    state = {}
    for key, value in port_net.state_dict().items():
        value = value.numpy().copy()
        if key.endswith("running_mean") or key.endswith(".bias"):
            value = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        elif key.endswith("running_var"):
            value = (0.5 + rng.rand(*value.shape)).astype(np.float32)
        elif key.endswith(".p"):
            value = np.full(value.shape, 2.6, np.float32)
        elif value.ndim == 1:  # BatchNorm scale
            value = (0.8 + 0.4 * rng.rand(*value.shape)).astype(np.float32)
        state[key] = value
    state["features.1.num_batches_tracked" if "features.1.weight" in state
          else "features.0.num_batches_tracked"] = np.zeros((), np.int64)
    return state


@pytest.fixture(scope="module", params=sorted(NETS))
def net_pair(request):
    """One net in both packages from the same cirtorch-named state dict."""
    arch, pool, regional, whitening = NETS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                   (jax_trunks.Bottleneck, LAYERS))
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, LAYERS))
        params = _model_params(arch, pool, regional, whitening)
        port_net = initialize_model(params, device="cpu")
        state = cirtorch_state(port_net, np.random.RandomState(3))
        import_model_state(port_net, state)  # strict
        jax_net, _ = jax_retrievalnet.init_retrieval_net(
            arch, pooling=pool, regional=regional, whitening=whitening)
        shapes = jax.eval_shape(jax_net.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        variables = import_state_dict(zeros, state)
        yield request.param, jax_net, variables, port_net.eval(), state


def test_state_dict_round_trip(net_pair):
    """The JAX importer's tree maps back to the same cirtorch dict, and the
    regional head carries cirtorch's names."""
    name, _, variables, port_net, state = net_pair
    back = from_jax_variables(jax.tree.map(np.asarray, variables))
    state = {k: v for k, v in state.items()
             if not k.endswith("num_batches_tracked")}
    assert set(back) == set(state) == set(port_net.state_dict())
    for key, value in state.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
    if NETS[name][2]:
        assert {"pool.whiten.weight", "pool.whiten.bias"} <= set(state)
        assert ("pool.rpool.p" in state) == (NETS[name][1] == "gem")


def test_retrieval_net_matches_jax(net_pair):
    """Unmasked (the static grid), and a masked bucket with region boxes,
    against JAX within 1e-4; the bucket equals each image at its own
    size."""
    name, jax_net, variables, port_net, _ = net_pair
    arch = NETS[name][0]
    rng = np.random.RandomState(5)
    sizes = SIZES[arch]
    x = rng.randn(2, *sizes[0], 3).astype(np.float32)
    x[1, sizes[1][0]:] = 0.0
    x[1, :, sizes[1][1]:] = 0.0
    valid = np.asarray(sizes, np.int32)
    boxes = _boxes([trunks.trunk_valid_extent(arch, s) for s in sizes])
    apply = jax.jit(jax_net.apply)
    ref = apply(variables, jnp.asarray(x[:1]))
    ref_masked = apply(variables, jnp.asarray(x), jnp.asarray(valid),
                       jnp.asarray(boxes))
    with torch.no_grad():
        ours = port_net(_nchw(x[:1]))
        ours_masked = port_net(_nchw(x), torch.from_numpy(valid),
                               region_boxes=torch.from_numpy(boxes))
        native = [port_net(_nchw(x[i:i + 1, :h, :w]))[0]
                  for i, (h, w) in enumerate(sizes)]
    np.testing.assert_allclose(np.asarray(ref), ours.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref_masked), ours_masked.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack(native).numpy(),
                               ours_masked.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="region_boxes"):
        port_net(_nchw(x), torch.from_numpy(valid))
