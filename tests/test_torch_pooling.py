"""Port pooling (plain versions and the GeM+L2N kernel wrapper) against the
JAX package: ``gem_l2n_pallas`` in interpret mode and ``ops.pooling``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.models.trunks import feature_mask as jax_feature_mask
from mdir_tpu.ops import pooling as jax_pooling
from mdir_tpu.ops.pooling_pallas import gem_l2n_pallas

from mdir_tpu_torch.device import resolve_device
from mdir_tpu_torch.ops import pooling, pooling_kernel

SHAPES = [
    ((2, 16, 24, 128), [[16, 24], [9, 17]]),
    ((1, 8, 8, 256), [[5, 8]]),
    ((3, 7, 9, 128), [[7, 9], [3, 4], [1, 1]]),
]


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


@pytest.mark.parametrize("shape,valid", SHAPES)
def test_gem_l2n_plain_matches_pallas_kernel(rng, shape, valid):
    x = rng.rand(*shape).astype(np.float32)
    valid = np.asarray(valid, np.int32)
    p = 2.7
    ref = gem_l2n_pallas(jnp.asarray(x), jnp.asarray(valid), p,
                         interpret=True)
    ours = pooling.gem_l2n_plain(_nchw(x), torch.from_numpy(valid),
                                 torch.tensor([p]))
    np.testing.assert_allclose(np.asarray(ref), ours.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,valid", SHAPES)
def test_gem_l2n_wrapper_on_cpu_is_plain(rng, shape, valid):
    x = _nchw(rng.rand(*shape).astype(np.float32))
    valid = torch.tensor(valid, dtype=torch.int32)
    p = torch.tensor([3.0])
    before = pooling_kernel.launches
    out = pooling_kernel.gem_l2n(x, valid, p)
    assert pooling_kernel.launches == before  # no kernel on the CPU
    assert torch.equal(out, pooling.gem_l2n_plain(x, valid, p))


@pytest.mark.parametrize("name", ["mac", "spoc", "gem"])
@pytest.mark.parametrize("masked", [False, True])
def test_pools_match_jax(rng, name, masked):
    x = rng.rand(3, 7, 9, 16).astype(np.float32)
    valid = np.asarray([[7, 9], [3, 4], [1, 1]], np.int32)
    jmask = tmask = None
    if masked:
        jmask = jax_feature_mask((7, 9), jnp.asarray(valid))
        tmask = pooling.feature_mask((7, 9), torch.from_numpy(valid))
        np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    ref = jax_pooling.POOLING[name](jnp.asarray(x), mask=jmask)
    ours = pooling.POOLING[name](_nchw(x), mask=tmask)
    np.testing.assert_allclose(np.asarray(ref), ours.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_l2n_matches_jax(rng):
    x = rng.randn(4, 33).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jax_pooling.l2n(jnp.asarray(x))),
                               pooling.l2n(torch.from_numpy(x)).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
