"""The port's histogram ops (``ops/histogram.py``) against the JAX
package's: the numpy functions bit-equal (the same code), the torch
counterparts against numpy (their float64 ``histogram_cdf`` and ``interp``
keep numpy's closed last bin, ends and ties) and against the JAX package's
in-graph functions within ``tests/test_transforms.py``'s bars."""
import numpy as np
import pytest

import jax
import torch

from mdir_tpu.ops import histogram as jax_hist

from mdir_tpu_torch.ops import histogram as hist


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def chans():
    rng = np.random.RandomState(0)
    return (rng.rand(64, 64).astype(np.float32),
            rng.rand(64, 64).astype(np.float32))


def test_tables_are_the_jax_packages():
    np.testing.assert_array_equal(hist._HIST_F3D_LAB, jax_hist._HIST_F3D_LAB)
    np.testing.assert_array_equal(hist.HISTOGRAM_BINS,
                                  jax_hist.HISTOGRAM_BINS)


@pytest.mark.parametrize("case", ["eq", "f3d_lab", "chan2chan", "gamma"])
def test_host_functions_equal_jax(chans, case):
    chan, ref = chans
    if case == "chan2chan":
        out = hist.channel2channel_histogram_matching(chan, ref)
        expect = jax_hist.channel2channel_histogram_matching(chan, ref)
    elif case == "gamma":
        out = hist.channel_gamma_matching(chan, 0.3)
        expect = jax_hist.channel_gamma_matching(chan, 0.3)
    else:
        out = hist.channel_histogram_matching(chan, case)
        expect = jax_hist.channel_histogram_matching(chan, case)
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("case", ["eq", "f3d_lab", "chan2chan", "gamma"])
def test_torch_functions_match_numpy_and_jax(chans, case):
    """rtol 1e-4, atol 2e-4 against the JAX package's in-graph functions
    (its float32 interp; the gamma solvers 5e-3 / 5e-4), as its own test
    holds them against numpy; the torch histogram ops equal numpy's within
    float32 rounding."""
    chan, ref = chans
    t, r = torch.from_numpy(chan), torch.from_numpy(ref)
    if case == "chan2chan":
        out = hist.channel2channel_histogram_matching_torch(t, r).numpy()
        host = hist.channel2channel_histogram_matching(chan, ref)
        jax_out = jax_hist.channel2channel_histogram_matching_jax(chan, ref)
    elif case == "gamma":
        out = hist.channel_gamma_matching_torch(t, 0.3).numpy()
        host = hist.channel_gamma_matching(chan, 0.3)
        jax_out = jax_hist.channel_gamma_matching_jax(chan, 0.3)
        assert abs(out.mean() - 0.3) < 1e-3
        np.testing.assert_allclose(out, np.asarray(jax_out), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out, host, rtol=5e-3, atol=5e-4)
        return
    else:
        out = hist.channel_histogram_matching_torch(t, case).numpy()
        host = hist.channel_histogram_matching(chan, case)
        jax_out = jax_hist.channel_histogram_matching_jax(chan, case)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, host, rtol=0, atol=1e-7)
    np.testing.assert_allclose(out, np.asarray(jax_out), rtol=1e-4,
                               atol=2e-4)


def test_histogram_edges_and_interp_ties():
    """Values on the edges (the last one closed, outside ones dropped),
    and interp's ends, exact hits and runs of equal xp, against numpy."""
    bins = hist.HISTOGRAM_BINS
    chan = np.concatenate([bins, [bins[0] - 1e-3, bins[-1] + 1e-3, 0.5,
                                  0.5]]).astype(np.float64)
    cdf = np.cumsum(np.histogram(chan, bins)[0]) / chan.size
    np.testing.assert_array_equal(
        hist.histogram_cdf(torch.from_numpy(chan)).numpy(), cdf)
    xp = np.array([0.0, 0.2, 0.2, 0.2, 0.5, 0.9, 0.9, 1.0])
    fp = np.array([0.1, 0.3, 0.35, 0.4, 0.6, 0.7, 0.75, 0.8])
    x = np.array([-1.0, 0.0, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 0.95, 1.0, 2.0,
                  np.nextafter(0.2, 0), np.nextafter(0.9, 1)])
    np.testing.assert_array_equal(
        hist.interp(torch.from_numpy(x), xp, fp).numpy(),
        np.interp(x, xp, fp))
