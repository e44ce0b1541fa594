"""The port's colorspaces (``ops/colorspace.py``, ``lab_trilinear.lsh_l_u8``,
the luv plane of ``ops/preprocess.py``) against the JAX package's and
against live cv2.

Against JAX: the float conversions within 1e-5 in the normalized spaces
(raw Lab/Luv within 1e-4 of their 0-100 scale: a cube root in other
arithmetic); the uint8 table sums within two float32 ulps (the JAX package
contracts a one-hot, in an order XLA picks, and each order rounds twice;
measured on this input: 667 of 4608 XYZ values off, 6 of them by two ulps,
the uint8 planes equal); the lab and lsh CLAHE
planes bit-equal; the luv plane within one level, flips below 5e-4 on
``tests/test_exact_l.py``'s dense sweep. Against cv2: the host conversions
(``data/transforms.py``) within ``tests/test_colorspace.py``'s bars, and
bit-equal on u8 / 255 input in lab.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.data import transforms as jax_tf
from mdir_tpu.ops import colorspace as jax_cs
from mdir_tpu.ops import lab_trilinear as jax_lt
from mdir_tpu.ops import preprocess as jax_preprocess

from mdir_tpu_torch.data import transforms as tf
from mdir_tpu_torch.ops import colorspace as cs
from mdir_tpu_torch.ops import lab_trilinear, preprocess

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def img():
    return np.random.RandomState(0).rand(40, 50, 3).astype(np.float32)


@pytest.fixture(scope="module")
def u8():
    return np.random.RandomState(1).randint(0, 256, (2, 24, 32, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize("name,atol", [
    ("rgb_to_lab", 1e-4), ("rgb_to_luv", 2e-4), ("rgb_to_hls", 1e-5),
    ("rgb_to_gray", 1e-6), ("rgb_to_xyz", 1e-6)])
def test_forward_conversions_match_jax(img, name, atol):
    ref = np.asarray(getattr(jax_cs, name)(jnp.asarray(img)))
    out = getattr(cs, name)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("space", ["lab", "luv", "lsh", "gray"])
def test_normspace_round_trip_matches_jax(img, space):
    ref = np.array(jax_cs.rgb2normspace(jnp.asarray(img), space))
    out = cs.rgb2normspace(torch.from_numpy(img), space).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if space == "gray":
        with pytest.raises(NotImplementedError, match="gray"):
            cs.normspace2rgb(torch.from_numpy(out), space)
        return
    back = cs.normspace2rgb(torch.from_numpy(ref), space).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jax_cs.normspace2rgb(jnp.asarray(ref), space)),
        rtol=0, atol=1e-5)


def test_hls_is_not_a_normspace(img):
    for fn in (cs.rgb2normspace, cs.normspace2rgb):
        with pytest.raises(NotImplementedError,
                           match="Colorspace hls is not supported"):
            fn(torch.from_numpy(img), "hls")


@pytest.mark.parametrize("space", ["lab", "luv", "lsh", "gray"])
def test_u8_paths_match_jax(u8, space):
    """The host tables are the JAX package's, bit for bit; the sums of
    three entries are within two float32 ulps of the one-hot contraction."""
    np.testing.assert_array_equal(cs._u8_xyz_table(),
                                  jax_cs._u8_xyz_table())
    np.testing.assert_array_equal(cs._u8_xyz_analytic_table()[:, 1],
                                  jax_cs._u8_y_analytic_table())
    xyz = cs.rgb_u8_to_xyz(torch.from_numpy(u8)).numpy()
    ref = np.asarray(jax_cs.rgb_u8_to_xyz(jnp.asarray(u8)))
    ulp = np.spacing(np.maximum(np.abs(xyz), np.abs(ref)))
    assert (np.abs(xyz - ref) <= 2 * ulp).all()
    out = cs.rgb_u8_to_normspace(torch.from_numpy(u8), space).numpy()
    ref = np.asarray(jax_cs.rgb_u8_to_normspace(jnp.asarray(u8), space))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_lab_and_lsh_planes_bit_equal_to_jax():
    """Every RGB pair (with B at 0, 127, 255) through both packages."""
    i = np.arange(256)
    r, g = np.meshgrid(i, i, indexing="ij")
    batch = np.stack([np.stack([r, g, np.full_like(r, b)], -1)
                      for b in (0, 127, 255)]).astype(np.uint8)
    t = torch.from_numpy(batch)
    np.testing.assert_array_equal(
        lab_trilinear.lsh_l_u8(t).numpy(),
        np.asarray(jax_lt.lsh_l_u8_jax(jnp.asarray(batch))))
    np.testing.assert_array_equal(lab_trilinear.lsh_l_u8(t).numpy(),
                                  lab_trilinear.lsh_l_u8_np(batch))
    np.testing.assert_array_equal(
        preprocess.clahe_plane(t, "lab").numpy(), jax_lt.lab_l_u8_np(batch))
    # and against cv2's own planes
    flat = batch.reshape(-1, 256, 3).astype(np.float32) / 255.0
    for space in ("lab", "lsh"):
        host = (jax_tf.rgb2normspace_np(flat, space)[..., 0] * 255) \
            .astype(np.uint8)
        np.testing.assert_array_equal(
            preprocess.clahe_plane(t, space).numpy().reshape(host.shape),
            host)


def test_luv_plane_within_one_level_on_the_dense_sweep():
    """JAX's dense sweep (``tests/test_exact_l.py``): 16 x 64 x 64 RGB
    lattice points, against cv2's host plane and the JAX device plane."""
    ks = np.arange(0, 256, 4, dtype=np.uint8)
    g, b = np.meshgrid(ks, ks, indexing="ij")
    batch = np.stack([np.stack([np.full_like(g, r), g, b], -1)
                      for r in range(0, 256, 16)]).astype(np.uint8)
    dev = preprocess.clahe_plane(torch.from_numpy(batch), "luv").numpy()
    host = (jax_tf.rgb2normspace_np(batch.reshape(-1, 64, 3)
                                    .astype(np.float32) / 255.0,
                                    "luv")[..., 0] * 255).astype(np.uint8)
    jax_dev = np.asarray(jax_preprocess._float_l_u8(jnp.asarray(batch),
                                                    "luv"))
    for ref in (host.reshape(dev.shape).astype(np.int32), jax_dev):
        diff = np.abs(dev - ref)
        assert diff.max() <= 1, diff.max()
        assert (diff != 0).mean() < 5e-4, (diff != 0).mean()


@pytest.mark.parametrize("space,bar", [
    ("lab", 3e-3), ("luv", 3e-3), ("lsh", 1e-4), ("gray", 1e-5)])
def test_host_conversions_match_cv2(img, space, bar):
    """``rgb2normspace_np`` / ``normspace2rgb_np`` against cv2 (the JAX
    package's host functions), on float input and on u8 / 255 input, which
    takes the exact planes (lab bit-equal to cv2's)."""
    exact = (img * 255).astype(np.uint8).astype(np.float32) / 255.0
    assert tf.exact_u8(exact) is not None and tf.exact_u8(img) is None
    for src in (img, exact):
        ref = jax_tf.rgb2normspace_np(src, space)
        out = tf.rgb2normspace_np(src, space, "cpu")
        assert out.shape == ref.shape and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=0, atol=bar)
    if space == "lab":
        np.testing.assert_array_equal(
            tf.rgb2normspace_np(exact, space, "cpu"), ref)
    if space != "gray":
        back = tf.normspace2rgb_np(ref, space, "cpu")
        np.testing.assert_allclose(back, jax_tf.normspace2rgb_np(ref, space),
                                   rtol=0, atol=6e-3)


def test_luv_inverse_clamps_as_cv2():
    """Luv whose v' nears zero: cv2 clamps 1 / (4 v'); the host inverse
    does too, the JAX package's device inverse (kept on the device chain)
    does not."""
    luv = np.array([[[8.235294, -5.572342, -50.24121],
                     [54.509808, 63.757004, -112.478745],
                     [0.0, 0.0, 0.0], [100.0, 0.0, 0.0]]], np.float32)
    ref = cv2.cvtColor(luv, cv2.COLOR_LUV2RGB)
    out = cs.luv_to_rgb_cv2(torch.from_numpy(luv)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)
    jax_out = np.asarray(jax_cs.luv_to_rgb(jnp.asarray(luv)))
    np.testing.assert_allclose(cs.luv_to_rgb(torch.from_numpy(luv)).numpy(),
                               jax_out, rtol=0, atol=1e-5)
