"""The port's exact RGB -> Lab lattice (``ops/lab_trilinear.py``) against the
JAX package's numpy replica, its Pallas kernel in interpret mode, its XLA
path, and live cv2. Every comparison is bit-equal."""
import filecmp
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.ops import lab_trilinear as jax_lt

from mdir_tpu_torch.ops import lab_trilinear as lt

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def _structured():
    """Gray ramp and each channel's ramp over black and over white: where
    corner and rounding faults show first. (1, 1792, 3)."""
    v = np.arange(256, dtype=np.uint8)
    cases = [np.stack([v, v, v], -1)]
    for c in range(3):
        for base in (0, 255):
            img = np.full((256, 3), base, np.uint8)
            img[:, c] = v
            cases.append(img)
    return np.concatenate(cases)[None]


def _batches():
    rng = np.random.RandomState(0)
    return {
        "random": rng.randint(0, 256, (2, 24, 40, 3)).astype(np.uint8),
        "ramps": _structured()[None],
        "odd": rng.randint(0, 256, (3, 7, 9, 3)).astype(np.uint8),
        "one_pixel": np.asarray([[[[255, 0, 128]]]], np.uint8),
    }


def test_node_table_is_the_jax_file():
    jax_path = os.path.join(os.path.dirname(jax_lt.__file__),
                            "_lab_nodes.npy")
    assert filecmp.cmp(jax_path, lt._NODE_PATH, shallow=False)
    assert lt._node_lut3().dtype == np.int16
    assert lt._node_lut3().shape == (33, 33, 33, 3)


def test_corner_tables_match_jax():
    for ours, ref in zip(lt._u8_corner_tables(), jax_lt._u8_corner_tables()):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("case", ["random", "ramps", "odd", "one_pixel"])
def test_lab_n_plain_matches_numpy_replica(case):
    batch = _batches()[case]
    ours = lt.lab_n(torch.from_numpy(batch))
    assert ours.dtype == torch.int32 and ours.shape == batch.shape
    np.testing.assert_array_equal(ours.numpy(), jax_lt._lab_n_np(batch))


@pytest.mark.parametrize("case", ["random", "odd"])
def test_lab_n_plain_matches_pallas_interpret(case):
    batch = _batches()[case]
    ref = np.asarray(jax_lt.lab_n_pallas(jnp.asarray(batch), interpret=True))
    np.testing.assert_array_equal(lt.lab_n_plain(torch.from_numpy(batch))
                                  .numpy(), ref.astype(np.int32))


def test_lab_chan_and_normspace_match_jax():
    batch = _batches()["random"]
    l_ref, ab_ref = jax_lt.lab_chan_jax(jnp.asarray(batch))
    l_u8, ab = lt.lab_chan(torch.from_numpy(batch))
    np.testing.assert_array_equal(l_u8.numpy(), np.asarray(l_ref))
    np.testing.assert_array_equal(ab.numpy(), np.asarray(ab_ref))
    np.testing.assert_array_equal(
        lt.lab_normspace(torch.from_numpy(batch)).numpy(),
        np.asarray(jax_lt.lab_normspace_jax(jnp.asarray(batch))))
    np.testing.assert_array_equal(
        lt.lab_l_u8(torch.from_numpy(batch)).numpy(), np.asarray(l_ref))


def _cv2_lab_normspace(u8):
    lab = cv2.cvtColor(u8.astype(np.float32) / 255.0, cv2.COLOR_RGB2LAB)
    return (lab + np.array([0, 128, 128], np.float32)) \
        / np.array([100.0, 255.0, 255.0], np.float32)


def test_lab_l_u8_matches_live_cv2_dense():
    """The u8 CLAHE plane against cv2 on a dense random sample and the
    ramps: cv2's (L * 255 / 100) cut to uint8."""
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (1, 256, 513, 3)).astype(np.uint8)
    for batch in (u8, _structured()[None]):
        host = (_cv2_lab_normspace(batch[0])[..., 0] * 255).astype(
            np.uint8).astype(np.int32)
        ours = lt.lab_l_u8(torch.from_numpy(batch))[0].numpy()
        np.testing.assert_array_equal(ours, host)


def test_lab_normspace_matches_live_cv2():
    rng = np.random.RandomState(2)
    batch = rng.randint(0, 256, (1, 48, 80, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        lt.lab_normspace(torch.from_numpy(batch))[0].numpy(),
        _cv2_lab_normspace(batch[0]))


def test_wrapper_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        lt.lab_n(torch.zeros((1, 2, 2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        lt.lab_n(torch.zeros((1, 2, 2, 4), dtype=torch.uint8))
    before = lt.launches
    lt.lab_n(torch.zeros((1, 2, 2, 3), dtype=torch.uint8))
    assert lt.launches == before  # the CPU runs the plain version
