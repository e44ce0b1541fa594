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


def test_packed_tables_hold_the_node_table():
    """Entry (ix, iy, iz) of the kernel's corner-pair table holds node
    (ix, iy, iz) and node (ix, iy, min(iz + 1, 32)) per channel, the clamp
    at 32 included, each entry once; the packed u8 table holds (tx, w)."""
    tw, pairs = lt._packed_tables()
    node = lt._node_lut3()
    assert pairs.dtype == np.int16 and pairs.shape == (17 ** 3 * 8, 8)
    assert pairs.nbytes == 17 ** 3 * 128  # 2 x 2 x 2 bricks of 128 bytes
    i = np.arange(33)
    ix, iy, iz = np.meshgrid(i, i, i, indexing="ij")
    at = lt.pair_index(ix, iy, iz)
    assert np.unique(at).size == 33 ** 3
    # an entry and its brick-mates share one 128-byte line
    assert (at // 8 == lt.pair_index(ix & ~1, iy & ~1, iz & ~1) // 8).all()
    np.testing.assert_array_equal(pairs[at, 0:6:2], node)
    np.testing.assert_array_equal(pairs[at, 1:6:2],
                                  node[ix, iy, np.minimum(iz + 1, 32)])
    np.testing.assert_array_equal(pairs[at[:, :, 32], 1:6:2], node[:, :, 32])
    np.testing.assert_array_equal(pairs[at, 6:], 0)
    unused = np.ones(len(pairs), bool)
    unused[at.ravel()] = False
    np.testing.assert_array_equal(pairs[unused], 0)
    tx, w = lt._u8_corner_tables()
    assert tw.dtype == np.int32
    np.testing.assert_array_equal(tw & 0xFF, tx)
    np.testing.assert_array_equal(tw >> 8, w)


def _dp2a_lo(pair_words, bytes_lo):
    """__dp2a_lo(a, b, 0): a's signed 16-bit halves times b's two low
    signed bytes."""
    lo = (pair_words & 0xFFFF).to(torch.int16).to(torch.int32)
    hi = (pair_words >> 16).to(torch.int16).to(torch.int32)
    b0 = (bytes_lo & 0xFF).to(torch.int8).to(torch.int32)
    b1 = ((bytes_lo >> 8) & 0xFF).to(torch.int8).to(torch.int32)
    return lo * b0 + hi * b1


def _lab_n_kernel_emulation(batch_u8):
    """The CUDA kernel's arithmetic in plain torch: (tx, w) from the packed
    u8 table, 4 corner-pair loads of 4 int32 words from the brick-ordered
    pair table, __dp2a_lo with the packed (16 - wz, wz), the (dx, dy)
    weights."""
    tw, pairs = (torch.from_numpy(a) for a in lt._packed_tables())
    words = pairs.view(torch.int32)  # one 16-byte entry a row of 4 words
    v = batch_u8.to(torch.int64)
    e = [tw[v[..., c]] for c in range(3)]
    t = [x & 0xFF for x in e]
    f = [x >> 8 for x in e]
    wz2 = (16 - f[2]) | (f[2] << 8)
    acc = torch.zeros(batch_u8.shape, dtype=torch.int32)
    for dx in (0, 1):
        x = torch.clamp(t[0] + dx, max=32)
        wx = f[0] if dx else 16 - f[0]
        for dy in (0, 1):
            y = torch.clamp(t[1] + dy, max=32)
            wy = f[1] if dy else 16 - f[1]
            entry = words[lt.pair_index(x, y, t[2]).to(torch.int64)]
            for c in range(3):
                acc[..., c] += _dp2a_lo(entry[..., c], wz2) * (wx * wy)
    return (acc + 2048) >> 12


@pytest.mark.parametrize("case", ["ramps", "random_2_18"])
def test_kernel_emulation_matches_plain(case):
    if case == "ramps":
        batch = _structured()[None]
    else:
        batch = np.random.RandomState(3).randint(
            0, 256, (1, 512, 512, 3)).astype(np.uint8)
    batch = torch.from_numpy(batch)
    assert torch.equal(_lab_n_kernel_emulation(batch), lt.lab_n_plain(batch))
