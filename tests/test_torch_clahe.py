"""The port's CLAHE (``ops/clahe.py``) against cv2, the JAX package's numpy
reference and XLA path, and its Pallas kernels in interpret mode: the shape,
clip and grid matrix of ``tests/test_clahe.py``. Bit-equal unless a
tolerance is stated."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.ops import clahe as jax_clahe
from mdir_tpu.ops import clahe_pallas as jax_clahe_pallas

from mdir_tpu_torch.ops import clahe

cv2 = pytest.importorskip("cv2")

SHAPES = [(64, 64), (100, 130), (37, 53), (256, 333), (513, 700), (9, 17)]
# ragged extents in one 128 x 128 bucket: non-divisible, divisible, tiny,
# and a filler slot that takes the bucket's own shape
BUCKET_SHAPES = [(57, 43), (64, 64), (100, 91), (33, 120), (128, 77),
                 (96, 128), (1, 1), (7, 9), (128, 128)]


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def _cv2_clahe(src, clip, grid):
    # cv2's tileGridSize is (cols, rows); ours is (rows, cols)
    return cv2.createCLAHE(clipLimit=clip,
                           tileGridSize=(grid[1], grid[0])).apply(src)


def _bucket(shapes, bh, bw, seed):
    rng = np.random.RandomState(seed)
    batch = np.zeros((len(shapes), bh, bw), np.int32)
    imgs = []
    for i, (h, w) in enumerate(shapes):
        img = rng.randint(0, 256, (h, w)).astype(np.uint8)
        imgs.append(img)
        batch[i, :h, :w] = img
    return batch, imgs


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("clip", [4, 2, 40])
def test_clahe_u8_matches_cv2_and_numpy(shape, clip):
    src = (np.random.RandomState(0).rand(*shape) * 255).astype(np.uint8)
    ref = _cv2_clahe(src, clip, (8, 8))
    np.testing.assert_array_equal(clahe.clahe_u8_np(src, clip), ref)
    out = clahe.clahe_u8(torch.from_numpy(src), clip)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_clahe_u8_other_grid():
    src = (np.random.RandomState(1).rand(120, 77) * 255).astype(np.uint8)
    ref = _cv2_clahe(src, 3, (6, 4))
    np.testing.assert_array_equal(clahe.clahe_u8_np(src, 3, (6, 4)), ref)
    np.testing.assert_array_equal(
        clahe.clahe_u8(torch.from_numpy(src), 3, (6, 4)).numpy(), ref)


def test_bucket_aux_matches_jax():
    ours = clahe.clahe_bucket_aux(BUCKET_SHAPES, (128, 128), 4.0, (8, 8))
    ref = jax_clahe.clahe_bucket_aux(BUCKET_SHAPES, (128, 128), 4.0, (8, 8))
    assert set(ours) == set(ref) | {"th", "tw"}
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key], value)
    assert ours["th"][0] == 8 and ours["tw"][0] == 6  # 57x43 pads to 64x48


@pytest.mark.parametrize("clip,grid", [(2.0, 8), (4.0, 8), (40.0, 8),
                                       (4.0, 4), (2.5, 4)])
def test_bucketed_matches_cv2_numpy_and_jax(clip, grid):
    """Every image of a ragged bucket, at its true size, bit-equal to cv2,
    to the port's numpy reference and to the JAX package's bucketed XLA
    path on the whole bucket."""
    grid = (grid, grid)
    batch, imgs = _bucket(BUCKET_SHAPES, 128, 128, seed=3)
    aux = clahe.clahe_bucket_aux(BUCKET_SHAPES, (128, 128), clip, grid)
    out = clahe.clahe_u8_bucketed(torch.from_numpy(batch),
                                  clahe.aux_to_device(aux, "cpu"), grid)
    assert out.dtype == torch.float32 and out.shape == batch.shape
    out = out.numpy()
    for i, (h, w) in enumerate(BUCKET_SHAPES):
        ref = _cv2_clahe(imgs[i], clip, grid)
        np.testing.assert_array_equal(out[i, :h, :w].astype(np.uint8), ref)
        np.testing.assert_array_equal(
            clahe.clahe_u8_np(imgs[i], clip, grid), ref)
    jax_aux = {k: jnp.asarray(v) for k, v in aux.items()
               if k not in ("th", "tw")}
    ref = np.asarray(jax_clahe.clahe_u8_bucketed_jax(jnp.asarray(batch),
                                                     jax_aux, grid))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("side", [32, 40, 48])
def test_small_buckets(side):
    shapes = [(side, side), (side - 8, side - 4)]
    batch, imgs = _bucket(shapes, side, side, seed=5)
    aux = clahe.aux_to_device(
        clahe.clahe_bucket_aux(shapes, (side, side), 2.0, (8, 8)), "cpu")
    out = clahe.clahe_u8_bucketed(torch.from_numpy(batch), aux).numpy()
    for i, (h, w) in enumerate(shapes):
        np.testing.assert_array_equal(out[i, :h, :w].astype(np.uint8),
                                      _cv2_clahe(imgs[i], 2.0, (8, 8)))


def test_tile_luts_match_pallas_interpret():
    """The LUT stage against the Pallas ``tile_luts_pallas`` in interpret
    mode, on a grid-divisible image (no padding)."""
    src = (np.random.RandomState(6).rand(64, 96) * 255).astype(np.uint8)
    aux = clahe.aux_to_device(
        clahe.clahe_bucket_aux([src.shape], src.shape, 4.0, (8, 8)), "cpu")
    ours = clahe.clahe_tile_luts(
        torch.from_numpy(src.astype(np.int32))[None], aux, (8, 8))
    ref = np.asarray(jax_clahe_pallas.tile_luts_pallas(
        jnp.asarray(src), clip_limit=4.0, grid=(8, 8), interpret=True))
    np.testing.assert_array_equal(ours[0].numpy(), ref)


def test_interp_matches_pallas_interpret_and_xla():
    """The interpolation stage, given the same LUTs: bit-equal to the JAX
    package's XLA contraction (cv2-exact), and within 1 u8 of the Pallas
    ``clahe_interp_bucketed_pallas`` in interpret mode, the bound its own
    test states (``tests/test_pooling_pallas.py``: that kernel multiplies
    the two axis weights first, so its rounding differs from cv2's)."""
    shapes = [(57, 43), (100, 91), (128, 77), (1, 1)]
    batch, _ = _bucket(shapes, 128, 128, seed=4)
    aux = clahe.clahe_bucket_aux(shapes, (128, 128), 4.0, (8, 8))
    taux = clahe.aux_to_device(aux, "cpu")
    luts = clahe.clahe_tile_luts(torch.from_numpy(batch), taux, (8, 8))
    ours = clahe.clahe_interp(torch.from_numpy(batch), luts, taux,
                              (8, 8)).numpy()
    xla = np.asarray(jax.vmap(lambda v, lut, ith, itw:
                              jax_clahe._interp_dynamic(v, lut, ith, itw, 8,
                                                        8))(
        jnp.asarray(batch), jnp.asarray(luts.numpy()),
        jnp.asarray(aux["inv_th"]), jnp.asarray(aux["inv_tw"])))
    np.testing.assert_array_equal(ours, xla)
    pallas = np.asarray(jax_clahe_pallas.clahe_interp_bucketed_pallas(
        jnp.asarray(batch), jnp.asarray(luts.numpy()),
        jnp.asarray(aux["inv_th"]), jnp.asarray(aux["inv_tw"]),
        interpret=True))
    for i, (h, w) in enumerate(shapes):
        assert np.abs(ours[i, :h, :w] - pallas[i, :h, :w]).max() <= 1.0


def test_wrappers_take_cpu_through_plain_and_refuse_other_input():
    batch, _ = _bucket([(16, 16)], 16, 16, seed=7)
    aux = clahe.aux_to_device(
        clahe.clahe_bucket_aux([(16, 16)], (16, 16), 4.0, (8, 8)), "cpu")
    before = dict(clahe.launches)
    clahe.clahe_u8_bucketed(torch.from_numpy(batch), aux)
    assert clahe.launches == before  # the CPU runs the plain versions
    with pytest.raises(ValueError, match="uint8"):
        clahe.clahe_u8(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not fit"):
        clahe.clahe_bucket_aux([(20, 8)], (16, 16))
