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


# (extents, bucket, grid) of the kernels' launch checks: the ragged
# bucket, the CLAHE path's first chunk, the card tests' buckets (tiny
# images in a large bucket; a width that is not a multiple of 4)
GEOMETRY_BUCKETS = [
    (BUCKET_SHAPES, (128, 128), 8), (BUCKET_SHAPES, (128, 128), 4),
    ([(1024, 768)] * 12 + [(1000, 750)] * 4, (1024, 768), 8),
    ([(768, 1024)] * 8 + [(683, 1024)] * 8, (768, 1024), 8),
    ([(1000, 750), (683, 1024), (1024, 768), (512, 512), (1, 1), (7, 9),
      (1024, 1024)], (1024, 1024), 8),
    ([(1020, 1026), (1000, 1021), (683, 1026), (7, 9), (1, 1)],
     (1020, 1026), 6)]


def _tile_rows(aux, size, grid_rows):
    """(B, size) lower and upper tile row of each bucket row, as the
    interpolation kernel computes them: f32 ``y * inv_th - 0.5``."""
    f = (np.arange(size, dtype=np.float32)[None, :]
         * aux["inv_th"][:, None]).astype(np.float32) - np.float32(0.5)
    lo = np.floor(f).astype(np.int64)
    return (np.clip(lo, 0, grid_rows - 1),
            np.clip(lo + 1, 0, grid_rows - 1))


@pytest.mark.parametrize("shapes,bucket,grid", GEOMETRY_BUCKETS)
def test_interp_geometry_stages_every_strip(shapes, bucket, grid):
    """Each strip's tile rows, from the first row's lower to the last row's
    upper tile, fit the rows the launch stages, at the wrapper's strip and
    at the sweep's; the JAX package's aux gives the same rows."""
    bh, bw = bucket
    aux = clahe.clahe_bucket_aux(shapes, bucket, 4.0, (grid, grid))
    jax_aux = jax_clahe.clahe_bucket_aux(shapes, bucket, 4.0, (grid, grid))
    lo, hi = _tile_rows(aux, bh, grid)
    for a, b in zip((lo, hi), _tile_rows(jax_aux, bh, grid)):
        np.testing.assert_array_equal(a, b)
    for rows in (1, 4, clahe.INTERP_ROWS, clahe.INTERP_MAX_ROWS):
        g = clahe.interp_geometry(bh, bw, grid, grid, strip_rows=rows)
        assert g.strip_rows <= rows and g.smem_bytes <= clahe.STAGE_BYTES
        assert g.threads_x * g.threads_y <= clahe.INTERP_THREADS
        for y0 in range(0, bh, g.strip_rows):
            last = min(y0 + g.strip_rows, bh) - 1
            span = hi[:, last] - lo[:, y0] + 1
            assert span.max() <= g.staged_rows
            if aux["th"].min() >= g.strip_rows:  # the main path's tiles
                assert span.max() <= 3
    g = clahe.interp_geometry(bh, bw, grid, grid)
    assert g.vec == (4 if bw % 4 == 0 else 1)
    assert g.threads_x == min(bw // g.vec, clahe.INTERP_THREADS)
    assert clahe.interp_geometry(bh, bw, grid, grid, False).vec == 1


@pytest.mark.parametrize("shapes,bucket,grid", GEOMETRY_BUCKETS)
def test_tile_luts_geometry_holds_every_tile(shapes, bucket, grid):
    """The staged maps hold every image's tile, and the columns that map
    to themselves, which the kernel counts and loads as int4, are the
    tile's columns inside the image: a prefix, the rest map to earlier
    columns (cv2's reflection), in this package's aux and the JAX one's."""
    bh, bw = bucket
    aux = clahe.clahe_bucket_aux(shapes, bucket, 4.0, (grid, grid))
    jax_aux = jax_clahe.clahe_bucket_aux(shapes, bucket, 4.0, (grid, grid))
    g = clahe.tile_luts_geometry(bh, bw, grid, grid)
    assert aux["th"].max() <= g.max_th and aux["tw"].max() <= g.max_tw
    assert g.smem_bytes == 4 * (8 * 256 + g.max_th + g.max_tw)
    assert g.vec == (bw % 4 == 0)
    assert not clahe.tile_luts_geometry(bh, bw, grid, grid, False).vec
    for col_src in (aux["col_src"], jax_aux["col_src"]):
        for i, (h, w) in enumerate(shapes):
            tw = aux["tw"][i]
            for tx in range(grid):
                idx = np.arange(tx * tw, (tx + 1) * tw)
                seg = col_src[i, idx]
                inside = int(np.sum(seg == idx))
                assert inside == min(max(w - tx * tw, 0), tw)
                assert (seg[inside:] < idx[inside:]).all()


def test_geometry_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="divisible"):
        clahe.tile_luts_geometry(100, 128, 8, 8)
    with pytest.raises(ValueError, match="strips"):
        clahe.interp_geometry(128, 128, 8, 8, strip_rows=clahe.INTERP_MAX_ROWS
                              + 1)
    with pytest.raises(ValueError, match="tile columns"):
        clahe.interp_geometry(1024, 1024, 2, 1024)
    with pytest.raises(ValueError, match="too large"):
        clahe.interp_geometry(2 ** 16, 2 ** 15, 8, 8)
    # a fine grid stages fewer rows per strip, within STAGE_BYTES
    g = clahe.interp_geometry(1024, 1024, 32, 32)
    assert g.smem_bytes <= clahe.STAGE_BYTES and g.strip_rows < 16


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
