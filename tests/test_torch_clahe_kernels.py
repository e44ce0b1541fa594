"""The lab_n, clahe_tile_luts and clahe_interp CUDA kernels against their
plain versions, on the card, bit-equal (every output is an exact integer or
u8 value).

Marked ``gpu``: skipped without a card. This file imports neither JAX nor
the JAX package, so on the card's machine it runs without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_clahe_kernels.py
"""
import numpy as np
import pytest
import torch

from mdir_tpu_torch.device import resolve_device
from mdir_tpu_torch.ops import clahe, lab_trilinear

pytestmark = pytest.mark.gpu

# ragged extents in a (1024, 1024) bucket: non-divisible, divisible, tiny,
# and a filler slot of the bucket's own shape
SHAPES = [(1000, 750), (683, 1024), (1024, 768), (512, 512), (1, 1), (7, 9),
          (1024, 1024)]
# a bucket whose width is not a multiple of 4 (one pixel a load), at grid 6
NARROW_BUCKET = (1020, 1026)
NARROW_SHAPES = [(1020, 1026), (1000, 1021), (683, 1026), (7, 9), (1, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


# pixel counts 1, 189 and 130 (not multiples of 4), a ragged last warp
# (1,000 pixels) and whole warps only (163,840 pixels)
@pytest.mark.parametrize("shape", [(1, 1, 1, 3), (3, 7, 9, 3),
                                   (1, 1, 130, 3), (1, 40, 25, 3),
                                   (2, 256, 320, 3)])
def test_lab_n_matches_plain(cuda, shape):
    rgb = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, shape).astype(np.uint8)).to(cuda)
    before = lab_trilinear.launches
    out = lab_trilinear.lab_n(rgb)
    torch.cuda.synchronize()
    assert lab_trilinear.launches == before + 1
    assert torch.equal(out, lab_trilinear.lab_n_plain(rgb))


def test_lab_n_on_offset_views(cuda):
    """A contiguous view at an odd byte offset (byte loads), and a sliced
    view made contiguous (a fresh, aligned copy)."""
    rng = np.random.RandomState(3)
    big = torch.from_numpy(rng.randint(0, 256, (3, 45, 67, 3)).astype(
        np.uint8)).to(cuda)
    flat = big.reshape(-1)
    shifted = flat[3:3 + 2 * 45 * 67 * 3].view(2, 45, 67, 3)
    assert shifted.is_contiguous() and shifted.data_ptr() % 4 != 0
    sliced = big[:, 1:, 2:].contiguous()
    for rgb in (shifted, sliced, big[1:]):
        assert torch.equal(lab_trilinear.lab_n(rgb),
                           lab_trilinear.lab_n_plain(rgb))


def test_lab_n_full_sweep(cuda):
    """All 256^3 RGB triples in one (1, 4096, 4096, 3) image."""
    v = torch.arange(256, device=cuda, dtype=torch.int32)
    rgb = torch.stack(torch.meshgrid(v, v, v, indexing="ij"), -1)
    rgb = rgb.reshape(1, 4096, 4096, 3).to(torch.uint8).contiguous()
    assert torch.equal(lab_trilinear.lab_n(rgb),
                       lab_trilinear.lab_n_plain(rgb))


def _bucket_values(rng, shapes, bh, bw):
    vals = np.zeros((len(shapes), bh, bw), np.int32)
    for i, (h, w) in enumerate(shapes):
        vals[i, :h, :w] = rng.randint(0, 256, (h, w))
    return vals


def _offset_copy(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=t.device)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    return shifted


# random values in SHAPES' bucket at four (clip, grid); one value
# everywhere (every lane of a warp counts one bin); the narrow bucket; and
# values and LUTs 4 bytes past a 16-byte boundary (one pixel a load, LUTs
# staged one entry at a time)
@pytest.mark.parametrize("clip,grid,bucket", [
    (2.0, 8, "random"), (4.0, 8, "random"), (40.0, 8, "random"),
    (4.0, 4, "random"), (4.0, 8, "constant"), (4.0, 6, "narrow"),
    (4.0, 8, "offset")])
def test_clahe_kernels_match_plain(cuda, clip, grid, bucket):
    rng = np.random.RandomState(1)
    shapes, (bh, bw) = (NARROW_SHAPES, NARROW_BUCKET) if bucket == "narrow" \
        else (SHAPES, (1024, 1024))
    vals = torch.from_numpy(_bucket_values(rng, shapes, bh, bw)).to(cuda)
    if bucket == "constant":
        vals.fill_(77)
    elif bucket == "offset":
        vals = _offset_copy(vals)
    aux = clahe.aux_to_device(
        clahe.clahe_bucket_aux(shapes, (bh, bw), clip, (grid, grid)), cuda)
    before = dict(clahe.launches)
    luts = clahe.clahe_tile_luts(vals, aux, (grid, grid))
    out = clahe.clahe_interp(
        vals, _offset_copy(luts) if bucket == "offset" else luts, aux,
        (grid, grid))
    torch.cuda.synchronize()
    assert clahe.launches["clahe_tile_luts"] \
        == before["clahe_tile_luts"] + 1
    assert clahe.launches["clahe_interp"] == before["clahe_interp"] + 1
    plain_luts = clahe.tile_luts_bucketed_plain(vals, aux, (grid, grid))
    assert torch.equal(luts, plain_luts)
    assert torch.equal(out, clahe.clahe_interp_bucketed_plain(
        vals, plain_luts, aux, (grid, grid)))


def test_clahe_kernels_on_offset_views(cuda):
    """LUTs 4, 8 and 12 bytes past a 16-byte boundary beside aligned
    values: 4 pixels a load, LUTs staged one entry at a time."""
    rng = np.random.RandomState(4)
    shapes = [(120, 96), (57, 43), (7, 9)]
    grid = (8, 8)
    vals = torch.from_numpy(_bucket_values(rng, shapes, 128, 96)).to(cuda)
    assert vals.data_ptr() % 16 == 0
    aux = clahe.aux_to_device(
        clahe.clahe_bucket_aux(shapes, (128, 96), 4.0, grid), cuda)
    luts = clahe.tile_luts_bucketed_plain(vals, aux, grid)
    out = clahe.clahe_interp_bucketed_plain(vals, luts, aux, grid)
    for offset in (1, 2, 3):
        shifted = torch.empty(luts.numel() + offset, dtype=luts.dtype,
                              device=cuda)[offset:].view(luts.shape)
        shifted.copy_(luts)
        assert shifted.data_ptr() % 16 == 4 * offset
        assert torch.equal(clahe.clahe_interp(vals, shifted, aux, grid), out)


def test_clahe_u8_and_lab_l_u8_match_plain(cuda):
    """The single-image static-grid CLAHE and the L-only plane, on the same
    kernels."""
    rng = np.random.RandomState(2)
    src = torch.from_numpy(rng.randint(0, 256, (683, 1000)).astype(
        np.uint8)).to(cuda)
    out = clahe.clahe_u8(src, 4.0, (8, 8))
    assert torch.equal(out, clahe.clahe_u8(src.cpu(), 4.0, (8, 8)).to(cuda))
    rgb = torch.from_numpy(rng.randint(0, 256, (2, 64, 96, 3)).astype(
        np.uint8)).to(cuda)
    assert torch.equal(lab_trilinear.lab_l_u8(rgb),
                       (lab_trilinear.lab_n_plain(rgb)[..., 0] * 255) >> 14)


def test_wrappers_refuse_what_they_do_not_take(cuda):
    vals = torch.zeros((1, 16, 16), dtype=torch.int32, device=cuda)
    aux = clahe.aux_to_device(clahe.clahe_bucket_aux([(16, 16)], (16, 16)),
                              cuda)
    with pytest.raises(ValueError, match="int32"):
        clahe.clahe_tile_luts(vals.float(), aux, (8, 8))
    with pytest.raises(ValueError, match="aux"):
        clahe.clahe_tile_luts(vals, clahe.aux_to_device(
            clahe.clahe_bucket_aux([(16, 16)], (16, 16)), "cpu"), (8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        lab_trilinear.lab_n(torch.zeros((1, 4, 4, 3), dtype=torch.uint8,
                                        device=cuda).transpose(1, 2))
