"""The GeM+L2N CUDA kernel, float32, bfloat16 and float16 input, against its
plain version, on the card; and on the CPU, what its wrapper takes.

The card tests are marked ``gpu``: skipped without a card. This file imports
neither JAX nor the JAX package, so on the card's machine it runs without
the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gem_kernel.py
"""
import numpy as np
import pytest
import torch

from mdir_tpu_torch.device import resolve_device
from mdir_tpu_torch.ops import pooling, pooling_kernel

gpu = pytest.mark.gpu
P_VALUES = (1.0, 2.5, 3.0, 4.7)
HALF_TYPES = (torch.bfloat16, torch.float16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


def _ragged_input(rng, shape, device):
    n, c, h, w = shape
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)
    valid = np.stack([rng.randint(1, h + 1, n), rng.randint(1, w + 1, n)], 1)
    valid[0] = (h, w)
    valid[-1] = (1, 1)
    return x, torch.from_numpy(valid.astype(np.int32)).to(device)


def _against_plain(x, valid, p):
    before = pooling_kernel.launches
    with torch.no_grad():
        out = pooling_kernel.gem_l2n(x, valid, p)
    torch.cuda.synchronize()
    assert pooling_kernel.launches == before + 1
    torch.testing.assert_close(out, pooling.gem_l2n_plain(x, valid, p),
                               rtol=1e-5, atol=1e-6)


# the main paths' largest maps (ResNet101 and VGG16, full and 8-image
# chunks), unaligned widths, odd extents, one row, C not a multiple of the
# channel group (1001 = 7 x 126 + 119), one image
@gpu
@pytest.mark.parametrize("shape", [(16, 2048, 32, 24), (16, 2048, 23, 17),
                                   (8, 2048, 24, 32), (16, 512, 64, 48),
                                   (16, 512, 45, 34), (8, 512, 48, 64),
                                   (3, 2048, 7, 9),
                                   (2, 64, 1, 33), (4, 1001, 12, 16),
                                   (1, 2048, 32, 24)])
@pytest.mark.parametrize("p", [1.0, 2.5, 3.0, 4.7])
def test_kernel_matches_plain(cuda, shape, p):
    x, valid = _ragged_input(np.random.RandomState(0), shape, cuda)
    _against_plain(x, valid, torch.tensor([p], device=cuda))


@gpu
def test_kernel_on_an_offset_view(cuda):
    """A contiguous view 4 bytes past a 16-byte boundary (float loads), and
    a sliced view made contiguous (a fresh, aligned copy)."""
    rng = np.random.RandomState(1)
    shape = (4, 256, 16, 12)
    x, valid = _ragged_input(rng, shape, cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    shifted = flat[1:].view(shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    p = torch.tensor([3.0], device=cuda)
    _against_plain(shifted, valid, p)
    wide, _ = _ragged_input(rng, (4, 256, 16, 13), cuda)
    _against_plain(wide[..., 1:].contiguous(), valid, p)


# bfloat16 maps: widths that load 8, 4, 2 and 1 cells (24, 20, 22, 23), the
# VGG16 path's 64 x 48, one row, odd channels, the small-batch launch
@gpu
@pytest.mark.parametrize("shape", [(16, 2048, 32, 24), (16, 2048, 32, 20),
                                   (16, 2048, 18, 22), (16, 2048, 23, 23),
                                   (16, 512, 64, 48), (8, 512, 45, 34),
                                   (2, 64, 1, 33), (4, 1001, 12, 16)])
@pytest.mark.parametrize("p", [1.0, 2.5, 3.0, 4.7])
def test_bf16_kernel_matches_plain(cuda, shape, p):
    """The bf16-input kernel against its plain version,
    gem_l2n_plain(x.float()): the same cells widened exactly, so only the
    float32 sums' order differs."""
    x, valid = _ragged_input(np.random.RandomState(2), shape, cuda)
    x = x.to(torch.bfloat16)
    p = torch.tensor([p], device=cuda)
    before = pooling_kernel.launches
    with torch.no_grad():
        out = pooling_kernel.gem_l2n(x, valid, p)
    torch.cuda.synchronize()
    assert pooling_kernel.launches == before + 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, pooling.gem_l2n_plain(x.float(), valid, p),
                               rtol=1e-5, atol=1e-6)


@gpu
def test_bf16_kernel_on_offset_views(cuda):
    """bf16 views 2, 4 and 8 bytes past a 16-byte boundary (1-, 2- and
    4-cell loads at a width of 24), and a bf16 p."""
    rng = np.random.RandomState(3)
    shape = (4, 256, 16, 24)
    x, valid = _ragged_input(rng, shape, cuda)
    x = x.to(torch.bfloat16)
    p = torch.tensor([3.0], device=cuda)
    ref = pooling.gem_l2n_plain(x.float(), valid, p)
    for cells in (1, 2, 4):
        flat = torch.empty(x.numel() + cells, device=cuda,
                           dtype=torch.bfloat16)
        shifted = flat[cells:].view(shape)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 == 2 * cells
        with torch.no_grad():
            out = pooling_kernel.gem_l2n(shifted, valid,
                                         p.to(torch.bfloat16))
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.rand(2, 8, 4, 4, device=cuda)
    valid = torch.full((2, 2), 4, dtype=torch.int32, device=cuda)
    p = torch.tensor([3.0], device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            pooling_kernel.gem_l2n(x.transpose(2, 3), valid, p)
        with pytest.raises(ValueError, match="int32"):
            pooling_kernel.gem_l2n(x, valid.long(), p)
        with pytest.raises(ValueError, match="float32"):
            pooling_kernel.gem_l2n(x.double(), valid, p)
        with pytest.raises(ValueError, match="bfloat16"):
            pooling_kernel.gem_l2n(x.to(torch.int32), valid, p)
    with pytest.raises(ValueError, match="eval-only"):
        pooling_kernel.gem_l2n(x, valid, p.clone().requires_grad_())


def _half_against_plain(x, valid, p, geometry=None):
    """A map through the kernel (the wrapper, or one launch at
    ``geometry``) against gem_l2n_plain(x.float()): a 16-bit map's cells
    widened exactly, so only the float32 sums' order and the power's error
    differ."""
    p = torch.tensor([p], device=x.device)
    ref = pooling.gem_l2n_plain(x.float(), valid, p)
    with torch.no_grad():
        if geometry is None:
            before = pooling_kernel.launches
            out = pooling_kernel.gem_l2n(x, valid, p)
            assert pooling_kernel.launches == before + 1
        else:
            out = torch.empty_like(ref)
            assert pooling_kernel._launch(x, valid, p, out, geometry,
                                          1e-6) == 0
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


# widths that are multiples of 8, 4 and 2 cells, and odd; the ResNet and
# VGG16 maps at scale 1 (bulk route when whole), the 8-image launch
@gpu
@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("shape", [(16, 2048, 32, 24), (16, 2048, 32, 20),
                                   (16, 2048, 18, 22), (16, 2048, 23, 17),
                                   (16, 512, 64, 48), (8, 2048, 24, 32),
                                   (3, 64, 5, 7)])
@pytest.mark.parametrize("p", P_VALUES)
def test_16_bit_kernels_ragged(cuda, dtype, shape, p):
    """Ragged extents (the first image whole, the last one cell): the walk
    route, and the bulk route for the whole image where it applies."""
    x, valid = _ragged_input(np.random.RandomState(4), shape, cuda)
    _half_against_plain(x.to(dtype), valid, p)


@gpu
@pytest.mark.parametrize("dtype", (torch.float32,) + HALF_TYPES)
@pytest.mark.parametrize("shape", [(16, 2048, 32, 24), (16, 2048, 16, 12),
                                   (16, 512, 64, 48), (8, 2048, 24, 32),
                                   (4, 1001, 4, 8)])
@pytest.mark.parametrize("p", P_VALUES)
def test_whole_extents_take_the_bulk_route(cuda, dtype, shape, p):
    """Every image whole, at maps whose stages hold a plane per warp, more
    planes than warps (scale 1/2), fewer (VGG16: a plane split across
    warps), and odd channels (a short last stage)."""
    n, c, h, w = shape
    x = torch.from_numpy(np.random.RandomState(5).rand(*shape).astype(
        np.float32)).to(cuda, dtype)
    valid = torch.tensor([[h, w]] * n, dtype=torch.int32, device=cuda)
    assert pooling_kernel.launch_geometry(
        n, c, h, w, 16, x.element_size()).stage_planes > 0
    if dtype == torch.float32:
        _against_plain(x, valid, torch.tensor([p], device=cuda))
    else:
        _half_against_plain(x, valid, p)


@gpu
@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("cells", [1, 2, 4])
def test_16_bit_kernels_on_offset_views(cuda, dtype, cells):
    """Views 2, 4 and 8 bytes past a 16-byte boundary: walked with 1-, 2- and
    4-cell loads, whole extents included (no bulk copy from them)."""
    rng = np.random.RandomState(6)
    shape = (4, 256, 16, 24)
    x, valid = _ragged_input(rng, shape, cuda)
    flat = torch.empty(x.numel() + cells, device=cuda, dtype=dtype)
    shifted = flat[cells:].view(shape)
    shifted.copy_(x.to(dtype))
    assert shifted.data_ptr() % 16 == 2 * cells
    assert pooling_kernel.launch_geometry(
        *shape, shifted.data_ptr() & -shifted.data_ptr(), 2).stage_planes == 0
    for p in P_VALUES:
        _half_against_plain(shifted, valid, p)


@gpu
@pytest.mark.parametrize("dtype", (torch.float32,) + HALF_TYPES)
@pytest.mark.parametrize("blocks,threads,ring", [
    (8, 512, True), (16, 512, False), (64, 128, True), (17, 256, False),
    (1, 32, True)])
def test_kernels_at_other_launches(cuda, dtype, blocks, threads, ring):
    """The launches ``kernel_times.py`` sweeps: other blocks per image and
    block sizes (up to 16 warps splitting a plane), whole images through
    the ring or walked, down to one block of one warp an image, on whole
    and ragged images at the ResNet and VGG16 maps."""
    for shape in ((16, 2048, 32, 24), (16, 512, 64, 48)):
        n, c, h, w = shape
        x, valid = _ragged_input(np.random.RandomState(7), shape, cuda)
        valid[: n // 2] = torch.tensor([h, w], dtype=torch.int32)
        x = x.to(dtype)
        g = pooling_kernel.launch_geometry(n, c, h, w, 16, x.element_size())
        group = -(-c // blocks)
        g = g._replace(blocks=-(-c // group), group=group, threads=threads,
                       stage_planes=g.stage_planes if ring else 0)
        for p in (2.5, 3.0):
            _half_against_plain(x, valid, p, g)


@gpu
def test_kernel_leaves_its_counters_zero(cuda):
    """Each launch leaves the per-image counters it takes tickets on at
    zero, so the next launch on the stream finds them ready, at any batch
    (and a refused launch touches none)."""
    rng = np.random.RandomState(10)
    for n in (1, 16, 3, 70):
        x, valid = _ragged_input(rng, (n, 96, 6, 8), cuda)
        _against_plain(x, valid, torch.tensor([2.5], device=cuda))
        stream = torch.cuda.current_stream().cuda_stream
        counter = pooling_kernel._counters[(cuda.index or 0, stream)]
        assert counter.numel() >= n and not counter.any()


def test_wrapper_refuses_other_types():
    """float64 and integer maps are refused on either device (the card's
    refusal: test_kernel_refuses_what_it_does_not_take)."""
    rng = np.random.RandomState(8)
    valid = torch.full((2, 2), 4, dtype=torch.int32)
    for dtype in (torch.float64, torch.int64, torch.int8):
        x = torch.from_numpy(rng.rand(2, 8, 4, 4)).to(dtype)
        with pytest.raises(ValueError, match="float16"):
            pooling_kernel.gem_l2n(x, valid, 3.0)


@pytest.mark.parametrize("dtype", HALF_TYPES)
def test_wrapper_routes_16_bit_maps_to_plain_on_cpu(dtype):
    """On the CPU a float16 or bfloat16 map is the plain version of its
    float32 widening, with no launch."""
    x, valid = _ragged_input(np.random.RandomState(9), (3, 40, 6, 10), "cpu")
    before = pooling_kernel.launches
    out = pooling_kernel.gem_l2n(x.to(dtype), valid,
                                 torch.tensor([2.5], dtype=dtype))
    assert pooling_kernel.launches == before
    assert torch.equal(out, pooling.gem_l2n_plain(
        x.to(dtype).float(), valid, torch.tensor([2.5])))
