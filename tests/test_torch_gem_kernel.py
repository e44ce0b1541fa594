"""The GeM+L2N CUDA kernel, float32 and bfloat16 input, against its plain
version, on the card.

Marked ``gpu``: skipped without a card. This file imports neither JAX nor
the JAX package, so on the card's machine it runs without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gem_kernel.py
"""
import numpy as np
import pytest
import torch

from mdir_tpu_torch.device import resolve_device
from mdir_tpu_torch.ops import pooling, pooling_kernel

pytestmark = pytest.mark.gpu


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
            pooling_kernel.gem_l2n(x.half(), valid, p)
    with pytest.raises(ValueError, match="eval-only"):
        pooling_kernel.gem_l2n(x, valid, p.clone().requires_grad_())
