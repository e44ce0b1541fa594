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


@pytest.mark.parametrize("name", ["mac", "spoc", "gem", "rmac"])
@pytest.mark.parametrize("masked", [False, True])
def test_pools_match_jax(rng, name, masked):
    """Each global pool, unmasked and under the valid-extent mask; RMAC's
    masked form is ``rmac_masked`` over each extent's region boxes, R
    rounded up to a multiple of 8 with empty slots."""
    x = rng.rand(3, 7, 9, 16).astype(np.float32)
    valid = np.asarray([[7, 9], [3, 4], [1, 1]], np.int32)
    if name == "rmac" and masked:
        per_img = [pooling.rmac_region_boxes(h, w) for h, w in valid]
        boxes = np.zeros((3, -(-max(map(len, per_img)) // 8) * 8, 4),
                         np.int32)
        for i, b in enumerate(per_img):
            boxes[i, :len(b)] = b
        assert jax_pooling.rmac_region_boxes(7, 9) == per_img[0]
        ref = jax_pooling.rmac_masked(jnp.asarray(x), jnp.asarray(boxes))
        ours = pooling.rmac_masked(_nchw(x), torch.from_numpy(boxes))
        np.testing.assert_allclose(np.asarray(ref), ours.numpy(),
                                   rtol=1e-5, atol=1e-6)
        return
    jmask = tmask = None
    if masked:
        jmask = jax_feature_mask((7, 9), jnp.asarray(valid))
        tmask = pooling.feature_mask((7, 9), torch.from_numpy(valid))
        np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    kwargs = ({}, {}) if name == "rmac" else ({"mask": jmask},
                                              {"mask": tmask})
    ref = jax_pooling.POOLING[name](jnp.asarray(x), **kwargs[0])
    ours = pooling.POOLING[name](_nchw(x), **kwargs[1])
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


# feature maps of the main path's chunks: ResNet101 (stride 32) and VGG16
# (stride 16) at scales 1, 2^-1/2, 1/2 of (1024, 768) and (768, 1024)
# buckets, batch 16, then the two shapes of the card tests
MAIN_PATH_SHAPES = [
    (16, 2048, 32, 24), (16, 2048, 23, 17), (16, 2048, 16, 12),
    (16, 2048, 24, 32), (16, 2048, 17, 23), (16, 2048, 12, 16),
    (16, 512, 64, 48), (16, 512, 45, 34), (16, 512, 32, 24),
    (16, 512, 48, 64), (16, 512, 34, 45), (16, 512, 24, 32),
    (8, 2048, 29, 22), (8, 512, 57, 44),
]


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES + [(3, 2048, 7, 9),
                                                      (2, 64, 1, 33)])
def test_gem_launch_geometry(shape):
    n, c, h, w = shape
    g = pooling_kernel.launch_geometry(n, c, h, w)
    assert n * g.blocks <= pooling_kernel.TARGET_BLOCKS + n
    assert g.threads % 32 == 0 and 4 * g.group <= 48 * 1024
    covered = []
    for block in range(g.blocks):
        channels = range(block * g.group, min((block + 1) * g.group, c))
        assert len(channels) > 0  # no empty block
        covered.extend(channels)
    assert covered == list(range(c))  # every channel exactly once
    assert g.load_bytes == (16 if w % 4 == 0 else 4)
    # a tensor that is not 16-byte aligned loads floats whatever its width
    assert pooling_kernel.launch_geometry(n, c, h, w, False).load_bytes == 4


@pytest.mark.parametrize("w,alignment,load_bytes", [
    (24, 16, 16), (32, 256, 16), (20, 16, 8), (22, 16, 4), (23, 16, 2),
    (24, 8, 8), (24, 4, 4), (24, 2, 2), (24, False, 2)])
def test_gem_launch_geometry_bf16(w, alignment, load_bytes):
    """16-bit rows (bfloat16 and float16 alike) load 16 bytes (8 cells)
    where the width and the tensor's alignment allow, else 8, 4 or 2 bytes;
    the channel split and the threads are the float32 ones, and the ring's
    stages hold as many bytes as float32's (twice the planes)."""
    g = pooling_kernel.launch_geometry(16, 2048, 32, w, alignment, 2)
    f32 = pooling_kernel.launch_geometry(16, 2048, 32, w, alignment, 4)
    assert g.load_bytes == load_bytes
    assert (g.blocks, g.group, g.threads) \
        == (f32.blocks, f32.group, f32.threads)
    if f32.stage_planes:
        assert g.stage_planes == 2 * f32.stage_planes


@pytest.mark.parametrize("shape,itemsize,alignment,stage_planes", [
    ((16, 2048, 32, 24), 2, 16, 8),  # ResNet at scale 1: 1536-byte planes
    ((16, 2048, 32, 24), 4, 16, 4),
    ((8, 2048, 24, 32), 2, 256, 8),  # the 8-image launch
    ((16, 2048, 16, 12), 2, 16, 32),  # scale 1/2: more planes than warps
    ((16, 512, 64, 48), 2, 16, 2),  # VGG16: fewer planes than warps
    ((16, 512, 64, 48), 4, 16, 1),
    ((16, 2048, 23, 17), 2, 16, 0),  # 782-byte planes: walked
    ((16, 512, 45, 34), 2, 16, 0),
    ((16, 2048, 32, 24), 2, 8, 0),  # not 16-byte aligned: walked
    ((16, 2048, 32, 24), 2, False, 0),
    ((1, 4, 400, 400), 4, 16, 0),  # 640 KB planes: walked
    ((1, 4, 128, 96), 4, 16, 1),  # 48 KB planes: a stage of one plane
    ((1, 4, 128, 97), 4, 16, 0),  # just over 48 KB: walked
])
def test_gem_bulk_route_geometry(shape, itemsize, alignment, stage_planes):
    """The bulk route's ring: the largest power of two of planes that fits
    a stage (at most the block's channels), and none where the tensor is
    not 16-byte aligned, a plane is not a multiple of 16 bytes or a plane
    is larger than MAX_PLANE_BYTES (the two-stage ring would not fit)."""
    n, c, h, w = shape
    g = pooling_kernel.launch_geometry(n, c, h, w, alignment, itemsize)
    assert g.stage_planes == stage_planes
    if stage_planes:
        stage = stage_planes * h * w * itemsize
        assert stage <= pooling_kernel.STAGE_BYTES or stage_planes == 1
        assert h * w * itemsize <= pooling_kernel.MAX_PLANE_BYTES
        assert stage_planes <= g.group
        assert stage % 16 == 0


@pytest.mark.parametrize("n", [1, 3, 8, 9, 11, 12, 16])
def test_gem_launch_fills_the_card(n):
    """At any batch the launch puts about two blocks on each of the 132 SMs
    (the 8-image launch of PRs 6-10 had 64 blocks): more than 132, fewer
    than TARGET_BLOCKS plus one an image."""
    g = pooling_kernel.launch_geometry(n, 2048, 24, 32, 16, 2)
    assert 132 < n * g.blocks <= pooling_kernel.TARGET_BLOCKS + n
    assert g.threads % 32 == 0 and g.threads <= 512


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gem_wrapper_widens_16_bit_maps_on_cpu(rng, dtype):
    """On the CPU a 16-bit map (and a 16-bit p) takes the plain version of
    its exactly widened float32 cells."""
    x = _nchw(rng.rand(3, 7, 9, 16).astype(np.float32)).to(dtype)
    valid = torch.tensor([[7, 9], [3, 4], [1, 1]], dtype=torch.int32)
    before = pooling_kernel.launches
    out = pooling_kernel.gem_l2n(x, valid, torch.tensor([2.5], dtype=dtype))
    assert pooling_kernel.launches == before and out.dtype == torch.float32
    assert torch.equal(out, pooling.gem_l2n_plain(x.float(), valid,
                                                  torch.tensor([2.5])))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.uint8])
def test_gem_wrapper_refuses_other_types_on_cpu(dtype):
    """The wrapper takes what the kernel takes on either device: float64
    and integer maps are refused, not pooled."""
    x = torch.ones(2, 8, 4, 4, dtype=dtype)
    valid = torch.full((2, 2), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        pooling_kernel.gem_l2n(x, valid, torch.tensor([3.0]))


@pytest.mark.parametrize("c", [1, 9, 1001])
def test_gem_launch_geometry_odd_channels(c):
    g = pooling_kernel.launch_geometry(1, c, 5, 8)
    assert (g.blocks - 1) * g.group < c <= g.blocks * g.group
    with pytest.raises(ValueError):
        pooling_kernel.launch_geometry(0, c, 5, 8)


@pytest.mark.parametrize("p", [2.5, 3.0])
def test_gem_head_gradients_match_jax(rng, p):
    """The port's GeM head under autograd (its plain version) against
    jax.grad of the JAX package's masked gem + l2n."""
    from mdir_tpu_torch.models.retrievalnet import GeMPoolL2N

    x = rng.rand(3, 7, 9, 16).astype(np.float32)
    valid = np.asarray([[7, 9], [3, 4], [1, 1]], np.int32)
    weights = rng.randn(3, 16).astype(np.float32)

    def loss(x, p):
        mask = jax_feature_mask((7, 9), jnp.asarray(valid))
        out = jax_pooling.l2n(jax_pooling.gem(x, p=p[0], mask=mask))
        return jnp.sum(out * weights)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                           jnp.asarray([p], jnp.float32))
    head = GeMPoolL2N(p_init=p)
    tx = _nchw(x).requires_grad_()
    out = head(tx, torch.from_numpy(valid))
    (out * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(gx).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(head.p.grad.numpy(), np.asarray(gp),
                               rtol=1e-5, atol=1e-7)


def test_gem_head_takes_the_kernel_only_without_gradients(monkeypatch, rng):
    from mdir_tpu_torch.models.retrievalnet import GeMPoolL2N

    calls = []

    def kernel(x, valid_hw, p, eps=1e-6):
        calls.append(x.shape)
        return pooling.gem_l2n_plain(x, valid_hw, p, eps=eps)

    monkeypatch.setattr(pooling_kernel, "gem_l2n", kernel)
    head = GeMPoolL2N()
    x = _nchw(rng.rand(2, 4, 5, 8).astype(np.float32))
    valid = torch.tensor([[4, 5], [2, 3]], dtype=torch.int32)
    out = head(x, valid)  # p requires a gradient: the plain version
    assert calls == [] and out.requires_grad
    with torch.no_grad():
        ref = head(x, valid)
    assert calls == [x.shape]
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
