"""Masked GeM + L2N: the wrapper of the sm_90a CUDA kernel ``csrc/gem_l2n.cu``.

The kernel replaces the Pallas TPU kernel
``mdir_tpu/ops/pooling_pallas.py::_gem_kernel`` (``gem_l2n_pallas``). It is
memory-bound: it reads each valid feature cell once and writes N*C floats, so
its least time is those bytes over the card's memory rate. It is one launch:
each image is a cluster of blocks, each block pools a contiguous group of
channels with one warp per plane, and the blocks of a cluster share their
sums of squares to divide by the L2 norm (see the source).
``launch_geometry`` picks the cluster, the channel group and the load width
from the shape. The kernel takes float32 or bfloat16 features (the bf16
extraction program's trunk output, read at half the bytes) and pools in
float32 either way; its plain version for bfloat16 is
``gem_l2n_plain(x.float(), ...)``.

For a tensor on the CPU the wrapper computes the plain version
(``pooling.gem_l2n_plain``); for a CUDA tensor it launches the kernel or
raises. It is eval-only, like the TPU kernel, which has no gradient.
"""
import collections
import ctypes

import torch

from .. import _build
from .pooling import gem_l2n_plain

launches = 0  # kernel launches since the last reset_launches()

# (blocks per image, threads per block) from FULL_BATCH images up, and
# below: of the launches ``kernel_times.py`` tries at the main
# paths' maps, the fastest or within 5 % of it on an H100 (PERF.md §6); a
# cluster of 16 is above the portable 8, and the kernel allows it
FULL_BATCH = 12
FULL_BATCH_LAUNCH = (16, 256)
SMALL_BATCH_LAUNCH = (8, 1024)
MAX_GROUP = 12288  # pooled floats a block keeps in 48 KB of shared memory
_ENTRY = {torch.float32: "gem_l2n_f32", torch.bfloat16: "gem_l2n_bf16"}


# cluster: blocks per image (one thread-block cluster); group: channels per
# block; load_bytes: bytes a load reads (16, or one float32; 16, 8, 4 or one
# bfloat16); threads: per block
Geometry = collections.namedtuple("Geometry",
                                  "cluster group load_bytes threads")


def reset_launches():
    global launches
    launches = 0


def launch_geometry(n, c, h, w, alignment=16, itemsize=4):
    """The kernel's launch for an (n, c, h, w) input of ``itemsize``-byte
    cells (4: float32, 2: bfloat16) whose address is a multiple of
    ``alignment`` bytes.

    One cluster of ``cluster`` blocks per image; block r pools
    channels [r * group, min((r + 1) * group, c)), so every channel is
    pooled once and no block is empty. Rows load 16 bytes at a time when
    their width is a multiple of that many cells and the tensor is 16-byte
    aligned, else one cell at a time (float32); bfloat16 rows also take 8-
    and 4-byte loads where 16 do not fit. Raises for a shape the kernel
    does not take.
    """
    if n <= 0 or c <= 0:
        raise ValueError("gem_l2n launches for at least one image and "
                         "channel, got %s" % ((n, c, h, w),))
    cluster, threads = FULL_BATCH_LAUNCH if n >= FULL_BATCH \
        else SMALL_BATCH_LAUNCH
    cluster = min(cluster, c)
    group = -(-c // cluster)
    cluster = -(-c // group)
    if group > MAX_GROUP:
        raise ValueError("gem_l2n takes at most %d channels, got %d"
                         % (cluster * MAX_GROUP, c))
    if h * w >= 2 ** 31 or n * cluster >= 2 ** 31:
        raise ValueError("gem_l2n: planes of %d x %d or %d images are too "
                         "large for the kernel" % (h, w, n))
    widths = (16, itemsize) if itemsize == 4 else (16, 8, 4, itemsize)
    load_bytes = next(b for b in widths if b == itemsize or (
        w % (b // itemsize) == 0 and alignment and alignment % b == 0))
    return Geometry(cluster, group, load_bytes, threads)


def _library(dtype=torch.float32):
    library = _build.load("gem_l2n")
    fn = getattr(library.cdll, _ENTRY[dtype])
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                       i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def gem_l2n(x, valid_hw, p, eps=1e-6):
    """Masked GeM pooling then L2 normalisation.

    x: (N, C, H, W) float32 or bfloat16; valid_hw: (N, 2) int32 per-image
    valid extent of the feature map; p: the GeM exponent as a one-element
    float32 or bfloat16 tensor (or a float). Returns (N, C) float32.
    """
    if torch.is_tensor(p) and p.dtype == torch.bfloat16:
        p = p.to(torch.float32)  # a bf16 module's p, exact in float32
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return gem_l2n_plain(x, valid_hw, p, eps=eps)
    if x.device.type != "cuda":
        raise ValueError("gem_l2n takes CPU or CUDA tensors, not %s"
                         % x.device)
    if not torch.is_tensor(p):
        p = torch.full((1,), float(p), dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and (x.requires_grad or p.requires_grad):
        raise ValueError("gem_l2n is eval-only: call it under torch.no_grad()")
    if x.dtype not in _ENTRY or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("gem_l2n needs a contiguous (N, C, H, W) float32 or "
                         "bfloat16 tensor, got %s %s"
                         % (x.dtype, tuple(x.shape)))
    n, c, h, w = x.shape
    if valid_hw.dtype != torch.int32 or tuple(valid_hw.shape) != (n, 2) \
            or not valid_hw.is_contiguous() or valid_hw.device != x.device:
        raise ValueError("valid_hw must be a contiguous (%d, 2) int32 tensor "
                         "on %s" % (n, x.device))
    if p.dtype != torch.float32 or p.numel() != 1 or p.device != x.device:
        raise ValueError("p must be one float32 value on %s" % x.device)
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    address = x.data_ptr()
    geometry = launch_geometry(n, c, h, w, address & -address,
                               x.element_size())
    fn = _library(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(address, valid_hw.data_ptr(), p.data_ptr(),
                 out.data_ptr(), n, c, h, w, geometry.cluster,
                 geometry.group, geometry.threads,
                 geometry.load_bytes // x.element_size(), float(eps), stream)
    if err != 0:
        raise RuntimeError("gem_l2n kernel launch failed with CUDA error %d"
                           % err)
    global launches
    launches += 1
    return out
