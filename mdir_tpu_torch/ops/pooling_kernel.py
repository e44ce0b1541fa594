"""Masked GeM + L2N: the wrapper of the sm_90a CUDA kernel ``csrc/gem_l2n.cu``.

The kernel replaces the Pallas TPU kernel
``mdir_tpu/ops/pooling_pallas.py::_gem_kernel`` (``gem_l2n_pallas``). It is
memory-bound: it reads each valid feature cell once and writes N*C floats, so
its least time is those bytes over the card's memory rate. It is one launch
of ``blocks`` blocks an image, each pooling a contiguous group of channels;
the last block of an image to finish divides its row by the L2 norm (see the
source), counting on a per-image counter that the wrapper keeps zeroed for
each device and stream. A whole-extent image streams its block's span
through a ring of shared-memory stages with bulk copies (the bulk route); a
ragged one is walked plane by plane (the walk route). ``launch_geometry``
picks the blocks, the channel group, the walk's load width and the ring from
the shape and the tensor's address. The kernel takes
float32, bfloat16 or float16 features (a 16-bit extraction program's trunk
output, read at half the bytes) and pools in float32 either way; the plain
version of a 16-bit map is ``gem_l2n_plain(x.float(), ...)``.

For a tensor on the CPU the wrapper computes the plain version
(``pooling.gem_l2n_plain``); for a CUDA tensor it launches the kernel or
raises. Either refuses a type the kernel does not take. It is eval-only,
like the TPU kernel, which has no gradient.
"""
import collections
import ctypes

import torch

from .. import _build
from .pooling import gem_l2n_plain

launches = 0  # kernel launches since the last reset_launches()

# blocks a launch aims at (ceil(TARGET_BLOCKS / n) an image) and threads a
# block: of the launches ``kernel_times.py`` tries at the main paths' maps,
# the fastest or within 5 % of it on an H100 (PERF.md §6)
TARGET_BLOCKS = 512
THREADS = 128
MAX_GROUP = 12288  # raw sums a block keeps in 48 KB of shared memory
# the bulk route's ring (of two stages, kStages in the source): a stage
# holds the largest power-of-two number of planes that fits STAGE_BYTES (at
# least one plane); planes above MAX_PLANE_BYTES are walked
STAGE_BYTES = 16384
MAX_PLANE_BYTES = 49152
_ENTRY = {torch.float32: "gem_l2n_f32", torch.bfloat16: "gem_l2n_bf16",
          torch.float16: "gem_l2n_f16"}
_WIDENED = (torch.bfloat16, torch.float16)  # pooled as exact float32


# blocks: per image; group: channels per block; load_bytes: bytes a walk
# load reads (16, or one float32; 16, 8, 4 or one 16-bit cell); threads: per
# block; stage_planes: planes per stage of the bulk route's ring (0: every
# image walks)
Geometry = collections.namedtuple(
    "Geometry", "blocks group load_bytes threads stage_planes")
_counters = {}  # (device index, stream) -> int32 counters, kept zero


def reset_launches():
    global launches
    launches = 0


def launch_geometry(n, c, h, w, alignment=16, itemsize=4):
    """The kernel's launch for an (n, c, h, w) input of ``itemsize``-byte
    cells (4: float32, 2: bfloat16 or float16) whose address is a multiple
    of ``alignment`` bytes.

    ``blocks`` blocks per image, about TARGET_BLOCKS in all; block r pools
    channels [r * group, min((r + 1) * group, c)), so every channel is
    pooled once and no block is empty. Walked rows load 16 bytes at a time
    when their width is a multiple of that many cells and the tensor is
    16-byte aligned, else one cell at a time (float32); 16-bit rows also
    take 8- and 4-byte loads where 16 do not fit. The bulk route needs a
    16-byte aligned tensor and planes of a multiple of 16 bytes. Raises for
    a shape the kernel does not take.
    """
    if n <= 0 or c <= 0:
        raise ValueError("gem_l2n launches for at least one image and "
                         "channel, got %s" % ((n, c, h, w),))
    blocks = min(c, -(-TARGET_BLOCKS // n))
    group = -(-c // blocks)
    if group > MAX_GROUP:
        raise ValueError("gem_l2n takes at most %d channels, got %d"
                         % (blocks * MAX_GROUP, c))
    blocks = -(-c // group)
    if h * w >= 2 ** 31 or n * blocks >= 2 ** 31:
        raise ValueError("gem_l2n: planes of %d x %d or %d images are too "
                         "large for the kernel" % (h, w, n))
    widths = (16, itemsize) if itemsize == 4 else (16, 8, 4, itemsize)
    load_bytes = next(b for b in widths if b == itemsize or (
        w % (b // itemsize) == 0 and alignment and alignment % b == 0))
    plane_bytes = h * w * itemsize
    stage_planes = 0
    if alignment and alignment % 16 == 0 and plane_bytes % 16 == 0 \
            and 0 < plane_bytes <= MAX_PLANE_BYTES:
        stage_planes = 1
        while 2 * stage_planes <= group \
                and 2 * stage_planes * plane_bytes <= STAGE_BYTES:
            stage_planes *= 2
    return Geometry(blocks, group, load_bytes, THREADS, stage_planes)


def _library(dtype=torch.float32):
    library = _build.load("gem_l2n")
    fn = getattr(library.cdll, _ENTRY[dtype])
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i32] * 9 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def _counter(device, stream, n):
    """At least n zero int32 counters for launches on ``stream``: each
    launch leaves them zero, so they are zeroed once, when made."""
    key = (device.index, stream)
    counter = _counters.get(key)
    if counter is None or counter.numel() < n:
        counter = _counters[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                               device=device)
    return counter


def _launch(x, valid_hw, p, out, geometry, eps):
    """One launch of the kernel at ``geometry`` into ``out``; returns the
    launch's CUDA error (0: accepted). The wrapper's own launch, and the
    one ``kernel_times.py`` sweeps with other geometries."""
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = torch.empty(n * geometry.blocks, dtype=torch.float32,
                              device=x.device)
        counter = _counter(x.device, stream, n)
        return _library(x.dtype)(
            x.data_ptr(), valid_hw.data_ptr(), p.data_ptr(), out.data_ptr(),
            partial.data_ptr(), counter.data_ptr(), n, c, h, w,
            geometry.blocks, geometry.group, geometry.threads,
            geometry.load_bytes // x.element_size(), geometry.stage_planes,
            float(eps), stream)


def gem_l2n(x, valid_hw, p, eps=1e-6):
    """Masked GeM pooling then L2 normalisation.

    x: (N, C, H, W) float32, bfloat16 or float16; valid_hw: (N, 2) int32
    per-image valid extent of the feature map; p: the GeM exponent as a
    one-element tensor of one of those types (or a float). Returns (N, C)
    float32.
    """
    if x.dtype not in _ENTRY:
        raise ValueError("gem_l2n takes float32, bfloat16 or float16 maps, "
                         "not %s" % x.dtype)
    if torch.is_tensor(p) and p.dtype in _WIDENED:
        p = p.to(torch.float32)  # a 16-bit module's p, exact in float32
    if x.device.type == "cpu":
        if x.dtype in _WIDENED:
            x = x.to(torch.float32)
        return gem_l2n_plain(x, valid_hw, p, eps=eps)
    if x.device.type != "cuda":
        raise ValueError("gem_l2n takes CPU or CUDA tensors, not %s"
                         % x.device)
    if not torch.is_tensor(p):
        p = torch.full((1,), float(p), dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and (x.requires_grad or p.requires_grad):
        raise ValueError("gem_l2n is eval-only: call it under torch.no_grad()")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("gem_l2n needs a contiguous (N, C, H, W) tensor, "
                         "got %s %s" % (x.dtype, tuple(x.shape)))
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
    err = _launch(x, valid_hw, p, out, geometry, eps)
    if err != 0:
        raise RuntimeError("gem_l2n kernel launch failed with CUDA error %d"
                           % err)
    global launches
    launches += 1
    return out
