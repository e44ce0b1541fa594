"""Masked GeM + L2N: the wrapper of the sm_90a CUDA kernel ``csrc/gem_l2n.cu``.

The kernel replaces the Pallas TPU kernel
``mdir_tpu/ops/pooling_pallas.py::_gem_kernel`` (``gem_l2n_pallas``). It is
memory-bound: it reads each valid feature cell once and writes N*C floats, so
its least time is those bytes over the card's memory rate. One warp per
(image, channel) plane reduces only the valid cells, reading along W; a
second launch, one block per image, divides by the L2 norm (see the source).

For a tensor on the CPU the wrapper computes the plain version
(``pooling.gem_l2n_plain``); for a CUDA tensor it launches the kernel or
raises. It is eval-only, like the TPU kernel, which has no gradient.
"""
import ctypes

import torch

from .. import _build
from .pooling import gem_l2n_plain

launches = 0  # kernel launches since the last reset_launches()


def reset_launches():
    global launches
    launches = 0


def _library():
    library = _build.load("gem_l2n")
    fn = library.cdll.gem_l2n_f32
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def gem_l2n(x, valid_hw, p, eps=1e-6):
    """Masked GeM pooling then L2 normalisation.

    x: (N, C, H, W) float32; valid_hw: (N, 2) int32 per-image valid extent of
    the feature map; p: the GeM exponent as a one-element float32 tensor (or
    a float). Returns (N, C) float32.
    """
    if x.device.type == "cpu":
        return gem_l2n_plain(x, valid_hw, p, eps=eps)
    if x.device.type != "cuda":
        raise ValueError("gem_l2n takes CPU or CUDA tensors, not %s"
                         % x.device)
    if not torch.is_tensor(p):
        p = torch.full((1,), float(p), dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and (x.requires_grad or p.requires_grad):
        raise ValueError("gem_l2n is eval-only: call it under torch.no_grad()")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("gem_l2n needs a contiguous (N, C, H, W) float32 "
                         "tensor, got %s %s" % (x.dtype, tuple(x.shape)))
    n, c, h, w = x.shape
    if valid_hw.dtype != torch.int32 or tuple(valid_hw.shape) != (n, 2) \
            or not valid_hw.is_contiguous() or valid_hw.device != x.device:
        raise ValueError("valid_hw must be a contiguous (%d, 2) int32 tensor "
                         "on %s" % (n, x.device))
    if p.dtype != torch.float32 or p.numel() != 1 or p.device != x.device:
        raise ValueError("p must be one float32 value on %s" % x.device)
    fn = _library()
    pooled = torch.empty((n, c), dtype=torch.float32, device=x.device)
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), valid_hw.data_ptr(), p.data_ptr(),
             pooled.data_ptr(), out.data_ptr(), n, c, h, w, float(eps),
             stream)
    if err != 0:
        raise RuntimeError("gem_l2n kernel launch failed with CUDA error %d"
                           % err)
    global launches
    launches += 1
    return out
