"""cv2-exact RGB -> Lab lattice values from uint8 RGB, on the card.

The port of ``mdir_tpu/ops/lab_trilinear.py``. OpenCV's float RGB2LAB (cv2
5.x) runs a fixed-point trilinear pipeline, verified over all 256^3 RGB
triples:

    cx    = rint(f32(v / 255) * 16384)            per channel, LAB_BASE = 2^14
    tx    = cx >> 9,  w = (cx & 511) >> 5          corner + 4-bit weight
    blend = sum over the 8 corners of NODE[tx+dx, ty+dy, tz+dz]
            * wx * wy * wz                         (33^3 x 3 node table)
    n     = (blend + 2048) >> 12

L = n / 2^14 * 100 and a/b = n / 64 - 128, so every output is an exact
integer. The per-u8 (tx, w) come from a 256-entry host table, so no floating
point is left on the card.

``lab_n`` is the wrapper of the CUDA kernel ``csrc/lab_n.cu``, which replaces
the Pallas TPU kernel ``lab_n_pallas`` (``_lab_v3_kernel``); the TPU's one-hot
MXU contraction is a way around slow gathers, and the card gathers well, so
the kernel reads the corners directly, two at a time from the corner-pair
table of ``_kernel_tables``. On a CPU tensor the wrapper computes
``lab_n_plain``; on a CUDA tensor it launches the kernel or raises.
``lab_chan``, ``lab_l_u8`` and ``lab_normspace`` derive the chain's planes
from its output. ``lsh_l_u8`` is the lsh chain's CLAHE plane, plain integer
PyTorch (no kernel: the JAX package computes it with XLA too).

The node table ``_lab_nodes.npy`` (int16 (33, 33, 33, 3)) is this package's
own copy of the JAX package's file, byte for byte.
"""
import ctypes
import functools
import os

import numpy as np
import torch

from .. import _build

_NODE_PATH = os.path.join(os.path.dirname(__file__), "_lab_nodes.npy")
LAB_BASE = 16384  # 2^14, cv2's fixed-point scale

launches = 0  # kernel launches since the last reset_launches()


def reset_launches():
    global launches
    launches = 0


@functools.lru_cache(maxsize=1)
def _node_lut3():
    """(33, 33, 33, 3) int16 lattice node table."""
    return np.load(_NODE_PATH)


@functools.lru_cache(maxsize=1)
def _u8_corner_tables():
    """Per-u8-value (tx, w) emulating cv2's f32 fixed-point quantization.

    v/255 rounds to f32 (correctly rounded division), *16384 is exact (a
    power of two), cvRound is round-half-to-even.
    """
    v32 = np.arange(256, dtype=np.float32) / np.float32(255.0)
    cx = np.rint(v32.astype(np.float64) * LAB_BASE).astype(np.int64)
    return (cx >> 9).astype(np.int32), ((cx & 511) >> 5).astype(np.int32)


def pair_index(ix, iy, iz):
    """Entry of lattice node (ix, iy, iz) in the corner-pair table: the
    entries lie in 2 x 2 x 2 bricks of 8 consecutive entries (one 128-byte
    line), 17 bricks an axis."""
    brick = ((ix >> 1) * 17 + (iy >> 1)) * 17 + (iz >> 1)
    return brick * 8 + ((ix & 1) << 2) + ((iy & 1) << 1) + (iz & 1)


@functools.lru_cache(maxsize=1)
def _packed_tables():
    """The kernel's host tables: (256,) int32 ``tx | w << 8`` per u8 value,
    and the (17^3 * 8, 8) int16 corner-pair table. Entry ``pair_index(ix,
    iy, iz)`` holds, per channel L, a, b, the pair (node[ix, iy, iz],
    node[ix, iy, min(iz + 1, 32)]), then two zeros: 16 bytes, one aligned
    load for two corners. The entries of the bricks' unused half at 33 are
    zero."""
    tx, w = _u8_corner_tables()
    node = _node_lut3()
    i = np.arange(33)
    ix, iy, iz = np.meshgrid(i, i, i, indexing="ij")
    pairs = np.zeros((17 ** 3 * 8, 8), np.int16)
    at = pair_index(ix, iy, iz)
    pairs[at, 0:6:2] = node
    pairs[at, 1:6:2] = node[ix, iy, np.minimum(iz + 1, 32)]
    return (tx | (w << 8)).astype(np.int32), pairs


_DEVICE_TABLES = {}
_KERNEL_TABLES = {}


def _tables(device):
    """(tx int32 (256,), w int32 (256,), node int16 (33, 33, 33, 3)) on
    ``device``, uploaded once per device."""
    key = str(device)
    if key not in _DEVICE_TABLES:
        tx, w = _u8_corner_tables()
        _DEVICE_TABLES[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (tx, w, _node_lut3()))
    return _DEVICE_TABLES[key]


def _kernel_tables(device):
    """``_packed_tables`` on ``device``, uploaded once per device."""
    key = str(device)
    if key not in _KERNEL_TABLES:
        _KERNEL_TABLES[key] = tuple(torch.from_numpy(a).to(device)
                                    for a in _packed_tables())
    return _KERNEL_TABLES[key]


def _check_batch(batch_u8):
    if batch_u8.dtype != torch.uint8 or batch_u8.dim() != 4 \
            or batch_u8.shape[-1] != 3:
        raise ValueError("expected (B, H, W, 3) uint8 RGB, got %s %s"
                         % (batch_u8.dtype, tuple(batch_u8.shape)))


def lab_n_plain(batch_u8):
    """(B, H, W, 3) uint8 RGB -> (B, H, W, 3) int32 lattice n (L, a, b).

    The 8-corner gather of ``mdir_tpu``'s ``_lab_n_np``, in int32 (the
    blend stays below 2^27).
    """
    _check_batch(batch_u8)
    tx, w, node = _tables(batch_u8.device)
    node = node.to(torch.int32).reshape(-1, 3)
    v = batch_u8.to(torch.int64)
    t = [tx[v[..., c]] for c in range(3)]
    f = [w[v[..., c]] for c in range(3)]
    acc = torch.zeros(batch_u8.shape, dtype=torch.int32,
                      device=batch_u8.device)
    for dx in (0, 1):
        wx = f[0] if dx else 16 - f[0]
        ix = torch.clamp(t[0] + dx, max=32)
        for dy in (0, 1):
            wy = f[1] if dy else 16 - f[1]
            iy = torch.clamp(t[1] + dy, max=32)
            for dz in (0, 1):
                wz = f[2] if dz else 16 - f[2]
                iz = torch.clamp(t[2] + dz, max=32)
                corner = node[((ix * 33 + iy) * 33 + iz).to(torch.int64)]
                acc += corner * (wx * wy * wz)[..., None]
    return (acc + 2048) >> 12


def _library():
    fn = _build.load("lab_n").cdll.lab_n_u8
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr]
        fn.restype = ctypes.c_int
    return fn


def lab_n(batch_u8):
    """(B, H, W, 3) uint8 RGB -> (B, H, W, 3) int32 lattice n (L, a, b).

    CPU tensor: ``lab_n_plain``. CUDA tensor: the kernel of
    ``csrc/lab_n.cu`` (bit-equal to the plain version), or an error. The
    kernel moves 4 pixels a thread with 4- and 16-byte accesses where the
    input is 4-byte aligned (the output and the tables always are), and
    byte by byte where it is not.
    """
    if batch_u8.device.type == "cpu":
        return lab_n_plain(batch_u8)
    if batch_u8.device.type != "cuda":
        raise ValueError("lab_n takes CPU or CUDA tensors, not %s"
                         % batch_u8.device)
    _check_batch(batch_u8)
    if not batch_u8.is_contiguous():
        raise ValueError("lab_n needs a contiguous (B, H, W, 3) tensor")
    tw, pairs = _kernel_tables(batch_u8.device)
    out = torch.empty(batch_u8.shape, dtype=torch.int32,
                      device=batch_u8.device)
    pixels = batch_u8.numel() // 3
    if pixels == 0:
        return out
    if (out.data_ptr() | pairs.data_ptr()) % 16:
        raise RuntimeError("lab_n needs 16-byte aligned output and tables")
    with torch.cuda.device(batch_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(batch_u8.data_ptr(), tw.data_ptr(),
                         pairs.data_ptr(), out.data_ptr(), pixels, stream)
    if err != 0:
        raise RuntimeError("lab_n kernel launch failed with CUDA error %d"
                           % err)
    global launches
    launches += 1
    return out


def lab_chan(batch_u8):
    """uint8 RGB -> (l_u8 int32 (B, H, W), ab float32 (B, H, W, 2)).

    ``l_u8`` is the u8 CLAHE input plane, cv2's ``(L * 255 / 100)`` cut to
    uint8; ``ab`` are the normalized ``(a + 128) / 255``, bit-equal to the
    host chain's (cv2's f32 a + 128 is n / 64 exactly).
    """
    n = lab_n(batch_u8)
    l_u8 = (n[..., 0] * 255) >> 14
    ab = (n[..., 1:].to(torch.float32) * (1.0 / 64.0)) / 255.0
    return l_u8, ab


def lab_l_u8(batch_u8):
    """uint8 RGB -> (B, H, W) int32 l_u8, through the ``lab_n`` kernel."""
    return (lab_n(batch_u8)[..., 0] * 255) >> 14


def lab_normspace(batch_u8):
    """uint8 RGB -> the host's normalized lab: L / 100 (n / 2^14, exact)
    and (a + 128) / 255, (b + 128) / 255."""
    n = lab_n(batch_u8).to(torch.float32)
    ch0 = n[..., :1] * (1.0 / LAB_BASE)
    ab = (n[..., 1:] * (1.0 / 64.0)) / 255.0
    return torch.cat([ch0, ab], dim=-1)


def lsh_l_u8_np(rgb_u8):
    """The plain version of ``lsh_l_u8``: numpy (..., 3) uint8 -> int32."""
    v = np.asarray(rgb_u8, np.int32)[..., :3]
    return (v.max(-1) + v.min(-1)) >> 1


def lsh_l_u8(batch_u8):
    """uint8 RGB -> int32 HLS lightness plane, ``(max + min) >> 1``: cv2's
    float L of u8 / 255 cut to uint8, exactly, for every pair of levels."""
    v = batch_u8[..., :3].to(torch.int32)
    return (torch.amax(v, dim=-1) + torch.amin(v, dim=-1)) >> 1
