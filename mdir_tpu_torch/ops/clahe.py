"""CLAHE (contrast-limited adaptive histogram equalization), cv2-exact.

The port of ``mdir_tpu/ops/clahe.py``. cv2's semantics, bit for bit:

1. the image is padded to a multiple of the tile grid with
   BORDER_REFLECT_101 when any dim is not divisible (cv2 pads *both* dims by
   ``tiles - size % tiles``, so a divisible dim gains a whole tile);
2. per tile a 256-bin histogram, clipped at ``max(int(clip*area/256), 1)``;
   the excess is spread uniformly plus a strided residual pass;
3. LUT = rint(f32(cdf) * f32(255 / area)), half to even;
4. each pixel blends the LUTs of its 4 neighbouring tiles at grid
   coordinates ``i * inv_tile - 0.5``, x then y, in float32.

``clahe_u8_np`` is the numpy reference of one image. The chain's path is
bucketed: images of different sizes share one padded (B, BH, BW) bucket, and
the host computes each image's cv2 tile geometry (``clahe_bucket_aux``:
reflect-101 source maps, tile sizes, clip limits). Two CUDA kernels of
``csrc/clahe.cu`` run the pixel work:

* ``clahe_tile_luts`` (replaces the Pallas ``tile_luts_pallas``, in the
  bucketed form of ``_hist_dynamic`` + ``_luts_dynamic``): one block per
  (image, tile) counts the histogram in warp-private shared-memory
  sub-histograms, 4 pixels a load where the tile's columns are the image's
  own, and builds the LUT;
* ``clahe_interp`` (replaces ``clahe_interp_bucketed_pallas``): one block
  per strip of rows stages its tile rows' LUTs in shared memory as u8 and
  blends the 4 LUTs of 4 pixels a thread with round-to-nearest float
  operations only (no FMA contraction), so it is bit-equal to cv2 where the
  TPU kernel was within 1 u8.

``tile_luts_geometry`` and ``interp_geometry`` pick each launch's shape from
the bucket's (the CPU tests pin them against ``clahe_bucket_aux``).

``clahe_interp`` is defined for the LUTs that ``clahe_tile_luts`` makes,
whose entries are integers in [0, 255]: its kernel stages them as u8. The
plain version blends whatever floats it is given, so on other LUTs the two
differ; the kernel does not check.

Each wrapper takes a CPU tensor through its plain PyTorch version
(``tile_luts_bucketed_plain``, ``clahe_interp_bucketed_plain``) and launches
its kernel on a CUDA tensor, or raises. ``clahe_u8`` (one image, static
grid) runs the same two kernels at batch 1; it stands in for the Pallas
``clahe_u8_pallas`` and ``clahe_u8_pallas_full``.
"""
import collections
import ctypes

import numpy as np
import torch

from .. import _build

HIST_SIZE = 256

launches = {"clahe_tile_luts": 0, "clahe_interp": 0}  # since reset_launches

# launch choices; of those ``kernel_times.py`` sweeps at the main path's
# (16, 1024, 768) chunk, the fastest on an H100 (PERF.md §6)
INTERP_ROWS = 8  # rows per strip
INTERP_THREADS = 256
INTERP_MAX_ROWS = 64  # csrc/clahe.cu kMaxStripRows
STAGE_BYTES = 48 * 1024  # u8 LUT rows a strip stages, without an opt-in
MAX_SHARED_BYTES = 227 * 1024  # shared memory a block can have on an H100

# max_th/max_tw: the largest tile of the bucket (the staged maps' size);
# vec: int4 loads over a tile's own columns. A block has 256 threads, one
# per bin, and 8 sub-histograms.
LutGeometry = collections.namedtuple(
    "LutGeometry", "max_th max_tw vec smem_bytes")
# vec: pixels a load (4 or 1); strip_rows: rows a block; staged_rows: tile
# rows of LUTs a block can stage (at least the strip's span)
InterpGeometry = collections.namedtuple(
    "InterpGeometry",
    "vec strip_rows staged_rows threads_x threads_y smem_bytes")


def reset_launches():
    for name in launches:
        launches[name] = 0


def _clip_limit_int(clip_limit, tile_area):
    return max(int(clip_limit * tile_area / HIST_SIZE), 1)


# ---------------------------------------------------------------------------
# numpy reference of one image
# ---------------------------------------------------------------------------

def _pad_reflect101(img, grid):
    gh, gw = grid
    h, w = img.shape[:2]
    if h % gh == 0 and w % gw == 0:
        return img
    ph, pw = gh - h % gh, gw - w % gw
    return np.pad(img, ((0, ph), (0, pw)), mode="reflect")


def _redistribute_np(hist, clim):
    clipped = int(np.sum(np.maximum(hist - clim, 0)))
    hist = np.minimum(hist, clim)
    batch, residual = divmod(clipped, HIST_SIZE)
    hist += batch
    if residual:
        step = max(HIST_SIZE // residual, 1)
        hist[np.arange(0, residual * step, step)[:residual]] += 1
    return hist


def clahe_u8_np(src, clip_limit=4.0, grid=(8, 8)):
    """cv2-exact CLAHE of a (H, W) uint8 image, in numpy."""
    if src.dtype != np.uint8 or src.ndim != 2:
        raise ValueError("clahe_u8_np takes one (H, W) uint8 image")
    gh, gw = grid
    h, w = src.shape
    padded = _pad_reflect101(src, grid)
    th, tw = padded.shape[0] // gh, padded.shape[1] // gw
    tile_area = th * tw
    clim = _clip_limit_int(clip_limit, tile_area)
    scale = np.float32(255.0) / np.float32(tile_area)

    tiles = padded.reshape(gh, th, gw, tw).transpose(0, 2, 1, 3)
    luts = np.zeros((gh, gw, HIST_SIZE), np.uint8)
    for ty in range(gh):
        for tx in range(gw):
            hist = np.bincount(tiles[ty, tx].ravel(), minlength=HIST_SIZE)
            hist = _redistribute_np(hist.astype(np.int64), clim)
            cdf = np.cumsum(hist).astype(np.float32)
            luts[ty, tx] = np.clip(np.rint(cdf * scale), 0,
                                   255).astype(np.uint8)

    tyf = (np.arange(h, dtype=np.float32) * np.float32(1.0 / th)
           - np.float32(0.5)).astype(np.float32)
    txf = (np.arange(w, dtype=np.float32) * np.float32(1.0 / tw)
           - np.float32(0.5)).astype(np.float32)
    ty1 = np.floor(tyf).astype(int)
    tx1 = np.floor(txf).astype(int)
    ya = (tyf - ty1).astype(np.float32)[:, None]
    xa = (txf - tx1).astype(np.float32)[None, :]
    ty2 = np.clip(ty1 + 1, 0, gh - 1)
    tx2 = np.clip(tx1 + 1, 0, gw - 1)
    ty1 = np.clip(ty1, 0, gh - 1)
    tx1 = np.clip(tx1, 0, gw - 1)

    v11 = luts[ty1[:, None], tx1[None, :], src].astype(np.float32)
    v12 = luts[ty1[:, None], tx2[None, :], src].astype(np.float32)
    v21 = luts[ty2[:, None], tx1[None, :], src].astype(np.float32)
    v22 = luts[ty2[:, None], tx2[None, :], src].astype(np.float32)
    xa1 = np.float32(1.0) - xa
    ya1 = np.float32(1.0) - ya
    res = ((v11 * xa1 + v12 * xa) * ya1 + (v21 * xa1 + v22 * xa) * ya)
    return np.clip(np.rint(res.astype(np.float32)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Bucketed CLAHE: host tile geometry, device pixel work
# ---------------------------------------------------------------------------

def clahe_bucket_aux(shapes, bucket_hw, clip_limit=4.0, grid=(8, 8)):
    """Per-image cv2 tile geometry of a padded bucket, as numpy arrays.

    shapes: [(h, w)] per image (a filler slot passes the bucket's shape);
    bucket_hw: the padded (BH, BW), divisible by ``grid``. Returns
    ``row_src``/``col_src`` (B, BH+gh)/(B, BW+gw) int32 reflect-101 source
    indices of cv2's padded extent, ``row_tile``/``col_tile`` the tile of
    each padded index (gh/gw past the extent), ``th``/``tw`` (B,) int32 tile
    sizes, and (B,) float32 ``inv_th``, ``inv_tw``, ``clim`` and ``scale``.
    """
    gh, gw = grid
    bh, bw = bucket_hw
    if bh % gh or bw % gw:
        raise ValueError("bucket %s is not divisible by the grid %s"
                         % (bucket_hw, grid))
    n = len(shapes)
    # cv2 may pad a grid-divisible dim by a full tile, so the padded extent
    # can exceed the bucket by up to one tile along each axis
    aux = {
        "row_src": np.zeros((n, bh + gh), np.int32),
        "col_src": np.zeros((n, bw + gw), np.int32),
        "row_tile": np.full((n, bh + gh), gh, np.int32),
        "col_tile": np.full((n, bw + gw), gw, np.int32),
        "th": np.zeros(n, np.int32),
        "tw": np.zeros(n, np.int32),
        "inv_th": np.zeros(n, np.float32),
        "inv_tw": np.zeros(n, np.float32),
        "clim": np.zeros(n, np.float32),
        "scale": np.zeros(n, np.float32),
    }

    def axis_maps(size, tiles, any_pad):
        # cv2 pads BOTH dims by ``tiles - size % tiles`` when either is
        # non-divisible, so a divisible dim gains a full extra tile
        padded = size if not any_pad else size + (tiles - size % tiles)
        tile = padded // tiles
        idx = np.arange(padded)
        src = np.where(idx < size, idx, 2 * size - 2 - idx)
        src = np.clip(src, 0, size - 1)  # degenerate tiny images
        return padded, tile, src, np.minimum(idx // tile, tiles - 1)

    for i, (h, w) in enumerate(shapes):
        if not (0 < h <= bh and 0 < w <= bw):
            raise ValueError("image %s does not fit the bucket %s"
                             % ((h, w), bucket_hw))
        any_pad = bool(h % gh or w % gw)
        ph, th, rsrc, rtile = axis_maps(h, gh, any_pad)
        pw, tw, csrc, ctile = axis_maps(w, gw, any_pad)
        aux["row_src"][i, :ph] = rsrc
        aux["row_tile"][i, :ph] = rtile
        aux["col_src"][i, :pw] = csrc
        aux["col_tile"][i, :pw] = ctile
        aux["th"][i], aux["tw"][i] = th, tw
        aux["inv_th"][i] = np.float32(1.0 / th)
        aux["inv_tw"][i] = np.float32(1.0 / tw)
        area = th * tw
        aux["clim"][i] = np.float32(_clip_limit_int(clip_limit, area))
        aux["scale"][i] = np.float32(255.0) / np.float32(area)
    return aux


def aux_to_device(aux, device):
    """``clahe_bucket_aux``'s arrays as contiguous tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in aux.items()}


def _residual_mask(residual):
    """(T,) residuals -> (T, 256) cv2 residual pass: +1 at indices 0, s,
    2s, ... (s = max(256 // r, 1)), the first ``r`` of them."""
    idx = torch.arange(HIST_SIZE, device=residual.device)[None, :]
    r = residual[:, None]
    step = torch.clamp(HIST_SIZE // torch.clamp(r, min=1), min=1)
    return ((r > 0) & (idx % step == 0) & (idx // step < r)).to(torch.int32)


def tile_luts_bucketed_plain(vals, aux, grid):
    """Tile LUTs of a bucket: (B, BH, BW) int32 u8-values -> (B, gh*gw, 256)
    float32 u8-values. Gathers cv2's padded extent through the reflect maps,
    counts each tile's histogram with one ``bincount`` (a sentinel slot
    takes the cells past the extent), then clips, redistributes and
    accumulates as cv2 does."""
    gh, gw = grid
    b = vals.shape[0]
    tiles = gh * gw
    v = torch.clamp(vals.to(torch.int64), 0, HIST_SIZE - 1)
    rows = aux["row_src"].to(torch.int64)
    cols = aux["col_src"].to(torch.int64)
    batch = torch.arange(b, device=vals.device)[:, None, None]
    padded = v[batch, rows[:, :, None], cols[:, None, :]]  # (B, PH, PW)
    row_tile = aux["row_tile"].to(torch.int64)[:, :, None]
    col_tile = aux["col_tile"].to(torch.int64)[:, None, :]
    tile = torch.where((row_tile < gh) & (col_tile < gw),
                       row_tile * gw + col_tile, tiles)
    key = (batch * (tiles + 1) + tile) * HIST_SIZE + padded
    hist = torch.bincount(key.reshape(-1),
                          minlength=b * (tiles + 1) * HIST_SIZE)
    hist = hist.reshape(b, tiles + 1, HIST_SIZE)[:, :tiles]
    hist = hist.reshape(b * tiles, HIST_SIZE)

    clim = aux["clim"].to(torch.int64).repeat_interleave(tiles)[:, None]
    clipped = torch.clamp(hist - clim, min=0).sum(dim=1)
    hist = torch.minimum(hist, clim) + (clipped // HIST_SIZE)[:, None]
    hist = hist + _residual_mask(clipped % HIST_SIZE)
    cdf = torch.cumsum(hist, dim=1).to(torch.float32)
    scale = aux["scale"].repeat_interleave(tiles)[:, None]
    luts = torch.clamp(torch.round(cdf * scale), 0, 255)
    return luts.reshape(b, tiles, HIST_SIZE)


def _axis_coords(size, inv_t, tiles):
    """(B, size) lower and upper tile index and blend weight along one axis,
    cv2's ``f = i * inv_t - 0.5``, each operation rounded on its own."""
    i = torch.arange(size, dtype=torch.float32, device=inv_t.device)
    f = i[None, :] * inv_t[:, None]
    f = f - 0.5
    lo = torch.floor(f)
    alpha = f - lo
    lo = lo.to(torch.int64)
    hi = torch.clamp(lo + 1, 0, tiles - 1)
    lo = torch.clamp(lo, 0, tiles - 1)
    return lo, hi, alpha


def clahe_interp_bucketed_plain(vals, luts, aux, grid):
    """4-LUT bilinear blend of a bucket: (B, BH, BW) int32 u8-values +
    (B, gh*gw, 256) LUTs -> (B, BH, BW) float32 u8-values, x then y as cv2:
    ``(v11*(1-xa) + v12*xa)*(1-ya) + (v21*(1-xa) + v22*xa)*ya``. Cells past
    an image's extent hold junk (the chain masks them)."""
    gh, gw = grid
    b, bh, bw = vals.shape
    ty1, ty2, ya = _axis_coords(bh, aux["inv_th"], gh)  # (B, BH)
    tx1, tx2, xa = _axis_coords(bw, aux["inv_tw"], gw)  # (B, BW)
    v = torch.clamp(vals.to(torch.int64), 0, HIST_SIZE - 1)
    flat = luts.reshape(b, -1)
    batch = torch.arange(b, device=vals.device)[:, None, None]

    def lut(ty, tx):
        tile = ty[:, :, None] * gw + tx[:, None, :]
        return flat[batch, tile * HIST_SIZE + v]

    xa = xa[:, None, :]
    ya = ya[:, :, None]
    xa1 = 1.0 - xa
    ya1 = 1.0 - ya
    top = lut(ty1, tx1) * xa1 + lut(ty1, tx2) * xa
    bottom = lut(ty2, tx1) * xa1 + lut(ty2, tx2) * xa
    res = top * ya1 + bottom * ya
    return torch.clamp(torch.round(res), 0, 255)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_extent(name, bh, bw, gh, gw):
    if bh <= 0 or bw <= 0 or bh % gh or bw % gw:
        raise ValueError("%s: a (%d, %d) bucket is not divisible by the "
                         "grid %s" % (name, bh, bw, (gh, gw)))
    if bh * bw >= 2 ** 31:
        raise ValueError("%s: images of %d x %d are too large for the "
                         "kernel" % (name, bh, bw))


def tile_luts_geometry(bh, bw, gh, gw, aligned16=True):
    """The ``clahe_tile_luts`` launch for a (B, bh, bw) bucket at grid
    (gh, gw): one block of 256 threads per (tile, image).

    A tile of cv2's padded extent has at most bh // gh + 1 rows (cv2 pads
    by less than one tile), so the staged maps hold that many. Pixels load 4
    at a time when rows are whole int4s (bw % 4 == 0) and the values are
    16-byte aligned. Raises for a bucket the kernel does not take.
    """
    _check_extent("clahe_tile_luts", bh, bw, gh, gw)
    max_th, max_tw = bh // gh + 1, bw // gw + 1
    smem = 4 * (HIST_SIZE // 32 * HIST_SIZE + max_th + max_tw)
    if smem > MAX_SHARED_BYTES:
        raise ValueError("clahe_tile_luts: tiles of a (%d, %d) bucket at grid "
                         "%s need %d bytes of shared memory"
                         % (bh, bw, (gh, gw), smem))
    return LutGeometry(max_th, max_tw, bw % 4 == 0 and aligned16, smem)


def interp_geometry(bh, bw, gh, gw, aligned16=True, strip_rows=INTERP_ROWS):
    """The ``clahe_interp`` launch for a (B, bh, bw) bucket at grid
    (gh, gw): one block per strip of ``strip_rows`` rows of an image.

    R consecutive rows touch at most R + 1 tile rows (a tile has at least
    one row), so a block stages at most min(gh, R + 1) rows of gw u8 LUTs;
    R is halved until that fits in STAGE_BYTES. Each thread keeps one group
    of ``vec`` columns: 4 when rows are whole int4s and the values are
    16-byte aligned, else 1. Raises for a bucket the kernel does not take.
    """
    _check_extent("clahe_interp", bh, bw, gh, gw)
    if not 1 <= strip_rows <= INTERP_MAX_ROWS:
        raise ValueError("clahe_interp: strips of 1 to %d rows, not %d"
                         % (INTERP_MAX_ROWS, strip_rows))
    rows = min(strip_rows, bh)
    lut_row = gw * HIST_SIZE
    while rows > 1 and min(gh, rows + 1) * lut_row > STAGE_BYTES:
        rows //= 2
    staged = min(gh, rows + 1)
    if staged * lut_row > MAX_SHARED_BYTES:
        raise ValueError("clahe_interp: %d tile columns do not fit the "
                         "card's shared memory" % gw)
    vec = 4 if bw % 4 == 0 and aligned16 else 1
    threads_x = min(bw // vec, INTERP_THREADS)
    threads_y = max(1, min(rows, INTERP_THREADS // threads_x))
    return InterpGeometry(vec, rows, staged, threads_x, threads_y,
                          staged * lut_row)


def _library(symbol):
    fn = getattr(_build.load("clahe").cdll, symbol)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if symbol == "clahe_tile_luts_i32":
            fn.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        else:
            fn.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def _check_bucket(name, vals, aux, grid):
    if vals.dtype != torch.int32 or vals.dim() != 3 \
            or not vals.is_contiguous():
        raise ValueError("%s needs a contiguous (B, BH, BW) int32 tensor, "
                         "got %s %s" % (name, vals.dtype, tuple(vals.shape)))
    b, bh, bw = vals.shape
    gh, gw = grid
    shapes = {"row_src": (b, bh + gh), "col_src": (b, bw + gw),
              "th": (b,), "tw": (b,), "inv_th": (b,), "inv_tw": (b,),
              "clim": (b,), "scale": (b,)}
    for key, shape in shapes.items():
        a = aux[key]
        dtype = torch.int32 if key in ("row_src", "col_src", "th", "tw") \
            else torch.float32
        if tuple(a.shape) != shape or a.dtype != dtype \
                or a.device != vals.device or not a.is_contiguous():
            raise ValueError("%s: aux[%r] must be a contiguous %s %s tensor "
                             "on %s" % (name, key, dtype, shape, vals.device))


def clahe_tile_luts(vals, aux, grid):
    """(B, BH, BW) int32 u8-values -> (B, gh*gw, 256) float32 tile LUTs.

    CPU tensor: ``tile_luts_bucketed_plain``. CUDA tensor: the
    ``clahe_tile_luts`` kernel (bit-equal), or an error.
    """
    if vals.device.type == "cpu":
        return tile_luts_bucketed_plain(vals, aux, grid)
    if vals.device.type != "cuda":
        raise ValueError("clahe_tile_luts takes CPU or CUDA tensors, not %s"
                         % vals.device)
    _check_bucket("clahe_tile_luts", vals, aux, grid)
    b, bh, bw = vals.shape
    gh, gw = grid
    luts = torch.empty((b, gh * gw, HIST_SIZE), dtype=torch.float32,
                       device=vals.device)
    if b == 0:
        return luts
    geometry = tile_luts_geometry(bh, bw, gh, gw, vals.data_ptr() % 16 == 0)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("clahe_tile_luts_i32")(
            vals.data_ptr(), aux["row_src"].data_ptr(),
            aux["col_src"].data_ptr(), aux["th"].data_ptr(),
            aux["tw"].data_ptr(), aux["clim"].data_ptr(),
            aux["scale"].data_ptr(), luts.data_ptr(), b, bh, bw, gh, gw,
            geometry.max_th, geometry.max_tw, int(geometry.vec), stream)
    if err != 0:
        raise RuntimeError("clahe_tile_luts kernel launch failed with CUDA "
                           "error %d" % err)
    launches["clahe_tile_luts"] += 1
    return luts


def clahe_interp(vals, luts, aux, grid):
    """(B, BH, BW) int32 u8-values + (B, gh*gw, 256) float32 LUTs ->
    (B, BH, BW) float32 CLAHE'd u8-values.

    CPU tensor: ``clahe_interp_bucketed_plain``. CUDA tensor: the
    ``clahe_interp`` kernel (bit-equal), or an error. The kernel stages the
    LUTs as u8, so their entries must be integers in [0, 255], as
    ``clahe_tile_luts`` makes them.
    """
    if vals.device.type == "cpu":
        return clahe_interp_bucketed_plain(vals, luts, aux, grid)
    if vals.device.type != "cuda":
        raise ValueError("clahe_interp takes CPU or CUDA tensors, not %s"
                         % vals.device)
    _check_bucket("clahe_interp", vals, aux, grid)
    b, bh, bw = vals.shape
    gh, gw = grid
    if luts.dtype != torch.float32 or not luts.is_contiguous() \
            or tuple(luts.shape) != (b, gh * gw, HIST_SIZE) \
            or luts.device != vals.device:
        raise ValueError("clahe_interp needs contiguous (%d, %d, 256) "
                         "float32 LUTs on %s" % (b, gh * gw, vals.device))
    out = torch.empty((b, bh, bw), dtype=torch.float32, device=vals.device)
    if out.numel() == 0:
        return out
    geometry = interp_geometry(bh, bw, gh, gw,
                               (vals.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("clahe_interp_i32")(
            vals.data_ptr(), luts.data_ptr(), aux["inv_th"].data_ptr(),
            aux["inv_tw"].data_ptr(), out.data_ptr(), b, bh, bw, gh, gw,
            geometry.vec, geometry.strip_rows, geometry.staged_rows,
            geometry.threads_x, geometry.threads_y, stream)
    if err != 0:
        raise RuntimeError("clahe_interp kernel launch failed with CUDA "
                           "error %d" % err)
    launches["clahe_interp"] += 1
    return out


def clahe_u8_bucketed(vals, aux, grid=(8, 8)):
    """CLAHE of a padded bucket: (B, BH, BW) int32 u8-values and the
    device ``aux`` of ``clahe_bucket_aux`` -> (B, BH, BW) float32
    u8-values, cv2-exact inside each image's extent."""
    luts = clahe_tile_luts(vals, aux, grid)
    return clahe_interp(vals, luts, aux, grid)


def clahe_u8(src, clip_limit=4.0, grid=(8, 8)):
    """cv2-exact CLAHE of one (H, W) uint8 tensor with a static grid: the
    two bucketed kernels at batch 1 (the plain versions on the CPU)."""
    if src.dtype != torch.uint8 or src.dim() != 2:
        raise ValueError("clahe_u8 takes one (H, W) uint8 image")
    h, w = src.shape
    gh, gw = grid
    bh, bw = -(-h // gh) * gh, -(-w // gw) * gw
    vals = torch.zeros((1, bh, bw), dtype=torch.int32, device=src.device)
    vals[0, :h, :w] = src
    aux = aux_to_device(clahe_bucket_aux([(h, w)], (bh, bw), clip_limit,
                                         grid), src.device)
    out = clahe_u8_bucketed(vals, aux, grid)
    return out[0, :h, :w].to(torch.uint8)
