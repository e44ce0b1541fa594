"""Least device times of the port's kernels on the work an input needs.

The arithmetic of the repository's kernel timing scripts
(``chip_smoke.gem_bound_ms``, ``lab_bound_ms``, ``tile_luts_bound_ms``,
``interp_bound_ms``), copied so that the yardstick does not move with them,
and counted per image at the image's own size: every valid cell or pixel
read once and every output written once, what padding adds is not counted.
Per launch, the tables a launch reads are added once. A bound is the
larger of bytes over the memory rate and operations over the float32 rate
of one H100 SXM (the published peaks).
"""
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
LAB_OPS_PER_PIXEL = 60
INTERP_OPS_PER_PIXEL = 22
LUT_OPS_PER_BIN = 10
BINS = 256


def _seconds(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


def gem_l2n_s(maps, launches):
    """Masked GeM + L2N over ``maps``, each ``(channels, h, w)`` of valid
    cells, in float32: the cells read once, C floats and the extent out,
    the exponent read per launch; 3 operations a cell."""
    nbytes = 4 * launches
    ops = 0
    for c, h, w in maps:
        nbytes += 4 * (h * w * c + c + 2)
        ops += 3 * h * w * c
    return _seconds(nbytes, ops)


def lab_n_s(shapes, launches):
    """The lab lattice over (h, w) images: 3 bytes in and 12 out a pixel,
    the two tables per launch."""
    pixels = sum(h * w for h, w in shapes)
    nbytes = 15 * pixels + launches * (2 * 256 * 4 + 33 ** 3 * 3 * 2)
    return _seconds(nbytes, pixels * LAB_OPS_PER_PIXEL)


def cv2_padded(h, w, grid):
    """OpenCV's padded CLAHE extent: both sides gain ``grid - size %
    grid`` when either is not divisible."""
    if h % grid or w % grid:
        return h + grid - h % grid, w + grid - w % grid
    return h, w


def tile_luts_s(shapes, grid):
    """The tile LUTs of (h, w) images: each pixel (int32) and the reflect
    maps read, (grid^2, 256) float LUTs written; a count per pixel of the
    padded extent and LUT_OPS_PER_BIN a bin."""
    tiles = grid * grid
    nbytes = ops = 0
    for h, w in shapes:
        ph, pw = cv2_padded(h, w, grid)
        nbytes += 4 * (h * w + (ph + grid + pw + grid) + 4 + tiles * BINS)
        ops += ph * pw + tiles * BINS * LUT_OPS_PER_BIN
    return _seconds(nbytes, ops)


def interp_s(shapes, grid):
    """The interpolation of (h, w) images: every pixel read (int32) and
    written (float32), the LUTs and two scalars an image read;
    INTERP_OPS_PER_PIXEL a pixel."""
    pixels = sum(h * w for h, w in shapes)
    nbytes = 4 * (2 * pixels + len(shapes) * (grid * grid * BINS + 2))
    return _seconds(nbytes, pixels * INTERP_OPS_PER_PIXEL)
