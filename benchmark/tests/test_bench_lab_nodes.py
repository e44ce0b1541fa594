"""The reference's frozen Lab lattice (``reference/lab_nodes.npy``) against
the lattice rebuilt here from OpenCV's published formulas, as
``initLabTabs`` in OpenCV's ``color_lab.cpp`` defines each node: R, G, B
at ``i / 32``, the sRGB gamma, XYZ by the sRGB/D65 matrix over the white
point, the CIE cube root with its linear segment below ``216 / 24389``, and
``L * 2^14 / 100``, ``(a + 128) * 2^14 / 256``, ``(b + 128) * 2^14 / 256``
rounded. OpenCV computes in float32 (softfloat), this rebuild in float64,
so a node may differ by one unit where its value lies within rounding of a
half."""
import numpy as np

from reference import chain

SIDE = 33
BASE = 1 << 14


def rebuilt_lattice():
    """(33, 33, 33, 3) int64: [R][G][B] -> the lattice values of L, a, b."""
    v = np.arange(SIDE) / (SIDE - 1.0)
    lin = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
    rgb = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    xyz = rgb @ chain.RGB2XYZ.astype(np.float64).T / np.array(chain.WHITE)
    thresh = 216.0 / 24389.0
    f = np.where(xyz > thresh, np.cbrt(xyz), xyz * (841.0 / 108.0)
                 + 16.0 / 116.0)
    y = xyz[..., 1]
    lum = np.where(y > thresh, 116.0 * f[..., 1] - 16.0, y * 24389.0 / 27.0)
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.rint(np.stack([BASE * lum / 100.0, BASE * (a + 128.0) / 256.0,
                             BASE * (b + 128.0) / 256.0], axis=-1)).astype(
                                 np.int64)


def test_frozen_lattice_is_opencvs_formulas():
    frozen = np.load(chain.LAB_NODES).astype(np.int64)
    assert frozen.shape == (SIDE, SIDE, SIDE, 3)
    diff = np.abs(frozen - rebuilt_lattice())
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3  # a unit only at rounding's edge


def test_lattice_corners():
    frozen = np.load(chain.LAB_NODES).astype(np.int64)
    assert frozen[0, 0, 0].tolist() == [0, BASE // 2, BASE // 2]  # black
    assert frozen[-1, -1, -1].tolist() == [BASE, BASE // 2, BASE // 2]
