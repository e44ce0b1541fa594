"""The copied byte bounds at the shapes the reference gives: the least
times of the repository's kernel records at the main path's (16, 1024,
768) chunk and its feature maps (``gem_l2n`` 0.0301 ms, ``lab_n`` 0.0564,
``interp`` 0.0304), and ``tile_luts``'s 51.5 MB (the 16 images' int32
pixels, reflect maps and (64, 256) float LUTs) at 3.35 TB/s."""
import pytest

from harness import bounds
from reference import nets


def test_gem_bound_of_the_vgg16_map():
    c = nets.out_channels("vgg", nets.VGG16)
    h, w = nets.feature_hw("vgg", nets.VGG16, (1024, 768))
    assert (c, h, w) == (512, 64, 48)
    assert bounds.gem_l2n_s([(c, h, w)] * 16, 1) * 1e3 \
        == pytest.approx(0.0301, abs=5e-5)


def test_gem_bound_of_the_resnet101_map():
    c = nets.out_channels("resnet", nets.RESNET101)
    h, w = nets.feature_hw("resnet", nets.RESNET101, (1024, 768))
    assert (c, h, w) == (2048, 32, 24)
    assert bounds.gem_l2n_s([(c, h, w)] * 16, 1) * 1e3 \
        == pytest.approx(0.0301, abs=5e-5)


def test_chain_bounds_of_the_main_chunk():
    shapes = [(1024, 768)] * 16
    assert bounds.lab_n_s(shapes, 1) * 1e3 == pytest.approx(0.0564,
                                                            abs=5e-5)
    assert bounds.tile_luts_s(shapes, 8) * 1e3 \
        == pytest.approx(0.01537, abs=5e-6)
    assert bounds.interp_s(shapes, 8) * 1e3 == pytest.approx(0.0304,
                                                             abs=5e-5)


def test_cv2_padding():
    assert bounds.cv2_padded(1024, 768, 8) == (1024, 768)
    assert bounds.cv2_padded(683, 1024, 8) == (688, 1032)
