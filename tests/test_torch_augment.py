"""The six random and shape augmentations of the port
(``data/transforms.py``: ``random_crop``, ``mirror``, ``center_crop``,
``downscale``, ``scalecrop``, ``gaussian_noise``) against the JAX
package's under the same ``random.seed`` and ``np.random.seed``, and the
port's PIL-free and cv2-free resizes (``ops/resize.py``) against PIL and
cv2 themselves:

* crop, flip, centre crop and noise are bit-equal to JAX's, image by image
  over a pipeline of tuples, and both generators end in the same state;
* ``downscale`` is bit-equal to JAX's PIL path, and ``pil_bilinear_u8`` to
  PIL's ``resize(BILINEAR)`` over a sweep of sizes (down, up, one axis);
* ``scalecrop`` is within 1e-5 of JAX's cv2 path, and ``cv2_linear_f32``
  within 1e-5 of ``cv2.resize`` over the same sweep.
"""
import random

import numpy as np
import pytest

from mdir_tpu.data.transforms import initialize_transforms as jax_transforms

from mdir_tpu_torch.data.transforms import NOT_PORTED, initialize_transforms
from mdir_tpu_torch.ops.resize import cv2_linear_f32, pil_bilinear_u8

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

MEAN_STD = [[0.5, 0.4, 0.3], [0.25, 0.2, 0.3]]
EXACT = "pil2np | mirror | random_crop:30_26 | center_crop:24_20 | " \
        "gaussian_noise:0.05 | totensor | normalize"
RESIZING = "pil2np | downscale:36 | scalecrop:32_30:0.85_1 | mirror | " \
           "totensor | normalize"
SIZES = [(20, 30), (37, 91), (100, 7), (64, 64), (362, 543)]


def _tuples(n=5, shape=(40, 48)):
    rng = np.random.RandomState(3)
    return [[Image.fromarray(rng.randint(0, 256, shape + (3,))
                             .astype(np.uint8)) for _ in range(2)]
            for _ in range(n)]


def _run(make, pipeline, tuples, seed=5):
    random.seed(seed)
    np.random.seed(seed)
    compose = make(pipeline, MEAN_STD)
    out = [compose(*tpl) for tpl in tuples]
    return out, random.getstate(), np.random.get_state()


def test_crops_flip_noise_bit_equal_to_jax():
    tuples = _tuples()
    ref, ref_py, ref_np = _run(jax_transforms, EXACT, tuples)
    got, got_py, got_np = _run(initialize_transforms, EXACT, tuples)
    for want, have in zip(ref, got):
        assert len(want) == len(have) == 2
        for a, b in zip(want, have):
            assert a.shape == b.shape == (20, 24, 3)
            np.testing.assert_array_equal(b, a)
    assert got_py == ref_py
    for a, b in zip(got_np, ref_np):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_downscale_and_scalecrop_against_jax():
    tuples = _tuples()
    ref, ref_py, ref_np = _run(jax_transforms, RESIZING, tuples)
    got, got_py, got_np = _run(initialize_transforms, RESIZING, tuples)
    for want, have in zip(ref, got):
        for a, b in zip(want, have):
            assert a.shape == b.shape == (30, 32, 3)
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert got_py == ref_py
    np.testing.assert_array_equal(got_np[1], ref_np[1])

    # downscale alone is bit-equal (both take PIL's fixed-point resize)
    image = np.asarray(tuples[0][0], np.float32) / 255.0
    for size in (7, 20, 36, 47):
        a, = jax_transforms("downscale:%d" % size, MEAN_STD)(image),
        b, = initialize_transforms("downscale:%d" % size, MEAN_STD)(image),
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("h,w", SIZES)
def test_resizes_against_pil_and_cv2(h, w):
    rng = np.random.RandomState(h * w)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    flt = rng.rand(h, w, 3).astype(np.float32)
    for out_w, out_h in [(10, 10), (w, h // 2 + 1), (w // 3 + 1, h),
                         (17, 29), (2 * w, 2 * h), (w - 1, h - 1),
                         (w // 2, h // 2)]:
        want = np.asarray(Image.fromarray(img).resize((out_w, out_h),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(pil_bilinear_u8(img, (out_w, out_h)),
                                      want)
        gray = np.asarray(Image.fromarray(img[..., 0]).resize(
            (out_w, out_h), Image.BILINEAR))
        np.testing.assert_array_equal(
            pil_bilinear_u8(img[..., 0], (out_w, out_h)), gray)
        np.testing.assert_allclose(cv2_linear_f32(flt, (out_w, out_h)),
                                   cv2.resize(flt, (out_w, out_h)),
                                   rtol=0, atol=1e-5)


def test_edges_transform_still_raises():
    assert set(NOT_PORTED) == {"add_edgesdollar_fromrgb"}
    with pytest.raises(NotImplementedError, match="ximgproc"):
        initialize_transforms("add_edgesdollar_fromrgb:model", MEAN_STD)
