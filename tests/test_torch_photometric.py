"""The port's host transforms (``data/transforms.py``: cv2-free, their
device steps on the CPU here) against the JAX package's, which call cv2:
every label of the JAX registry, the host chains of each DSL, the
colorspace inversion of ``tools/imgtools.py``, and the lowering of lsh and
luv CLAHE for training.

Bars (cv2 against the port's float conversions): u8 / 255 input takes the
exact planes, so lab conversions and every CLAHE plane are bit-equal, as is
an appended CLAHE channel; a way back to RGB (float lab -> rgb, cv2's
clamped luv -> rgb) within 1e-3, the JAX package's float-conversion bars
(``tests/test_colorspace.py``: 3e-3 normalized) on float input, and 1e-2
for histogram matching on float input (the conversion's 3e-3 moves values
across bins of width 1/255, each a step of the mapping). Measured on these
inputs: at most 1.1e-4 on u8 input; 1.7e-3 on float input, 6.2e-3 for
histogram matching."""
import pickle

import numpy as np
import pytest

import jax
import torch

from mdir_tpu.data import transforms as jax_tf
from mdir_tpu.tools import imgtools as jax_imgtools

from mdir_tpu_torch.data import transforms as tf
from mdir_tpu_torch.tools import imgtools

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
# every runnable label with a representative argument string (the JAX
# package's tests/test_transforms.py sweep), and the bar against JAX's on
# u8 / 255 input and on float input (0: equal)
LABELS = {
    "totensor": ("", 0, 0),
    "normalize": ("", 0, 0),
    "pil2np": ("", 0, 0),
    "stackbatch": ("", 0, 0),
    "nan_check": ("", 0, 0),
    "add_const": (":0.5", 0, 0),
    "np_invert_chan": (":0", 0, 0),
    "np_chanselect": (":0:2", 0, 0),
    "np_chanclone": (":0:2", 0, 0),
    "replace_histogram": (":f3d_lab:append", 0, 0),
    "tospace": (":lab", 0, 3e-3),
    "add_intensity_fromrgb": (":lab", 0, 3e-3),
    "add_clahe_fromrgb": (":2:8:luv", 0, None),
    "apply_clahe": (":2:lsh:8", 1e-3, None),
    "create_clahed": (":2:lab:8", 1e-3, None),
    "match_histogram": (":f3d_lab", 1e-3, 1e-2),
    "gamma_equalize": (":0.5:luv", 1e-3, 3e-3),
}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def images():
    """A u8 image and a float one at the size of the JAX package's
    device-vs-host chain tests (``tests/test_preprocess.py``)."""
    rng = np.random.RandomState(0)
    u8 = (rng.rand(64, 96, 3) * 255).astype(np.uint8)
    return u8, rng.rand(64, 96, 3).astype(np.float32)


# the random augmentations and the two shape transforms beside them, held
# against the JAX package's in tests/test_torch_augment.py
AUGMENTATIONS = {"random_crop", "mirror", "center_crop", "downscale",
                 "scalecrop", "gaussian_noise"}


def test_registry_has_the_jax_labels():
    """23 labels run (17 here, the six augmentations in
    tests/test_torch_augment.py); the edge detector raises, with its
    reason."""
    assert set(tf.TRANSFORMS) == set(LABELS) | AUGMENTATIONS
    assert set(tf.TRANSFORMS) | set(tf.NOT_PORTED) == set(jax_tf.TRANSFORMS)
    assert not set(tf.TRANSFORMS) & set(tf.NOT_PORTED)
    for label, reason in tf.NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match=label):
            tf.initialize_transforms("pil2np | %s:1" % label, MEAN_STD)
        assert "ximgproc" in reason
    with pytest.raises(KeyError):
        tf.initialize_transforms("no_such_label", MEAN_STD)


def _inputs(label, img):
    if label == "pil2np":
        return (Image.fromarray((img * 255).astype(np.uint8)),)
    if label in ("stackbatch",):
        return (img, img[::-1].copy())
    if label == "replace_histogram":
        return (np.concatenate([img, img[..., :1]], -1),)
    return (img.copy(),)


@pytest.mark.parametrize("label", sorted(LABELS))
def test_host_transform_matches_jax(images, label):
    args, bar_u8, bar_float = LABELS[label]
    u8, flt = images
    ours = tf.on_device(tf.initialize_transforms(label + args, MEAN_STD),
                        "cpu")
    theirs = jax_tf.initialize_transforms(label + args, MEAN_STD)
    sources = [(u8.astype(np.float32) / 255.0, bar_u8)]
    if bar_float is not None and label != "pil2np":
        sources.append((flt, bar_float))
    for img, bar in sources:
        out = ours(*_inputs(label, img))
        ref = theirs(*_inputs(label, img))
        out = out if isinstance(out, (list, tuple)) else [out]
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            assert a.shape == b.shape and a.dtype == b.dtype, label
            if bar == 0:
                np.testing.assert_array_equal(a, b, err_msg=label)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=bar,
                                           err_msg=label)


@pytest.mark.parametrize("dsl", [
    "pil2np | apply_clahe:4:lab:8 | totensor | normalize",
    "pil2np | apply_clahe:4:lsh:8 | totensor | normalize",
    "pil2np | apply_clahe:4:luv:8 | totensor | normalize",
    "pil2np | tospace:lab | apply_clahe:4:lab:8 | totensor | normalize",
    "pil2np | gamma_equalize:0.5:lab | apply_clahe:2:lsh:4 | totensor "
    "| normalize",
])
def test_host_chain_matches_jax(images, dsl):
    """A whole host chain on a PIL image against the JAX package's (cv2).
    CLAHE of u8 / 255 input: the plane is equal, only the float way back
    differs, within the JAX package's exact-lab device-vs-host bar
    (``tests/test_exact_l.py``: 2e-2 normalized). CLAHE after a float
    colorspace step: its plane moves by single levels where the float
    conversion (within 3e-3 of cv2's) crosses one, on under 5 % of pixels
    (measured 2.8 % after ``tospace:lab``, 0 after
    ``gamma_equalize``), and the output within the JAX package's float device
    chain's bars against its host (``tests/test_preprocess.py``: max 0.5,
    mean 0.05)."""
    u8, _ = images
    ours = tf.on_device(tf.initialize_transforms(dsl, MEAN_STD), "cpu")
    theirs = jax_tf.initialize_transforms(dsl, MEAN_STD)
    out, ref = ours(Image.fromarray(u8)), theirs(Image.fromarray(u8))
    assert out.shape == ref.shape == u8.shape
    diff = np.abs(out - ref)
    if dsl.count("|") == 3:
        assert diff.max() < 2e-2, diff.max()
        return
    assert diff.max() < 0.5 and diff.mean() < 0.05, diff.max()
    space = theirs.transforms[2].params["colorspace"]  # the CLAHE step's
    before = jax_tf.initialize_transforms("pil2np | " + dsl.split(" | ")[1],
                                          MEAN_STD)(Image.fromarray(u8))
    planes = [(fn(before, space, *dev)[..., 0] * 255).astype(np.uint8)
              .astype(int) for fn, dev in ((tf.rgb2normspace_np, ("cpu",)),
                                           (jax_tf.rgb2normspace_np, ()))]
    flips = np.abs(planes[0] - planes[1])
    assert flips.max() <= 1 and (flips != 0).mean() < 0.05, \
        (flips != 0).mean()


def test_host_device_steps_need_a_card_unless_told(images):
    u8, _ = images
    transform = tf.initialize_transforms(
        "pil2np | apply_clahe | totensor | normalize", MEAN_STD)
    assert transform.transforms[1].device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            transform(u8)
    assert tf.on_device(transform, "cpu") is transform
    assert transform.transforms[1].device == "cpu"
    assert tf.on_device(None, "cpu") is None


@pytest.mark.parametrize("transforms", [
    "pil2np | tospace:lab | totensor | normalize",
    "pil2np | tospace:luv | totensor | normalize",
    "pil2np | tospace:lsh | totensor | normalize",
    "pil2np | tospace:lab | chan1 | totensor | normalize",
])
def test_imgtools_inverts_colorspaces_as_jax(transforms):
    """``get_image`` of an output in lab, luv and lsh (values around each
    space's range), and of a single channel, against the JAX package's cv2
    inversion: within one uint8 level."""
    rng = np.random.RandomState(2)
    space = transforms.split("tospace:")[1][:3]
    lo, hi = {"lab": ([0, -100, -100], [100, 100, 100]),
              "luv": ([0, -120, -130], [100, 200, 110]),
              "lsh": ([0, 0, 0], [1, 1, 360])}[space]
    raw = rng.uniform(lo, hi, (24, 20, 3)).astype(np.float32)
    mean_std = ([0.5, 0.1, 0.2], [2.0, 1.5, 0.5])
    out = (raw - np.float32(mean_std[0])) / np.float32(mean_std[1])
    if "chan1" in transforms:
        out = out[..., :1]
    inp = np.zeros_like(out)
    ours = imgtools.get_image([inp, out], mean_std, transforms)
    theirs = jax_imgtools.get_image([inp, out], mean_std, transforms)
    assert ours.shape == theirs.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - theirs).max() <= 1


@pytest.mark.parametrize("space", ["lsh", "luv"])
def test_training_lowers_lsh_and_luv_clahe(space, tmp_path):
    """An lsh or luv CLAHE train chain lowers through RawChainInput, as lab
    does (JAX ``epoch_iteration.py``); a host chain keeps its transform."""
    from mdir_tpu_torch.data.datasets import TuplesDataset
    from mdir_tpu_torch.learning.epoch_iteration import SupervisedEpoch
    from mdir_tpu_torch.ops.preprocess import RawChainInput

    names = ["im%d" % i for i in range(4)]
    db = {"train": {"cluster": [0, 0, 1, 1], "qidxs": [0, 2],
                    "pidxs": [1, 3], "cids": names}}
    with open(tmp_path / "db.pkl", "wb") as handle:
        pickle.dump(db, handle)
    for chain, lowered in (
            ("pil2np | apply_clahe:4:%s:8 | totensor | normalize" % space,
             True),
            ("pil2np | tospace:lab | apply_clahe:4:%s:8 | totensor "
             "| normalize" % space, False)):
        data = {"train": {
            "transforms": chain, "mean_std": MEAN_STD,
            "dataset": {"name": "CirTuples", "dataset": "retrieval-SfM-120k",
                        "split": "train", "dataset_pkl": str(
                            tmp_path / "db.pkl"),
                        "image_dir": str(tmp_path), "query_size": 2,
                        "pool_size": 2, "neg_num": 1, "image_size": 64},
            "loader": {"batch_size": 1}}}
        epoch = SupervisedEpoch.initialize(
            {"data": "train", "criterion": {
                "loss": "contrastive", "margin": 0.7, "eps": 1e-6},
             "batch_average": False, "fakebatch": False},
            (), data, None, {})
        dataset = epoch.data_loader.dataset
        assert isinstance(dataset, TuplesDataset)
        assert isinstance(dataset.item_transform, RawChainInput) == lowered
        chain_of = getattr(dataset, "device_chain", None)
        assert (chain_of is not None) == lowered
        if lowered:
            assert chain_of.clahe_space == space and chain_of.device_l
