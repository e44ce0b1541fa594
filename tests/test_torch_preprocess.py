"""The port's device chain (``ops/preprocess.py``) against the JAX package's
``make_bucketed_chain`` on a padded bucket, for the three lab DSL forms, and
``chain_from_transform``'s reject matrix.

The CLAHE plane is bit-equal. The normalized output differs only by the
float lab -> rgb inverse (f32 in both, operations in another order); inside
the valid extents it agrees within atol 1e-5 (measured: at most 2.4e-6 for
apply_clahe, 0 for add_clahe_fromrgb and tospace)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.ops import clahe as jax_clahe
from mdir_tpu.ops import lab_trilinear as jax_lt
from mdir_tpu.ops import preprocess as jax_preprocess

from mdir_tpu_torch.data.transforms import GenericTransform, \
    initialize_transforms
from mdir_tpu_torch.ops import clahe, lab_trilinear, preprocess

cv2 = pytest.importorskip("cv2")  # the JAX chain checks its lab against cv2

SHAPES = [(70, 90), (96, 112), (41, 57)]
BUCKET = (96, 112)
CHAINS = [
    ("pil2np | apply_clahe | totensor | normalize", 3),
    ("pil2np | apply_clahe:3:lab:4 | totensor | normalize", 3),
    ("pil2np | add_clahe_fromrgb:2:16:lab | totensor | normalize", 4),
    ("pil2np | tospace:lab | totensor | normalize", 3),
]


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def bucket():
    rng = np.random.RandomState(0)
    batch = np.zeros((len(SHAPES),) + BUCKET + (3,), np.uint8)
    for i, (h, w) in enumerate(SHAPES):
        batch[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
    return batch


@pytest.mark.parametrize("dsl,channels", CHAINS)
def test_chain_matches_jax(bucket, dsl, channels):
    mean_std = [[0.485, 0.456, 0.406, 0.5][:channels],
                [0.229, 0.224, 0.225, 0.25][:channels]]
    jax_chain = jax_preprocess.chain_from_transform(
        jax_transforms(dsl, mean_std))
    chain = preprocess.chain_from_transform(
        initialize_transforms(dsl, mean_std))
    assert jax_chain.exact_lab and chain.exact_lab
    assert chain.device_l == jax_chain.device_l \
        == (chain.clahe_params is not None)
    assert chain.steps == jax_chain.steps
    assert chain.clahe_params == jax_chain.clahe_params

    aux = jaux = None
    if chain.clahe_params is not None:
        clip, grid = chain.clahe_params
        np_aux = clahe.clahe_bucket_aux(SHAPES, BUCKET, clip, grid)
        aux = clahe.aux_to_device(np_aux, "cpu")
        jaux = {k: jnp.asarray(v) for k, v in np_aux.items()
                if k not in ("th", "tw")}
        # the CLAHE plane itself, bit-equal
        plane = clahe.clahe_u8_bucketed(
            lab_trilinear.lab_l_u8(torch.from_numpy(bucket)), aux, grid)
        ref = jax_clahe.clahe_u8_bucketed_jax(
            jax_lt.lab_l_u8_jax(jnp.asarray(bucket)), jaux, grid)
        np.testing.assert_array_equal(plane.numpy(), np.asarray(ref))

    ref = np.asarray(jax_preprocess.make_bucketed_chain(jax_chain)(
        jnp.asarray(bucket), jaux))
    out = preprocess.make_bucketed_chain(chain)(torch.from_numpy(bucket),
                                                aux)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert out.shape[-1] == channels
    for i, (h, w) in enumerate(SHAPES):
        np.testing.assert_allclose(out[i, :h, :w].numpy(), ref[i, :h, :w],
                                   rtol=0, atol=1e-5)


class _Mirror(GenericTransform):
    """A host transform with no device form."""

    def __call__(self, *pics):
        return list(pics)


def test_chain_from_transform_reject_matrix():
    mean_std = [[0.5] * 3, [0.5] * 3]

    def chain_of(dsl):
        return preprocess.chain_from_transform(
            initialize_transforms(dsl, mean_std))

    assert chain_of("pil2np | apply_clahe | totensor | normalize") \
        is not None
    assert chain_of("pil2np | tospace:lab | totensor | normalize") \
        is not None
    assert chain_of("pil2np | tospace:gray | totensor | normalize") is None
    assert chain_of("pil2np | totensor") is None
    assert chain_of("") is None
    assert chain_of("pil2np | apply_clahe | totensor | normalize:false") \
        is None
    assert preprocess.chain_from_transform(object()) is None
    mirrored = initialize_transforms("pil2np | apply_clahe | totensor | "
                                     "normalize", mean_std)
    mirrored.transforms.insert(1, _Mirror())
    assert preprocess.chain_from_transform(mirrored) is None
    # a colorspace step before CLAHE stays on the host in the JAX package
    for dsl in ("pil2np | tospace:lab | apply_clahe | totensor | normalize",
                "pil2np | tospace:lab | add_clahe_fromrgb | totensor "
                "| normalize"):
        assert chain_of(dsl) is None, dsl


@pytest.mark.parametrize("dsl", [
    "pil2np | apply_clahe:4:luv | totensor | normalize",
    "pil2np | apply_clahe:4:lsh:8 | totensor | normalize",
    "pil2np | add_clahe_fromrgb:4:8:hls | totensor | normalize",
    "pil2np | tospace:luv | totensor | normalize",
])
def test_other_colorspaces_raise(dsl):
    """Of the other colorspaces only hls raises, with the JAX package's
    error: it is not a normspace. luv and lsh lower as the JAX package
    lowers them, with the plane computed on the device."""
    transform = initialize_transforms(dsl, [[0.5] * 3, [0.5] * 3])
    if "hls" in dsl:
        with pytest.raises(NotImplementedError,
                           match="Colorspace hls is not supported"):
            preprocess.chain_from_transform(transform)
        return
    chain = preprocess.chain_from_transform(transform)
    jax_chain = jax_preprocess.chain_from_transform(
        jax_transforms(dsl, [[0.5] * 3, [0.5] * 3]))
    assert chain.steps == jax_chain.steps
    assert chain.clahe_params == jax_chain.clahe_params
    assert chain.device_l == jax_chain.device_l \
        == (chain.clahe_params is not None)


def test_host_call_points_to_the_device_chain(bucket):
    """The host apply_clahe runs on its device (the card unless
    ``on_device`` says otherwise: here it raises without one) and gives
    the device chain's output for an image of its own size."""
    from mdir_tpu_torch.data.transforms import on_device

    transform = initialize_transforms(
        "pil2np | apply_clahe | totensor | normalize", [[0.5] * 3] * 2)
    params = transform.transforms[1].params
    assert params == {"clip_limit": 4, "colorspace": "lab", "grid_size": 8}
    img = bucket[0, :SHAPES[0][0], :SHAPES[0][1]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            transform(img)
    host = on_device(transform, "cpu")(img)
    chain = preprocess.chain_from_transform(transform)
    h, w = img.shape[:2]
    aux = clahe.aux_to_device(clahe.clahe_bucket_aux(
        [(h, w)], BUCKET, *chain.clahe_params), "cpu")
    dev = preprocess.make_bucketed_chain(chain)(
        torch.from_numpy(bucket[:1]), aux)[0, :h, :w]
    np.testing.assert_allclose(host, dev.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dsl,channels,atol", [
    ("pil2np | apply_clahe:4:lsh:8 | totensor | normalize", 3, 0),
    ("pil2np | apply_clahe:3:luv:8 | totensor | normalize", 3, 1e-4),
    ("pil2np | tospace:luv | totensor | normalize", 3, 1e-5),
    ("pil2np | apply_clahe:4:lab:8 | tospace:luv | totensor | normalize", 3,
     1e-5),
    ("pil2np | add_clahe_fromrgb:2:8:luv | tospace:lsh | totensor "
     "| normalize", 3, 1e-5),
])
def test_colorspace_chain_matches_jax(bucket, dsl, channels, atol):
    """lsh and luv CLAHE (``apply_clahe``; ``add_clahe_fromrgb`` before a
    ``tospace``), ``tospace`` in luv and lsh, and float colorspaces after a
    colorspace step, against the JAX package's chain with its
    device planes (its guards pass on this host). The CLAHE planes are
    equal (lsh's integer plane; luv's float plane on this input), so the
    JAX package's device-vs-host bars (``tests/test_exact_l.py``: luv < 0.2,
    lab's 0.999 quantile < 5e-2) hold with room: lsh chains are bit-equal,
    the float conversions differ by a cube root's last bits (measured
    5.9e-5 for luv CLAHE, 2.2e-6 otherwise). One grid for all cases keeps
    the JAX package's compiles shared."""
    mean_std = [[0.485, 0.456, 0.406, 0.5][:channels],
                [0.229, 0.224, 0.225, 0.25][:channels]]
    jax_chain = jax_preprocess.chain_from_transform(
        jax_transforms(dsl, mean_std))
    chain = preprocess.chain_from_transform(
        initialize_transforms(dsl, mean_std))
    assert chain.steps == jax_chain.steps
    assert chain.exact_lab == jax_chain.exact_lab
    assert chain.clahe_params == jax_chain.clahe_params
    assert chain.device_l == jax_chain.device_l \
        == (chain.clahe_params is not None)
    aux = jaux = None
    if chain.clahe_params is not None:
        clip, grid = chain.clahe_params
        np_aux = clahe.clahe_bucket_aux(SHAPES, BUCKET, clip, grid)
        aux = clahe.aux_to_device(np_aux, "cpu")
        jaux = {k: jnp.asarray(v) for k, v in np_aux.items()
                if k not in ("th", "tw")}
    ref = np.asarray(jax_preprocess.make_bucketed_chain(jax_chain)(
        jnp.asarray(bucket), jaux))
    out = preprocess.make_bucketed_chain(chain)(torch.from_numpy(bucket),
                                                aux).numpy()
    assert out.shape == ref.shape and out.shape[-1] == channels
    for i, (h, w) in enumerate(SHAPES):
        if atol == 0:
            np.testing.assert_array_equal(out[i, :h, :w], ref[i, :h, :w])
        else:
            np.testing.assert_allclose(out[i, :h, :w], ref[i, :h, :w],
                                       rtol=0, atol=atol)


@pytest.mark.parametrize("dsl,channels", [
    ("pil2np | apply_clahe | totensor | normalize", 3),
    ("pil2np | add_clahe_fromrgb:2:8:luv | totensor | normalize", 4),
    ("pil2np | tospace:lab | totensor | normalize", 3),
])
def test_device_preprocess_matches_jax(dsl, channels):
    """``make_device_preprocess`` (fixed-size batches, float conversions,
    the CLAHE kernels on same-size buckets) against the JAX package's,
    and ``supports_chain``'s verdicts. Values agree within 1e-4, but for
    the few pixels where a float lab or luv plane sits on a level's edge in
    one package and not the other: they move by a LUT step, well inside
    the JAX package's float-chain bar (``tests/test_preprocess.py``: max
    0.5, at most 2 % over 0.1); measured 0.27 % of values, at most 0.066."""
    mean_std = [[0.485, 0.456, 0.406, 0.5][:channels],
                [0.229, 0.224, 0.225, 0.25][:channels]]
    batch = np.random.RandomState(4).randint(0, 256, (2, 40, 52, 3)) \
        .astype(np.uint8)
    assert preprocess.supports_chain(dsl) == jax_preprocess.supports_chain(
        dsl) is True
    ref = np.asarray(jax_preprocess.make_device_preprocess(dsl, mean_std)(
        jnp.asarray(batch)))
    out = preprocess.make_device_preprocess(dsl, mean_std)(
        torch.from_numpy(batch)).numpy()
    assert out.shape == ref.shape == (2, 40, 52, channels)
    diff = np.abs(out - ref)
    assert diff.max() < 0.5 and (diff > 0.1).mean() < 0.02, diff.max()
    assert (diff > 1e-4).mean() < 5e-3, (diff > 1e-4).mean()
    for other in ("pil2np | mirror | totensor | normalize",
                  "pil2np | totensor", ""):
        assert preprocess.supports_chain(other) \
            == jax_preprocess.supports_chain(other) is False
    with pytest.raises(ValueError):
        preprocess.make_device_preprocess("pil2np | totensor", mean_std)
