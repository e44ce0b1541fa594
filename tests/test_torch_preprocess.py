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
    transform = initialize_transforms(dsl, [[0.5] * 3, [0.5] * 3])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        preprocess.chain_from_transform(transform)


def test_host_call_points_to_the_device_chain():
    transform = initialize_transforms(
        "pil2np | apply_clahe | totensor | normalize", [[0.5] * 3] * 2)
    with pytest.raises(NotImplementedError, match="device chain"):
        transform.transforms[1](np.zeros((4, 4, 3), np.float32))
    params = transform.transforms[1].params
    assert params == {"clip_limit": 4, "colorspace": "lab", "grid_size": 8}
