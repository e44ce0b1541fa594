"""Port batched extraction (multi-scale + whitening, f32 and uint8 ingress)
against the JAX package's ``extract_vectors_batched``, and against the
port's own per-image wrapper path."""
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.learning.wrappers import CirtorchWhiten as JaxWhiten
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.ops.resize import torch_resize_grid as jax_resize_grid
from mdir_tpu.parallel.extract import batched_resize as jax_batched_resize
from mdir_tpu.parallel.extract import extract_vectors_batched as jax_extract

from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.learning.wrappers import CirtorchWhiten
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.models import trunks
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.ops import pooling_kernel
from mdir_tpu_torch.ops.resize import gather_resize, torch_resize_grid
from mdir_tpu_torch.parallel import extract

LAYERS = (1, 1, 1, 1)
SCALES = [1, 1 / np.sqrt(2), 0.5]
MODEL = {"architecture": "cirnet", "cir_architecture": "resnet101",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
MEAN_STD = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def models():
    """The same (1, 1, 1, 1) ResNet-GeM in both packages, JAX weights. The
    JAX module reads its layer table when it runs, so the table stays
    patched for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                   (jax_trunks.Bottleneck, LAYERS))
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, LAYERS))
        jax_model = jax_initialize_model(MODEL)
        port_model = initialize_model(MODEL, device="cpu")
        port_model.load_state_dict(from_jax_variables(
            jax.tree.map(np.asarray, jax_model.variables)), strict=True)
        yield jax_model, port_model


@pytest.fixture(scope="module")
def whiten_pkl(tmp_path_factory):
    rng = np.random.RandomState(0)
    path = tmp_path_factory.mktemp("whiten") / "whiten.pkl"
    with open(path, "wb") as handle:
        pickle.dump({"P": np.eye(2048) + 0.01 * rng.randn(2048, 2048),
                     "m": 0.01 * rng.randn(2048, 1)}, handle)
    return str(path)


def test_gather_resize_matches_jax(rng):
    img = rng.rand(2, 37, 53, 3).astype(np.float32)
    for scale in SCALES[1:]:
        oh, ow = int(37 * scale), int(53 * scale)
        grids = [np.stack([a] * 2) for a in jax_resize_grid(37, oh, scale)
                 + jax_resize_grid(53, ow, scale)]
        ref = jax_batched_resize(jnp.asarray(img), *grids)
        port_grids = torch_resize_grid(37, oh, scale) \
            + torch_resize_grid(53, ow, scale)
        ours = gather_resize(
            torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
            *(torch.from_numpy(np.stack([a] * 2)) for a in port_grids))
        np.testing.assert_allclose(np.asarray(ref),
                                   ours.numpy().transpose(0, 2, 3, 1),
                                   rtol=1e-5, atol=1e-6)


def test_multiscale_whiten_matches_jax(rng, models, whiten_pkl):
    jax_model, port_model = models
    arrays = [rng.rand(80, 100, 3).astype(np.float32),
              rng.rand(100, 70, 3).astype(np.float32),
              rng.rand(80, 100, 3).astype(np.float32)]
    msp = float(jax_model.pool_p)
    ref = jax_extract(jax_model, arrays, scales=SCALES, msp=msp,
                      whiten=JaxWhiten(whiten_pkl), bucket_multiple=32,
                      max_batch=2)
    before = pooling_kernel.launches
    ours = extract.extract_vectors_batched(
        port_model, arrays, scales=SCALES, msp=msp,
        whiten=CirtorchWhiten(whiten_pkl), bucket_multiple=32, max_batch=2)
    assert pooling_kernel.launches == before  # CPU: plain version
    assert ours.shape == (2048, 3)
    np.testing.assert_allclose(ref, ours, rtol=1e-4, atol=1e-5)


def test_uint8_device_normalize_matches_jax(rng, models):
    jax_model, port_model = models
    arrays = [(rng.rand(70, 90, 3) * 255).astype(np.uint8),
              (rng.rand(64, 60, 3) * 255).astype(np.uint8)]
    msp = float(jax_model.pool_p)
    ref = jax_extract(jax_model, arrays, scales=SCALES, msp=msp,
                      normalize_mean_std=MEAN_STD)
    ours = extract.extract_vectors_batched(
        port_model, arrays, scales=SCALES, msp=msp,
        normalize_mean_std=MEAN_STD)
    np.testing.assert_allclose(ref, ours, rtol=1e-4, atol=1e-5)


def test_batched_equals_port_wrapper_path(rng, models, whiten_pkl):
    """The batched extractor computes what the per-image wrappers compute."""
    port_model = models[1]
    network = CirNetwork(port_model, CirNetwork.NetworkParams(
        model={}, runtime={"wrappers": {
            "train": None,
            "eval": {"0_cirwhiten": {"whitening": whiten_pkl},
                     "1_cirmultiscale": {"scales": True}}}}), frozen=True)
    arrays = [rng.rand(75, 90, 3).astype(np.float32),
              rng.rand(140, 66, 3).astype(np.float32)]
    ref = np.stack([network(a).numpy().reshape(-1) for a in arrays], axis=1)
    extractor = extract.network_extractor(network, transform=None,
                                          batch_size=4)
    assert extractor.scales == SCALES and extractor.P is not None
    for i, arr in enumerate(arrays):
        extractor.add(i, arr)
    ours = extractor.finish(len(arrays))
    assert extractor.chunks == 2  # two shape buckets
    np.testing.assert_allclose(ref, ours, rtol=1e-4, atol=1e-5)


ALEXNET = dict(MODEL, cir_architecture="alexnet")
CLAHE_DSL = "pil2np | apply_clahe | totensor | normalize"


@pytest.fixture(scope="module")
def alexnet_models():
    jax_model = jax_initialize_model(ALEXNET)
    port_model = initialize_model(ALEXNET, device="cpu")
    port_model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jax_model.variables)), strict=True)
    return jax_model, port_model


def test_clahe_chain_multiscale_whiten_matches_jax(alexnet_models,
                                                   tmp_path):
    """AlexNet-GeM + lab CLAHE device chain + three scales + Lw: the port's
    extractor against the JAX package's StreamingExtractor with its
    device_chain, on ragged uint8 images in two buckets, one of them with
    a filler slot."""
    from mdir_tpu.data.transforms import initialize_transforms as jax_tf
    from mdir_tpu.ops.preprocess import chain_from_transform as jax_chain_of
    from mdir_tpu.parallel.extract import StreamingExtractor as JaxExtractor

    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.ops import clahe, lab_trilinear
    from mdir_tpu_torch.ops.preprocess import chain_from_transform

    jax_model, port_model = alexnet_models
    rng = np.random.RandomState(8)
    path = tmp_path / "whiten256.pkl"
    with open(path, "wb") as handle:
        pickle.dump({"P": np.eye(256) + 0.01 * rng.randn(256, 256),
                     "m": 0.01 * rng.randn(256, 1)}, handle)
    # three images in the (96, 128) bucket: a full chunk of 2, then one
    # image beside a filler slot; one image in the (128, 96) bucket
    arrays = [(rng.rand(*shape, 3) * 255).astype(np.uint8)
              for shape in ((80, 100), (100, 70), (70, 110), (75, 120))]
    msp = float(jax_model.pool_p)
    ref_ex = JaxExtractor(jax_model, scales=SCALES, msp=msp,
                          whiten=JaxWhiten(str(path)), bucket_multiple=32,
                          max_batch=2,
                          device_chain=jax_chain_of(jax_tf(CLAHE_DSL,
                                                           MEAN_STD)))
    ex = extract.StreamingExtractor(
        port_model, scales=SCALES, msp=msp, whiten=CirtorchWhiten(str(path)),
        bucket_multiple=32, max_batch=2,
        device_chain=chain_from_transform(initialize_transforms(CLAHE_DSL,
                                                                MEAN_STD)))
    assert ex.host_dtype == np.uint8
    before = (lab_trilinear.launches, dict(clahe.launches))
    for i, arr in enumerate(arrays):
        ref_ex.add(i, arr)
        ex.add(i, arr)
    ref = ref_ex.finish(len(arrays))
    ours = ex.finish(len(arrays))
    assert (lab_trilinear.launches, clahe.launches) == before  # CPU: plain
    assert ex.chunks == 3 and ours.shape == (256, 4)
    np.testing.assert_allclose(ref, ours, rtol=1e-4, atol=1e-4)


def test_network_extractor_lowers_clahe_or_raises(alexnet_models):
    from mdir_tpu_torch.data.transforms import initialize_transforms

    network = CirNetwork(alexnet_models[1], CirNetwork.NetworkParams(
        model={}, runtime={"wrappers": {
            "train": None, "eval": {"0_cirmultiscale": {"scales": True}}}}),
        frozen=True)
    extractor = extract.network_extractor(
        network, initialize_transforms(CLAHE_DSL, MEAN_STD))
    assert extractor.device_chain.clahe_params == (4.0, (8, 8))
    assert extractor.host_dtype == np.uint8
    # a colorspace step before CLAHE has no device chain: the host route,
    # its device transforms on the model's device (JAX extract.py:945-977)
    host_tf = initialize_transforms(
        "pil2np | tospace:lab | apply_clahe | totensor | normalize",
        MEAN_STD)
    extractor = extract.network_extractor(network, host_tf)
    assert extractor.device_chain is None
    assert extractor.host_dtype == np.float32
    assert {t.device for t in host_tf.transforms[1:3]} == {
        torch.device("cpu")}
    extractor = extract.network_extractor(network, initialize_transforms(
        "pil2np | apply_clahe:4:luv | totensor | normalize", MEAN_STD))
    assert extractor.device_chain.clahe_space == "luv"
    # hls is no normspace, in either package
    with pytest.raises(NotImplementedError, match="Colorspace hls"):
        extract.network_extractor(network, initialize_transforms(
            "pil2np | apply_clahe:4:hls | totensor | normalize", MEAN_STD))
