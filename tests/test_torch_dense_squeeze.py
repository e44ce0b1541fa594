"""Port DenseNet and SqueezeNet trunks, and the extraction of RMAC and
Rpool nets, against the JAX package.

* densenet121 with its block sizes cut to (1, 2, 1, 1) in both packages
  (init width and growth kept) and both squeezenets at full size, on
  images under 100 px, unmasked and as masked buckets, weights carried
  from a JAX tree by ``from_jax_variables``;
* ``trunk_valid_extent`` of all 16 trunks over a sweep of sizes;
* the batched extractor's per-scale region boxes (host arithmetic) and an
  AlexNet-GeM-Rpool and an AlexNet-RMAC through the batched extractor
  (two scales, Lw) against the JAX net image by image with its wrappers;
  ``extract_regional_vectors`` and ``extract_local_vectors``;
* the train step of an RMAC net, which stops in both packages.

No JAX ``init`` is compiled: variable trees come from ``jax.eval_shape``.
"""
import pickle
import types

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import retrievalnet as jax_retrievalnet
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.models.torch_import import import_state_dict
from mdir_tpu.ops import ranking as jax_ranking
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion
from mdir_tpu.parallel import extract as jax_extract

from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.learning.train_step import TrainStep
from mdir_tpu_torch.models import initialize_model, trunks
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.models.torch_import import import_model_state
from mdir_tpu_torch.ops import ranking
from mdir_tpu_torch.ops.preprocess import RawChainInput, chain_from_transform
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.parallel import extract

DENSE_CUT = (64, 32, (1, 2, 1, 1))
MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
TRANSFORM = "pil2np | totensor | normalize"
SCALES = [1, 2 ** -0.5]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small tensors gain nothing from intra-op threads, and beside
    the other test workers the threads' barriers cost seconds a case."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True, scope="module")
def short_densenet121():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.DENSENET_CFGS, "densenet121", DENSE_CUT)
        mp.setitem(trunks.DENSENET_CFGS, "densenet121", DENSE_CUT)
        yield


def _random_tree(tree, rng, path=()):
    """Random numpy leaves for a flax variable tree of shapes: kernels at
    the lecun scale, small biases, BatchNorm away from the identity."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _random_tree(value, rng, path + (key,))
            continue
        n = value.shape
        if key == "kernel":
            leaf = rng.randn(*n) / np.sqrt(np.prod(n[:-1]))
        elif key == "mean" or key == "bias":
            leaf = 0.1 * rng.randn(*n)
        elif key == "var":
            leaf = 0.5 + rng.rand(*n)
        elif key == "scale":
            leaf = 0.8 + 0.4 * rng.rand(*n)
        else:
            raise KeyError(path + (key,))
        out[key] = leaf.astype(np.float32)
    return out


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module",
                params=["densenet121", "squeezenet1_0", "squeezenet1_1"])
def trunk_pair(request):
    """One trunk in both packages, the port's weights carried from random
    JAX variables (BatchNorm statistics included)."""
    arch = request.param
    jax_trunk = jax_trunks.make_trunk(arch)
    shapes = jax.eval_shape(jax_trunk.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 96, 3)))
    variables = {k: _random_tree(v, np.random.RandomState(4))
                 for k, v in shapes.items()}
    state = from_jax_variables(
        {k: {"features": v} for k, v in variables.items()})
    port_trunk = trunks.make_trunk(arch)
    port_trunk.load_state_dict(
        {k[len("features."):]: v for k, v in state.items()}, strict=True)
    return arch, jax_trunk, variables, port_trunk.eval()


def test_state_dict_names_are_cirtorch(trunk_pair):
    arch, _, _, port_trunk = trunk_pair
    names = set(port_trunk.state_dict())
    if arch == "densenet121":
        expected = {"0.weight", "1.running_var", "4.denselayer1.norm1.weight",
                    "4.denselayer1.conv2.weight", "5.norm.running_mean",
                    "5.conv.weight", "6.denselayer2.norm2.bias",
                    "11.weight"}
        assert "0.bias" not in names
    else:
        expected = {"0.weight", "0.bias", "3.squeeze.weight",
                    "3.expand1x1.bias", "12.expand3x3.weight"}
    assert expected <= names


@pytest.mark.parametrize("masked", [False, True])
def test_trunk_matches_jax(trunk_pair, masked):
    """Against JAX within 1e-4; the masked bucket also against each image
    at its own size (ceil-mode pools and frozen BatchNorm at ragged
    extents)."""
    arch, jax_trunk, variables, port_trunk = trunk_pair
    rng = np.random.RandomState(5)
    x = rng.randn(2, 96, 80, 3).astype(np.float32)
    valid = None
    if masked:
        valid = np.asarray([[96, 80], [61, 47]], np.int32)
        x[1, 61:] = 0.0
        x[1, :, 47:] = 0.0
    ref, ref_valid = jax.jit(jax_trunk.apply)(
        variables, jnp.asarray(x),
        None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        ours, ours_valid = port_trunk(
            _nchw(x), None if valid is None else torch.from_numpy(valid))
    assert ours.shape[1] == trunks.OUTPUT_DIM[arch] \
        or arch == "densenet121"  # the cut blocks narrow the output
    np.testing.assert_allclose(np.asarray(ref).transpose(0, 3, 1, 2),
                               ours.numpy(), rtol=1e-4, atol=1e-4)
    if masked:
        np.testing.assert_array_equal(np.asarray(ref_valid),
                                      ours_valid.numpy())
        with torch.no_grad():
            native, _ = port_trunk(_nchw(x[1:, :61, :47]))
        vh, vw = ours_valid[1].tolist()
        assert (vh, vw) == tuple(native.shape[-2:]) \
            == trunks.trunk_valid_extent(arch, (61, 47))
        torch.testing.assert_close(ours[1:, :, :vh, :vw], native,
                                   rtol=1e-4, atol=1e-4)


def test_trunk_valid_extent_matches_jax():
    for arch in trunks.OUTPUT_DIM:
        for h in range(1, 300, 7):
            for w in (1, 2, 31, 32, 33, 64, 97, 255):
                assert trunks.trunk_valid_extent(arch, (h, w)) \
                    == jax_trunks.trunk_valid_extent(arch, (h, w)), \
                    (arch, h, w)


@pytest.mark.parametrize("arch", ["alexnet", "resnet101", "squeezenet1_1",
                                  "densenet121", "vgg16"])
def test_region_boxes_match_jax(arch):
    """The extractor's per-scale boxes (host arithmetic only) equal JAX's
    ``_region_boxes``: ragged and tiny sizes, a filler slot, three
    scales."""
    shapes = [(1, 1), (2, 3), (17, 40), (64, 64), (100, 75), (191, 256)]
    scales = [1, 2 ** -0.5, 0.5]
    bucket = (256, 256)
    ours = object.__new__(extract.StreamingExtractor)
    ours.model = types.SimpleNamespace(architecture=arch)
    ours.scales = scales
    theirs = types.SimpleNamespace(
        model=types.SimpleNamespace(
            module=types.SimpleNamespace(architecture=arch)),
        scales=scales)
    got = ours.region_boxes(shapes, len(shapes) + 1, bucket)
    ref = jax_extract.StreamingExtractor._region_boxes(
        theirs, shapes, len(shapes) + 1, bucket)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.dtype == np.int32 and a.shape[1] % 8 == 0
        np.testing.assert_array_equal(a, b)


def _model_params(pool, regional):
    return {"architecture": "cirnet", "cir_architecture": "alexnet",
            "local_whitening": False, "pooling": pool, "regional": regional,
            "whitening": False, "pretrained": False}


@pytest.fixture(scope="module")
def whiten_pkl(tmp_path_factory):
    rng = np.random.RandomState(0)
    path = tmp_path_factory.mktemp("whiten") / "whiten.pkl"
    with open(path, "wb") as handle:
        pickle.dump({"P": np.eye(256) + 0.05 * rng.randn(256, 256),
                     "m": 0.05 * rng.randn(256, 1)}, handle)
    return str(path)


@pytest.fixture(scope="module", params=["gem-r", "rmac"])
def alexnet_nets(request, whiten_pkl):
    """An AlexNet-GeM-Rpool or -RMAC as a network in both packages from
    one cirtorch-named state dict, with Lw and two scales."""
    pool, regional = ("gem", True) if request.param == "gem-r" \
        else ("rmac", False)
    params = _model_params(pool, regional)
    port_model = initialize_model(params, device="cpu", seed=1)
    rng = np.random.RandomState(2)
    state = {k: v.numpy() for k, v in port_model.state_dict().items()}
    for key in state:
        if key.endswith(".bias"):
            state[key] = (0.05 * rng.randn(*state[key].shape)).astype(
                np.float32)
    if regional:
        state["pool.rpool.p"] = np.asarray([2.7], np.float32)
    import_model_state(port_model, state)
    module, meta = jax_retrievalnet.init_retrieval_net(
        "alexnet", pooling=pool, regional=regional)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = import_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), state)
    jax_model = JaxModel(module, meta, jax.tree.map(jnp.asarray, variables))
    runtime = {"wrappers": {"train": None, "eval": {
        "0_cirwhiten": {"whitening": whiten_pkl},
        "1_cirmultiscale": {"scales": SCALES}}},
        "data": {"mean_std": MEAN_STD}}
    jax_net = JaxCirNetwork(jax_model, JaxCirNetwork.NetworkParams(
        model=params, runtime=dict(runtime)), frozen=True)
    port_net = CirNetwork(port_model, CirNetwork.NetworkParams(
        model=params, runtime=dict(runtime)), frozen=True)
    return request.param, jax_net, port_net


def _images(seed, n, shapes):
    """n uint8 images, cycling through ``shapes``."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shapes[i % len(shapes)], 3) * 255).astype(np.uint8)
            for i in range(n)]


def test_batched_extractor_matches_jax(alexnet_nets, monkeypatch):
    """The batched extractor (region boxes per scale, uint8 ingress,
    two scales, Lw) against the JAX net image by image at native size
    through its wrappers: descriptors within 1e-4, identical ranks, equal
    mAP through both packages' ranking."""
    _, jax_net, port_net = alexnet_nets
    images = _images(7, 12, [(96, 72), (72, 96)])
    transform = initialize_transforms(TRANSFORM, MEAN_STD)
    jax_transform = jax_transforms(TRANSFORM, MEAN_STD)

    def per_image(*args, **kwargs):
        raise AssertionError("took the per-image path")

    monkeypatch.setattr(extract, "_per_image_vectors", per_image)
    ours = extract.extract_vectors_network(port_net, images, None,
                                           transform, batch_size=4)
    ref = np.stack([np.asarray(jax_net(jax_transform(
        Image.fromarray(img)))).reshape(-1) for img in images], axis=1)
    assert ours.shape == ref.shape == (256, len(images))
    np.testing.assert_allclose(ref, ours, rtol=1e-4, atol=1e-4)
    gnd = [{"ok": [i for i in range(8) if i % 3 == q % 3], "junk": []}
           for q in range(4)]
    port_ranks = ranking.rank_database(torch.from_numpy(ours[:, :8]),
                                       torch.from_numpy(ours[:, 8:])).numpy()
    jax_ranks = np.asarray(jax_ranking.rank_database(
        jnp.asarray(ref[:, :8]), jnp.asarray(ref[:, 8:])))
    np.testing.assert_array_equal(port_ranks, jax_ranks)
    assert ranking.compute_map(port_ranks, gnd)[0] \
        == pytest.approx(jax_ranking.compute_map(jax_ranks, gnd)[0], abs=0)


def test_regional_and_local_vectors_match_jax(alexnet_nets, monkeypatch):
    _, jax_net, port_net = alexnet_nets
    images = _images(8, 2, [(96, 72)])
    monkeypatch.setattr(
        jax_extract, "_stream_images",
        lambda images, image_size, transform, bbxs=None:
        (transform(Image.fromarray(img)) for img in images))
    for name in ("extract_regional_vectors", "extract_local_vectors"):
        ours = getattr(extract, name)(
            port_net, images, None, initialize_transforms(TRANSFORM,
                                                          MEAN_STD))
        ref = getattr(jax_extract, name)(
            jax_net, images, None, jax_transforms(TRANSFORM, MEAN_STD))
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            assert a.shape == np.asarray(b).shape, name
            np.testing.assert_allclose(np.asarray(b), a, rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def test_rmac_train_step_stops_as_jax(alexnet_nets):
    """The JAX step pads every tuple and passes ``valid_hw`` without region
    boxes, so an RMAC or Rpool net stops at its assertion; the port's step
    raises at the same point."""
    _, jax_net, port_net = alexnet_nets
    rng = np.random.RandomState(9)
    images = [[rng.randint(0, 256, (rng.randint(64, 97), 72, 3)).astype(
        np.uint8) for _ in range(4)]]
    targets = [np.array([-1, 1, 0, 0], np.float32)]
    criterion = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
    jax_transform = jax_transforms(TRANSFORM, MEAN_STD)
    batch, valid, tgt, _ = jax_prepare_batch(
        [[jax_transform(Image.fromarray(img)) for img in tpl]
         for tpl in images], targets)
    step = JaxTrainStep(jax_net, jax_criterion(dict(criterion)),
                        batch_average=False)
    with pytest.raises(AssertionError, match="region_boxes"):
        step.gradients(jax_net.model.params, batch, valid, tgt,
                       jax.random.PRNGKey(0))
    chain = chain_from_transform(initialize_transforms(TRANSFORM, MEAN_STD))
    port_step = TrainStep(port_net, initialize_criterion(dict(criterion)),
                          device_chain=chain)
    with pytest.raises(ValueError, match="region_boxes"):
        port_step.gradients([RawChainInput()(*tpl) for tpl in images],
                            targets)


@pytest.mark.parametrize("arch", ["densenet121", "squeezenet1_1"])
def test_gem_trunks_batched_equals_per_image(arch, monkeypatch):
    """Mining and eval of the GeM nets on the new trunks go through the
    batched extractor (ragged buckets, two scales): it computes what the
    per-image wrappers compute."""
    monkeypatch.setitem(trunks.OUTPUT_DIM, "densenet121", 76)  # the cut
    params = dict(_model_params("gem", False), cir_architecture=arch)
    network = CirNetwork(initialize_model(params, device="cpu", seed=3),
                         CirNetwork.NetworkParams(model=params, runtime={
                             "wrappers": {"train": None, "eval": {
                                 "0_cirmultiscale": {"scales": SCALES}}},
                             "data": {"mean_std": MEAN_STD}}), frozen=True)
    images = _images(10, 3, [(64, 64), (80, 64), (64, 72)])
    transform = initialize_transforms(TRANSFORM, MEAN_STD)
    batched = extract.extract_vectors_network(network, images, None,
                                              transform, batch_size=4)
    exact = extract.extract_vectors_per_image(network, images, None,
                                              transform)
    np.testing.assert_allclose(exact, batched, rtol=1e-4, atol=1e-5)
