"""The branched retrieval net (``cirnet_branched``) of the port against the
JAX package's, on AlexNet and a narrow VGG16 (``[8, 8, M, 16, M, 512]``,
registered in both packages; its split at layer 2 is the full VGG16's) at
64 px:

* each variant's forward, a full image and a padded one, within 1e-5 of
  JAX's on the same weights (a random flax tree carried across by
  ``models/convert.py``, which is checked both ways), the JAX factory's own
  ``meta``, and the padded image against its own size;
* batched extraction (the lab CLAHE device chain that appends the
  equalized lightness, two scales) against the per-image path;
* ``pretrained: true`` from a synthetic caffe features file;
* one per-tuple train step in float64 against JAX's whole-batch step;
* a checkpoint round trip;
* an epoch of the train stage: mining, steps, loss validation as one
  padded bucket, its checkpoint.

The JAX models are never initialised by a compiled ``init``: their
variables come from ``jax.eval_shape``, and every leaf that is compared is
set from the same numbers as the port's.
"""
import hashlib
import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import enable_x64

from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import torch_import as jax_torch_import
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion

from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning import checkpoints, train_step
from mdir_tpu_torch.learning.network import CirNetwork, initialize_network
from mdir_tpu_torch.learning.train_step import TrainStep
from mdir_tpu_torch.models import initialize_model, torch_import, trunks
from mdir_tpu_torch.models.branched import BranchedRetrievalNet
from mdir_tpu_torch.models.convert import from_jax_variables, \
    to_jax_variables
from mdir_tpu_torch.models.retrievalnet import ImageRetrievalNet
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.parallel import extract

NARROW_VGG16 = [8, 8, "M", 16, "M", 512]  # ends in OUTPUT_DIM's 512
MEAN_STD = [[0.485, 0.456, 0.406, 0.5], [0.229, 0.224, 0.225, 0.25]]
CRITERION = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
SIZES = [(64, 64), (45, 38)]  # the bucket, and the padded image's extent


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """torch on one thread, JAX compiles out of the persistent cache, a
    shape-only JAX ``Model.init`` and the narrow VGG16 in both packages."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old, threads = getattr(jax.config, key), torch.get_num_threads()
    jax.config.update(key, 1e9)
    torch.set_num_threads(1)

    def init(self, rng, sample_hw=(64, 64)):
        dummy = jnp.zeros((1,) + tuple(sample_hw)
                          + (self.meta.get("in_channels", 3),), jnp.float32)
        shapes = jax.eval_shape(self.module.init, {"params": rng}, dummy)
        self.variables = jax.tree.map(
            lambda leaf: np.zeros(leaf.shape, leaf.dtype), shapes)
        return self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", init)
        mp.setitem(jax_trunks.VGG_CFGS, "vgg16", NARROW_VGG16)
        mp.setitem(trunks.VGG_CFGS, "vgg16", NARROW_VGG16)
        yield
    jax.config.update(key, old)
    torch.set_num_threads(threads)


def branched(arch, layer, aggregation, pooling="gem", whitening=True,
             aux=1, pretrained=False):
    return {"architecture": "cirnet_branched", "cir_architecture": arch,
            "pooling": pooling, "whitening": whitening,
            "pretrained": pretrained,
            "channels": {
                "merge": {"layer": layer, "aggregation": aggregation},
                "branches": {
                    "0_rgb": {"in": 3, "init": "clone", "weight": 1.0},
                    "1_aux": {"in": aux, "init": "sum", "weight": 0.5}}}}


# the registry case of tests/test_models.py (no whitening),
# test_branched_input_merge's (layer 0, a 2-channel aux), both
# aggregations at layers 1 and 2, and the MAC and SPoC heads (concat at
# layer 1 is the SPoC case's)
VARIANTS = {
    "alexnet-sum-1-registry": branched("alexnet", 1, "sum", whitening=False),
    "alexnet-concat-0-input-merge": branched("alexnet", 0, "concat", aux=2),
    "alexnet-mac-sum-2": branched("alexnet", 2, "sum", pooling="mac"),
    "vgg16-sum-2": branched("vgg16", 2, "sum"),
    "vgg16-concat-2": branched("vgg16", 2, "concat"),
    "vgg16-spoc-concat-1": branched("vgg16", 1, "concat", pooling="spoc"),
}


def random_tree(like, seed):
    """A flax variables tree shaped as ``like``: kernels ~ N(0, 1/fan_in),
    biases ~ N(0, 0.1), GeM p 2.5."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "p":
            return np.full(v.shape, 2.5, np.float32)
        if name == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            return (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.randn(*v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, like)


def pair(params, seed=0):
    """The JAX model (shape-only init, then a random tree) and the port's,
    loaded strictly from that tree."""
    jax_model = jax_initialize_model(dict(params))
    variables = random_tree(jax_model.variables, seed)
    jax_model.variables = variables
    port = initialize_model(dict(params), device="cpu", seed=None)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return jax_model, port.eval(), variables


def images(channels, seed=1):
    """A full 64 x 64 image and a padded one (zeros beyond its extent)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(len(SIZES), *SIZES[0], channels).astype(np.float32)
    h, w = SIZES[1]
    x[1, h:] = 0.0
    x[1, :, w:] = 0.0
    return x, np.asarray(SIZES, np.int32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name):
    params = VARIANTS[name]
    jax_model, port, variables = pair(params)
    layer = params["channels"]["merge"]["layer"]
    assert isinstance(port, ImageRetrievalNet if layer == 0
                      else BranchedRetrievalNet)
    assert port.meta == jax_model.meta
    # the convert mapping both ways, every leaf
    back = to_jax_variables(port.state_dict(), variables)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))

    x, valid = images(port.meta["in_channels"])
    ref = np.asarray(jax_model.apply(jnp.asarray(x),
                                     valid_hw=jnp.asarray(valid)))
    with torch.no_grad():
        ours = port(nchw(x), torch.from_numpy(valid)).numpy()
        h, w = SIZES[1]
        native = port(nchw(x[1:, :h, :w])).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1, atol=1e-5)
    assert np.abs(ours - ref).max() <= 1e-5, np.abs(ours - ref).max()
    assert np.abs(ours[1] - native[0]).max() <= 1e-5


def test_batched_extraction_matches_per_image():
    """The VGG16 sum net behind the lab CLAHE device chain that appends the
    equalized lightness, two scales: the batched extractor against the
    exact per-image path within 1e-4."""
    params = VARIANTS["vgg16-sum-2"]
    _, port, _ = pair(params)
    network = CirNetwork(port, CirNetwork.NetworkParams(
        model=params, runtime={"wrappers": {
            "train": None,
            "eval": {"0_cirmultiscale": {"scales": [1, 2 ** -0.5]}}},
            "data": {"mean_std": MEAN_STD}}), frozen=True)
    transform = initialize_transforms(
        "pil2np | add_clahe_fromrgb:4:8:lab | totensor | normalize",
        MEAN_STD)
    rng = np.random.RandomState(4)
    imgs = [rng.randint(0, 256, shape + (3,)).astype(np.uint8)
            for shape in [(64, 48), (50, 64), (64, 48), (33, 40)]]
    extractor = extract.network_extractor(network, transform)
    assert extractor.chain_fn is not None  # the device chain's route
    batched = extract.extract_vectors_network(network, imgs, None, transform)
    exact = extract.extract_vectors_per_image(network, imgs, None, transform)
    assert batched.shape == (512, 4) and np.isfinite(batched).all()
    assert np.abs(batched - exact).max() <= 1e-4


def _features_file(directory, state):
    """``state`` as a caffe features file named with its sha256 prefix."""
    buffer = io.BytesIO()
    torch.save(state, buffer)
    content = buffer.getvalue()
    name = "imagenet-caffe-vgg16-features-%s.pth" \
        % hashlib.sha256(content).hexdigest()[:8]
    directory.mkdir(parents=True, exist_ok=True)
    (directory / name).write_bytes(content)
    return "http://files.invalid/networks/imagenet/" + name


@pytest.mark.parametrize("layer,aggregation", [(2, "sum"), (2, "concat"),
                                               (0, "concat")])
def test_pretrained_matches_jax(tmp_path, monkeypatch, layer, aggregation):
    monkeypatch.setenv("MDIR_TPU_ROOT", str(tmp_path))
    monkeypatch.delenv("CIRTORCH_ROOT", raising=False)
    monkeypatch.delenv("MDIR_TPU_ARTIFACTS", raising=False)
    rng = np.random.RandomState(7)
    plain = initialize_model({
        "architecture": "cirnet", "cir_architecture": "vgg16",
        "local_whitening": False, "pooling": "gem", "regional": False,
        "whitening": False, "pretrained": False}, device="cpu", seed=3)
    state = {key: value + torch.from_numpy(
        0.1 * rng.randn(*value.shape).astype(np.float32))
        for key, value in plain.features.state_dict().items()}
    url = _features_file(tmp_path / "data" / "networks", state)
    monkeypatch.setitem(jax_torch_import.FEATURES_URLS, "vgg16", url)
    monkeypatch.setitem(torch_import.FEATURES_URLS, "vgg16", url)

    params = branched("vgg16", layer, aggregation, pretrained=True)
    jax_model = jax_initialize_model(dict(params))
    theirs = from_jax_variables(jax.tree.map(np.asarray,
                                             jax_model.variables))
    port = initialize_model(dict(params), device="cpu")
    ours = port.state_dict()
    trunk = [key for key in ours
             if key.startswith(("branches.", "features."))]
    assert trunk and set(trunk) == {k for k in theirs
                                    if k.startswith(("branches.",
                                                     "features."))}
    for key in trunk:
        assert torch.equal(ours[key], theirs[key]), key
    if layer:  # the aux branch's first conv: the file's, summed over RGB
        assert torch.equal(ours["branches.aux.0.weight"],
                           state["0.weight"].sum(dim=1, keepdim=True))
        assert torch.equal(ours["branches.rgb.2.weight"], state["2.weight"])
    else:  # the RGB copy, then the weighted sum
        assert torch.equal(ours["features.0.weight"][:, 3:],
                           0.5 * state["0.weight"].sum(dim=1, keepdim=True))


def tuple_batch(seed, channels, n_tuples=2, nnum=3):
    """Normalised float32 tuples of mixed sizes (up to 64 px)."""
    rng = np.random.RandomState(seed)
    tuples = [[rng.randn(rng.randint(40, 65), rng.randint(40, 65),
                         channels).astype(np.float32)
               for _ in range(2 + nnum)] for _ in range(n_tuples)]
    targets = [np.array([-1, 1] + [0] * nnum, np.float32)] * n_tuples
    return tuples, targets


def test_train_step_matches_jax_float64():
    """The port's per-tuple step (the net has no train mode, so the sum of
    the tuples' gradients) against JAX's whole-batch program, float64."""
    params = VARIANTS["vgg16-concat-2"]
    jax_model, port, variables = pair(params, seed=5)
    runtime = {"wrappers": "", "data": {"mean_std": MEAN_STD}}
    jax_net = JaxCirNetwork(jax_model, JaxCirNetwork.NetworkParams(
        model=params, runtime=dict(runtime)))
    port_net = CirNetwork(port, CirNetwork.NetworkParams(
        model=params, runtime=dict(runtime)))
    tuples, targets = tuple_batch(0, 4)

    batch, valid, tgt, _ = jax_prepare_batch(tuples, targets)
    step = JaxTrainStep(jax_net, jax_criterion(CRITERION),
                        batch_average=False)
    with enable_x64():
        weights = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               variables["params"])
        (loss_jax, _), grads = step.gradients(
            weights, batch.astype(np.float64), valid, tgt,
            jax.random.PRNGKey(0))
        grads = from_jax_variables({"params": jax.tree.map(np.asarray,
                                                           grads)})
        loss_jax = float(loss_jax)

    port_step = TrainStep(port_net, initialize_criterion(CRITERION))
    assert not port_step.whole and port_step.compute_dtype is None
    port_net.train()
    port.double()
    with pytest.MonkeyPatch.context() as mp:  # float32 inputs, widened
        mask = train_step.apply_valid_mask
        mp.setattr(train_step, "apply_valid_mask",
                   lambda x, v: mask(x.double(), v))
        loss, n = port_step.gradients(tuples, targets)
    assert n == len(tuples)
    np.testing.assert_allclose(float(loss), loss_jax, rtol=1e-5)
    ours = {name: p.grad for name, p in port.named_parameters()}
    assert ours.keys() == grads.keys()
    for name, grad in ours.items():
        err = np.abs(grad.numpy() - grads[name].numpy()).max()
        assert err <= 1e-5, (name, err)
    assert ours["branches.aux.0.weight"].abs().max() > 0


def test_auto_keeps_the_step_float32():
    """The net has no ``head_dtype`` seam: ``auto`` on an accelerator
    leaves its step in float32 (JAX ``train_step.py:150-155``)."""
    _, port, _ = pair(VARIANTS["vgg16-sum-2"])
    network = CirNetwork(port, CirNetwork.NetworkParams(
        model=VARIANTS["vgg16-sum-2"],
        runtime={"wrappers": "", "compute_dtype": "bfloat16"}))
    assert TrainStep(network, initialize_criterion(CRITERION)) \
        .compute_dtype is None


def test_checkpoint_round_trip(tmp_path):
    params = branched("alexnet", 1, "concat")
    _, port, _ = pair(params, seed=2)
    network = CirNetwork(port, CirNetwork.NetworkParams(
        model=params, runtime={"wrappers": "",
                               "data": {"mean_std": MEAN_STD}}))
    path = tmp_path / "net.ckpt"
    checkpoints.save_state(network.state_dict()["net"], path)
    restored = initialize_network(
        None, "cpu", {"net": checkpoints.load_checkpoint_any(path)})
    loaded = CirNetwork.initialize({"path": str(path), "runtime": {}},
                                   device="cpu")
    x, valid = images(4, seed=3)
    with torch.no_grad():
        want = port(nchw(x), torch.from_numpy(valid))
        for net in (restored, loaded):
            assert isinstance(net.model, BranchedRetrievalNet)
            assert net.model.meta == port.meta
            for key, value in port.state_dict().items():
                assert torch.equal(net.model.state_dict()[key], value), key
            assert torch.equal(net.model(nchw(x), torch.from_numpy(valid)),
                               want)


IMAGES = {"im%d" % i: np.random.RandomState(i).randint(
    0, 256, (40 + i % 3 * 8, 48, 3)).astype(np.uint8) for i in range(12)}


def load_image(path):
    return IMAGES[path.rsplit("/", 1)[-1]]


def test_train_stage_mines_and_validates(tmp_path):
    """An epoch of the train stage on the branched net behind the lab CLAHE
    device chain that appends the lightness: mining through the batched
    extractor, the per-tuple step, loss validation as one padded bucket
    (``batched_eval_loss``), and its checkpoint."""
    import pickle

    from mdir_tpu_torch.learning.validation import batched_eval_loss
    from mdir_tpu_torch.stages.train import train

    db = tmp_path / "db.pkl"
    cids = ["/x/im%d" % i for i in range(12)]
    with open(db, "wb") as handle:
        pickle.dump({split: {"cids": cids, "cluster": [i // 2
                                                        for i in range(12)],
                             "qidxs": qidxs, "pidxs": pidxs}
                     for split, qidxs, pidxs in (("train", [0, 2], [1, 3]),
                                                 ("val", [4, 6], [5, 7]))},
                    handle)
    chain = "pil2np | add_clahe_fromrgb:4:8:lab | totensor | normalize"
    model = branched("alexnet", 1, "concat", whitening=False)

    def tuples(split, query_size):
        return {"mean_std": MEAN_STD, "transforms": chain,
                "dataset": {"name": "CirTuples", "dataset": "retrieval-SfM-mem",
                            "split": split, "image_size": 64, "neg_num": 2,
                            "dataset_pkl": str(db), "image_dir": None,
                            "query_size": query_size, "pool_size": 8,
                            "loader": load_image},
                "loader": {"batch_size": 2}}

    def scenario(directory, epochs):
        return {
            "network": {"type": "CirNetwork", "path": None, "model": model,
                        "initialize": {"weights": "default", "seed": 0},
                        "runtime": {"wrappers": {
                            "train": "cirfaketuplebatch",
                            "eval": "cirfaketuplebatch"},
                            "data": {"mean_std": MEAN_STD,
                                     "transforms": chain}}},
            "learning": {
                "type": "TrainValLearning",
                "checkpoints": {"directory": str(directory),
                                "store_every": 0, "checkpoint_every": 1},
                "training": {
                    "type": "EpochTraining", "epochs": epochs,
                    "deterministic": True, "seed": 0,
                    "criterion": CRITERION,
                    "optimizer": {"algorithm": "sgd", "lr": 0.01,
                                  "momentum": 0, "weight_decay": 0},
                    "scheduler": {"algorithm": "const"},
                    "epoch_iteration": {
                        "type": "SupervisedEpoch", "data": "train",
                        "criterion": "default", "batch_average": False,
                        "fakebatch": True}},
                "validation": {"type": "SingleValidation", "data": "val",
                               "criterion": "default",
                               "network_overlay": None, "frequency": 1}},
            "output": {"learning": {"progress": {"print_each": 0}}},
            "data": {"train": tuples("train", 2), "val": tuples("val", 2)}}

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        from mdir_tpu_torch.learning import validation
        mp.setattr(validation, "batched_eval_loss", lambda *args: calls.append(
            batched_eval_loss(*args)) or calls[-1])
        meta, = train(scenario(tmp_path, 1), (), device="cpu")
    metrics = meta["metrics"]
    assert calls and all(np.isfinite(c) for c in calls)
    for key in ("train/learning/loss:total_avg.4",
                "val/learning/loss:total_avg.4",
                "train/learning/data_mining:average_negative_distance_avg.4"):
        assert len(metrics[key]) == 1 and np.isfinite(metrics[key]).all()
    state = checkpoints.load_checkpoint_any(tmp_path / "epochs"
                                            / "net_last.ckpt")
    assert state["network_params"]["model"] == model
