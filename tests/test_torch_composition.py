"""The composition eval path in both packages: a P2pUNet translator (two
nested levels, its widths fixed at 64 to 512) with ``reflectpad_divisible``
before an AlexNet-GeM embedder, as the JAX package's
``tests/test_e2e_composition.py`` builds it. The JAX package writes the
composition's checkpoint (an ``epochs/`` directory with
``_network_names``); a second checkpoint is the reference's single file
(member payloads under ``_networks_included``, torch state dicts of the
reference-shaped U-Net and of cirtorch's AlexNet). Outputs must agree within
rtol 1e-4, atol 1e-5; ranks, metric keys and mAP must be equal."""
import copy
import hashlib
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mdir_tpu.optim.scores as jax_scores
from mdir_tpu.config import dict_deep_overlay as jax_overlay
from mdir_tpu.config import load_scenario as jax_load_scenario
from mdir_tpu.data.transforms import \
    initialize_transforms as jax_initialize_transforms
from mdir_tpu.learning import load_network as jax_load_network
from mdir_tpu.learning.checkpoints import save_state
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.network import SequentialNetwork as JaxSequential
from mdir_tpu.learning.network import SingleNetwork as JaxSingleNetwork
from mdir_tpu.learning.network import \
    _route_runtime_overrides as jax_route
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.parallel.extract import \
    extract_vectors_composed as jax_composed
from mdir_tpu.parallel.extract import \
    extract_vectors_network as jax_extract_network
from mdir_tpu.stages.validate import validate as jax_validate
from test_torch_unet import reference_p2p_unet

import mdir_tpu_torch.optim.scores as port_scores
from mdir_tpu_torch import eval as port_eval
from mdir_tpu_torch.config.overlay import dict_deep_overlay, load_scenario
from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning import load_network
from mdir_tpu_torch.learning.network import (SequentialNetwork,
                                             _build_stage_wrappers,
                                             _route_runtime_overrides)
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.parallel import extract
from mdir_tpu_torch.stages.validate import validate

RTOL, ATOL = 1e-4, 1e-5
MEAN_STD = [[0.5] * 3, [0.5] * 3]
PLAIN = "pil2np | totensor | normalize"
UNET = {"architecture": "p2p_unet", "in_channels": 3, "out_channels": 3,
        "nested_levels": 2}
EMBED = {"architecture": "cirnet", "cir_architecture": "alexnet",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
PAD = "reflectpad_divisible:32"
# three raw shapes of one chunk key at divisor 32 (one raw bucket, the same
# pads at every scale), (90, 70) padded at every scale; and a fourth shape
# of its own key
SHAPES = [(90, 70), (75, 66), (82, 88), (96, 64)]


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True, scope="module")
def _jax_init_without_compile():
    """The JAX package builds each model it loads with a jitted init, then
    overwrites every variable from the checkpoint: here its init makes
    zeros of the right shapes instead, which saves an XLA compile per model
    and load."""
    def init(self, rng, sample_hw=(64, 64)):
        dummy = jnp.zeros((1,) + tuple(sample_hw) + (3,), jnp.float32)
        shapes = jax.eval_shape(self.module.init, {"params": rng}, dummy)
        self.variables = jax.tree.map(
            lambda leaf: jnp.zeros(leaf.shape, leaf.dtype), shapes)
        return self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", init)
        yield


def _seeded(variables, rng):
    """Every leaf drawn from ``rng``: kernels N(0, 1/fan_in), biases and
    BatchNorm parameters and statistics around their defaults, variances
    positive, GeM's p at 3."""
    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            value = rng.randn(*leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif name == "var":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "p":
            value = np.full(leaf.shape, 3.0)
        else:
            value = (name == "scale") + 0.1 * rng.randn(*leaf.shape)
        return value.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, variables)


def _eval_runtime(scales, whiten=None):
    wrappers = {"1_cirmultiscale": {"scales": scales}}
    if whiten:
        wrappers["0_cirwhiten"] = {"whitening": whiten, "dimensions": None}
    return {"wrappers": {"train": None, "eval": wrappers}}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The composition written by the JAX package (directory form), the
    reference's single file, and a whitening pkl."""
    root = tmp_path_factory.mktemp("composition")
    rng = np.random.RandomState(0)
    translator_model = jax_initialize_model(dict(UNET))
    translator_model.variables = _seeded(translator_model.variables, rng)
    translator = JaxSingleNetwork(translator_model,
                                  JaxSingleNetwork.NetworkParams(
                                      model=dict(UNET),
                                      runtime={"wrappers": PAD,
                                               "data": {"mean_std": MEAN_STD,
                                                        "transforms": PLAIN}}))
    embed_model = jax_initialize_model(dict(EMBED))
    embed_model.variables = _seeded(embed_model.variables, rng)
    embedder = JaxCirNetwork(embed_model, JaxCirNetwork.NetworkParams(
        model=dict(EMBED), runtime=_eval_runtime(False)))
    state = JaxSequential({"translate": translator, "embed": embedder},
                          ["translate", "embed"]).state_dict()
    directory = root / "epochs"
    directory.mkdir()
    state["net"]["_network_names"] = [k for k in state if k != "net"]
    for key, sub in state.items():
        save_state(sub, directory / (key + "_best.ckpt"))

    # the reference's single file: torch state dicts under the members
    port_embed = initialize_model(dict(EMBED), device="cpu", seed=1)
    reference = {
        "type": "SequentialNetwork", "frozen": False,
        "sequence": ["translate", "embed"],
        "network_hierarchy": {"translate": [], "embed": []},
        "_networks_included": {
            "translate": {
                "type": "SingleNetwork", "frozen": False,
                "network_params": {"model": dict(UNET), "runtime": {
                    "wrappers": PAD,
                    "data": {"mean_std": MEAN_STD, "transforms": PLAIN}}},
                "model_state": {"outerblock." + k: v for k, v in
                                reference_p2p_unet(2, seed=3)
                                .state_dict().items()}},
            "embed": {
                "type": "CirNetwork", "frozen": False,
                "network_params": {"model": dict(EMBED),
                                   "runtime": _eval_runtime(False)},
                "model_state": port_embed.state_dict()}}}
    single = root / "unet_jointly.pth"
    torch.save(reference, single)

    P = np.eye(256) + 0.01 * rng.randn(256, 256)
    with open(root / "lw.pkl", "wb") as handle:
        pickle.dump({"P": P, "m": 0.01 * rng.randn(256, 1)}, handle)
    return {"directory": str(directory), "file": str(single),
            "whiten": str(root / "lw.pkl"), "root": root}


def _images(shapes, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in shapes]


def _host(arr):
    """The plain host transform of the per-image path."""
    return (arr.astype(np.float32) / 255.0 - 0.5) / 0.5


@pytest.mark.parametrize("form", ["directory", "file"])
def test_loads_both_checkpoint_forms_as_jax(checkpoints, form):
    """Both on-disk forms load in the port (the reference's torch state
    dicts with ``strict=True``) and give the JAX package's per-image
    output; meta and data defaults come from the right members."""
    runtime = _eval_runtime(False)
    theirs = jax_load_network({"path": checkpoints[form],
                               "runtime": copy.deepcopy(runtime)}).eval()
    ours = load_network({"path": checkpoints[form],
                         "runtime": copy.deepcopy(runtime)},
                        device="cpu").eval()
    assert isinstance(ours, SequentialNetwork)
    assert ours.sequence == ["translate", "embed"]
    assert ours.meta == theirs.meta == {"in_channels": 3, "out_channels": 256}
    assert ours.network_params.runtime["data"] \
        == {"mean_std": MEAN_STD, "transforms": PLAIN}
    assert ours["translate"].wrappers["eval"].wrappers[0].divisible_by == 32
    assert not ours["embed"].wrappers["eval"].wrappers
    img = _host(_images([(90, 70)])[0])
    np.testing.assert_allclose(
        ours(img).numpy().reshape(-1), np.asarray(theirs(img)).reshape(-1),
        rtol=RTOL, atol=ATOL)


def test_state_dict_round_trip(checkpoints):
    network = load_network({"path": checkpoints["directory"],
                            "runtime": None}, device="cpu")
    state = network.state_dict()
    assert state["net"] == {"type": "SequentialNetwork", "frozen": False,
                            "sequence": ["translate", "embed"],
                            "network_hierarchy": {"translate": [],
                                                  "embed": []}}
    assert state.keys() == {"net", "translate", "embed"}
    again = SequentialNetwork.initialize_from_state(copy.deepcopy(state),
                                                    device="cpu").eval()
    for name in network.sequence:
        for key, value in network[name].model.state_dict().items():
            assert torch.equal(value, again[name].model.state_dict()[key])
    img = _host(_images([(64, 80)])[0])
    assert torch.equal(network.eval()(img), again(img))


def test_runtime_routing_matches_jax():
    runtime = {"wrappers": "fakebatch", "data": {"mean_std": MEAN_STD},
               "compute_dtype": "float32", "pallas": True}
    sequence = ["translate", "embed"]
    assert _route_runtime_overrides(copy.deepcopy(runtime), sequence) \
        == jax_route(copy.deepcopy(runtime), sequence) == {
            "translate": {"data": {"mean_std": MEAN_STD}},
            "embed": {"wrappers": "fakebatch", "compute_dtype": "float32",
                      "pallas": True}}
    with pytest.raises(ValueError, match="frozen"):
        _route_runtime_overrides({"frozen": True}, sequence)


def test_scenario_build_resume_check_and_refusals(checkpoints):
    """A composition from its scenario section (a composition-level runtime
    routed to the members), its checkpoint reloaded against the declared
    params, and what the port refuses: another declared sequence,
    ``train()``, and bfloat16 compute."""
    def scenario():
        return {"sequence": "translate,embed",
                "runtime": {"wrappers": _eval_runtime(False)["wrappers"]},
                "translate": {"type": "SingleNetwork", "model": dict(UNET),
                              "runtime": {"wrappers": PAD,
                                          "data": {"mean_std": MEAN_STD,
                                                   "transforms": PLAIN}},
                              "initialize": {"weights": "default",
                                             "seed": 0}},
                "embed": {"type": "CirNetwork", "model": dict(EMBED),
                          "runtime": {}, "initialize": None}}

    network = SequentialNetwork.initialize(scenario(), device="cpu")
    assert network.network_params.runtime["wrappers"] \
        == _eval_runtime(False)["wrappers"]
    state = network.state_dict()
    SequentialNetwork.initialize_from_state(copy.deepcopy(state), "cpu",
                                            params=scenario())
    wrong = scenario()
    wrong["sequence"] = "embed,translate"
    with pytest.raises(AssertionError, match="sequence"):
        SequentialNetwork.initialize_from_state(copy.deepcopy(state), "cpu",
                                                params=wrong)
    with pytest.raises(NotImplementedError, match="§1.6"):
        network.train()
    bf16 = load_network({"path": checkpoints["directory"],
                         "runtime": {"compute_dtype": "bfloat16"}},
                        device="cpu")
    with pytest.raises(NotImplementedError, match="§1.2"):
        extract.ComposedExtractor(bf16, MEAN_STD)


def test_overlay_falsy_tail_keeps_wrappers(checkpoints):
    network = load_network({"path": checkpoints["directory"],
                            "runtime": _eval_runtime(True)},
                           device="cpu").eval()
    overlaid = network.overlay_params({
        "translate": {"runtime": {"wrappers": PAD, "data": {
            "mean_std": MEAN_STD, "transforms": PLAIN}}},
        "embed": None}).eval()
    assert overlaid.frozen and overlaid is not network
    assert len(overlaid.wrappers["eval"].wrappers) == 1
    assert len(network.wrappers["eval"].wrappers) == 1
    img = _host(_images([(64, 64)])[0])
    out = overlaid(img)
    assert out.shape == (256,)
    assert torch.equal(out, network(img))


@pytest.fixture(scope="module")
def networks(checkpoints):
    """The directory-form composition in both packages, multiscale + Lw."""
    def runtime():
        return _eval_runtime(True, checkpoints["whiten"])
    return (jax_load_network({"path": checkpoints["directory"],
                              "runtime": runtime()}).eval(),
            load_network({"path": checkpoints["directory"],
                          "runtime": runtime()}, device="cpu").eval())


def test_composed_extractor_matches_jax_and_per_image(networks):
    """Multiscale + Lw on mixed shapes, three of them in one chunk."""
    theirs_net, ours_net = networks
    images = _images(SHAPES)
    transform = initialize_transforms(PLAIN, MEAN_STD)
    assert extract._composable(ours_net)
    extractor = extract.ComposedExtractor(ours_net, MEAN_STD, max_batch=3)
    assert extractor.divisor == 32 and extractor.msp == 3.0
    keys = [extractor._key(img) for img in images]
    assert keys[0] == keys[1] == keys[2] != keys[3]
    for i, img in enumerate(images):
        extractor.add(i, img)
    ours = extractor.finish(len(images))
    assert extractor.chunks == 2 and ours.shape == (256, 4)

    theirs = jax_composed(theirs_net, images, None,
                          jax_initialize_transforms(PLAIN, MEAN_STD),
                          max_batch=3)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    per_image = np.stack([ours_net(_host(img)).numpy() for img in images],
                         axis=1)
    np.testing.assert_allclose(ours, per_image, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        extract.extract_vectors_composed(ours_net, images, None, transform,
                                         max_batch=16), ours,
        rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    paths = []
    for i, img in enumerate(_images([(80, 64), (80, 64)], seed=7)):
        paths.append(str(root / ("im%d.png" % i)))
        Image.fromarray(img).save(paths[-1])
    return paths


def test_per_image_path_matches_jax(checkpoints, image_files, monkeypatch):
    """A composition neither batched path takes (a translator with two pad
    wrappers) runs the exact per-image path in both packages."""
    runtime = _eval_runtime(False, checkpoints["whiten"])
    theirs = jax_load_network({"path": checkpoints["directory"],
                               "runtime": copy.deepcopy(runtime)}).eval()
    ours = load_network({"path": checkpoints["directory"],
                         "runtime": copy.deepcopy(runtime)},
                        device="cpu").eval()
    from mdir_tpu.learning.network import Network

    theirs["translate"].wrappers = Network.initialize_wrappers(
        "reflectpad_divisible:8," + PAD)
    ours["translate"].wrappers = _build_stage_wrappers(
        "reflectpad_divisible:8," + PAD)
    assert not extract._composable(ours)
    monkeypatch.setattr(extract, "extract_vectors_composed", None)
    transform = initialize_transforms(PLAIN, MEAN_STD)
    np.testing.assert_allclose(
        extract.extract_vectors_network(ours, image_files, 80, transform),
        jax_extract_network(theirs, image_files, 80,
                            jax_initialize_transforms(PLAIN, MEAN_STD)),
        rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A roxford5k of 6 images (each its own query, no boxes)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dataroot")
    rng = np.random.RandomState(11)
    jpg_dir = root / "data" / "test" / "roxford5k" / "jpg"
    jpg_dir.mkdir(parents=True)
    imlist = ["img%02d" % i for i in range(6)]
    for name in imlist:
        Image.fromarray((rng.rand(72, 88, 3) * 255).astype(np.uint8)).save(
            jpg_dir / (name + ".jpg"))
    gnd = [{"easy": np.array([(i + 1) % 6]), "hard": np.array([(i + 2) % 6]),
            "junk": np.array([i]), "bbx": None} for i in range(6)]
    with open(root / "data" / "test" / "roxford5k" / "gnd_roxford5k.pkl",
              "wb") as handle:
        pickle.dump({"imlist": imlist, "qimlist": imlist, "gnd": gnd},
                    handle)
    old = os.environ.get("MDIR_TPU_ROOT")
    os.environ["MDIR_TPU_ROOT"] = str(root)
    yield root
    if old is None:
        os.environ.pop("MDIR_TPU_ROOT")
    else:
        os.environ["MDIR_TPU_ROOT"] = old


def _validation(image_size=88):
    return {"type": "MultiCriterialValidation", "decisive_criterion": None,
            "roxford5k": {"type": "SingleValidation", "frequency": None,
                          "criterion": {"type": "cirdatasetap",
                                        "image_size": image_size,
                                        "dataset": "roxford5k"},
                          "network_overlay": None, "data": None}}


def test_validate_stage_matches_jax(checkpoints, data_root, monkeypatch):
    def scenario():
        return {"network": {"path": checkpoints["directory"],
                            "runtime": _eval_runtime(True,
                                                     checkpoints["whiten"])},
                "validation": _validation(), "data": {}}

    seen = {}
    for module, tag in ((jax_scores, "jax"), (port_scores, "port")):
        original = module.compute_map_and_print

        def record(dataset, ranks, gnd, *args, tag=tag, original=original,
                   **kwargs):
            seen[tag] = np.asarray(ranks)
            return original(dataset, ranks, gnd, *args, **kwargs)
        monkeypatch.setattr(module, "compute_map_and_print", record)

    reference, = jax_validate(scenario(), ())
    metadata, = validate(scenario(), (), device="cpu")
    assert metadata["eval"].keys() == reference["eval"].keys()
    assert "roxford5k/validation/score:ap_medium_avg.4" in metadata["eval"]
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    for key, value in metadata["eval"].items():
        assert value == reference["eval"][key], key


@pytest.mark.parametrize("shortcut", ["test", "clahe", "composition"])
def test_eval_scenarios_overlay_as_jax(shortcut):
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "iccv19")
    files = [os.path.join(here, "eval.yml"),
             os.path.join(here, "eval_%s.yml" % shortcut)]
    assert load_scenario(files) == jax_load_scenario(files)
    assert load_scenario(files)["network"]["path"].startswith("http")


@pytest.mark.parametrize("base,overlay", [
    ({"a": {"b": 1, "c": [1]}}, {"a": {"b": 2, "c*": [3]}}),
    ({"a": [1, 2]}, {"a+": [3]}),
    ({"a": [{"x": 1}, {"x": 2}]}, {"a": {1: {"x": 5}}}),
    ({"a": 1}, {"a": {"nested": True}}),
])
def test_dict_deep_overlay_matches_jax(base, overlay):
    assert dict_deep_overlay(copy.deepcopy(base), copy.deepcopy(overlay)) \
        == jax_overlay(copy.deepcopy(base), copy.deepcopy(overlay))
    with pytest.raises(ValueError):
        dict_deep_overlay({"a": [1]}, {"a": [2]})


def test_eval_entry_on_synthetic_dataset(checkpoints, data_root, tmp_path,
                                         capsys):
    """``python -m mdir_tpu_torch.eval`` on the repository's eval.yml and an
    overlay naming the single-file checkpoint and the whitening by URL; the
    files stand in ``--artifacts`` under their hash-named basenames."""
    import yaml

    artifacts = tmp_path / "artifacts"
    artifacts.mkdir()
    urls = {}
    for key, src in (("path", checkpoints["file"]),
                     ("whitening", checkpoints["whiten"])):
        with open(src, "rb") as handle:
            content = handle.read()
        name = "unet-%s.%s" % (hashlib.sha256(content).hexdigest()[:8],
                               src.rsplit(".", 1)[1])
        (artifacts / name).write_bytes(content)
        urls[key] = "http://artifacts.invalid/models/" + name
    overlay = tmp_path / "overlay.yml"
    overlay.write_text(yaml.safe_dump({
        "network": {"path": urls["path"], "runtime": {"wrappers": {
            "eval": {"0_cirwhiten": {"whitening": urls["whitening"]}}}}},
        "validation*": _validation()}))
    argv = [os.path.join(port_eval.EXAMPLES, "eval.yml"), str(overlay)]
    assert port_eval.main(argv + ["--artifacts", str(artifacts)],
                          device="cpu") == 0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if "roxford.5k medium" in line]
    assert len(lines) == 1 and float(lines[0].split()[-1]) >= 0

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_eval.main(argv + ["--artifacts", str(artifacts)])
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nowhere")):
        port_eval.main(argv + ["--artifacts", str(tmp_path / "nowhere")],
                       device="cpu")
    (artifacts / urls["path"].rsplit("/", 1)[1]).write_bytes(b"other")
    with pytest.raises(ValueError, match="hash"):
        port_eval.main(argv + ["--artifacts", str(artifacts)],
                       device="cpu")
