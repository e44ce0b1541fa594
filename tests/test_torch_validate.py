"""The validate stage end to end in both packages: the synthetic dataset,
checkpoint and whitening of ``tests/test_e2e_eval.py``, with a ResNet-GeM
whose layer table is cut to (1, 1, 1, 1) in both packages. The JAX
package writes the checkpoint; the port reads it. Metric keys, ranks and mAP
must be equal."""
import os
import pickle

import numpy as np
import pytest

import jax
import torch

import mdir_tpu.optim.scores as jax_scores
from mdir_tpu.learning.checkpoints import save_state
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.stages.validate import validate as jax_validate

import mdir_tpu_torch.optim.scores as port_scores
from mdir_tpu_torch.learning import load_network
from mdir_tpu_torch.models import trunks
from mdir_tpu_torch.stages.validate import validate

LAYERS = (1, 1, 1, 1)
MODEL = {"architecture": "cirnet", "cir_architecture": "resnet101",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def short_resnet101():
    """resnet101 -> Bottleneck (1, 1, 1, 1) in both packages for the module,
    so no full ResNet101 is ever compiled."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                   (jax_trunks.Bottleneck, LAYERS))
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, LAYERS))
        yield


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataroot")
    os.environ["MDIR_TPU_ROOT"] = str(root)

    from PIL import Image

    rng = np.random.RandomState(42)
    jpg_dir = root / "data" / "test" / "roxford5k" / "jpg"
    jpg_dir.mkdir(parents=True)
    imlist = ["img%02d" % i for i in range(8)]
    qimlist = ["img00", "img03"]
    for name in imlist:
        arr = (rng.rand(60, 80, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(jpg_dir / (name + ".jpg"))
    gnd = [
        {"easy": np.array([1, 2]), "hard": np.array([4]),
         "junk": np.array([0]), "bbx": [2.0, 2.0, 70.0, 50.0]},
        {"easy": np.array([5]), "hard": np.array([6, 7]),
         "junk": np.array([3]), "bbx": None},
    ]
    with open(root / "data" / "test" / "roxford5k" / "gnd_roxford5k.pkl",
              "wb") as handle:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd},
                    handle)
    yield root
    os.environ.pop("MDIR_TPU_ROOT", None)


@pytest.fixture(scope="module")
def checkpoint_and_whitening(data_root, short_resnet101):
    model = jax_initialize_model(MODEL)
    network = JaxCirNetwork(
        model,
        JaxCirNetwork.NetworkParams(
            model=dict(MODEL),
            runtime={"wrappers": "",
                     "data": {"mean_std": [model.meta["mean"],
                                           model.meta["std"]],
                              "transforms": "pil2np | totensor | normalize"}}))
    net_path = data_root / "net_checkpoint.ckpt"
    save_state(network.state_dict()["net"], net_path)

    rng = np.random.RandomState(0)
    dim = model.meta["out_channels"]
    P = np.eye(dim, dtype=np.float64) + 0.01 * rng.randn(dim, dim)
    m = 0.01 * rng.randn(dim, 1)
    whit_path = data_root / "whitening.pkl"
    with open(whit_path, "wb") as handle:
        pickle.dump({"P": P, "m": m}, handle)
    return str(net_path), str(whit_path)


def _scenario(net_path, whit_path):
    return {
        "network": {
            "path": net_path,
            "runtime": {
                "wrappers": {
                    "train": None,
                    "eval": {
                        "0_cirwhiten": {"whitening": whit_path,
                                        "dimensions": None},
                        "1_cirmultiscale": {"scales": True},
                    },
                },
            },
        },
        "validation": {
            "type": "MultiCriterialValidation",
            "decisive_criterion": None,
            "roxford5k": {
                "type": "SingleValidation",
                "frequency": None,
                "criterion": {"type": "cirdatasetap", "image_size": 128,
                              "dataset": "roxford5k"},
                "network_overlay": None,
                "data": None,
            },
        },
        "data": {},
    }


def _recording(module, monkeypatch):
    """Record the ranks each validate run scores."""
    seen = []
    original = module.compute_map_and_print

    def record(dataset, ranks, gnd, *args, **kwargs):
        seen.append(np.asarray(ranks))
        return original(dataset, ranks, gnd, *args, **kwargs)

    monkeypatch.setattr(module, "compute_map_and_print", record)
    return seen


def test_checkpoint_loads_jax_weights(checkpoint_and_whitening):
    net_path, _ = checkpoint_and_whitening
    network = load_network({"path": net_path, "runtime": {}}, device="cpu")
    assert network.device == torch.device("cpu")
    assert network.model.pool_p == pytest.approx(3.0)
    assert network.network_params.runtime["data"]["transforms"] \
        == "pil2np | totensor | normalize"


def test_validate_stage_matches_jax(checkpoint_and_whitening, monkeypatch):
    net_path, whit_path = checkpoint_and_whitening
    jax_ranks = _recording(jax_scores, monkeypatch)
    port_ranks = _recording(port_scores, monkeypatch)

    reference, = jax_validate(_scenario(net_path, whit_path), ())
    metadata, = validate(_scenario(net_path, whit_path), (), device="cpu")

    assert metadata.keys() == {"eval"}
    keys = metadata["eval"].keys()
    assert keys == reference["eval"].keys()
    assert "roxford5k/validation/score:ap_medium_avg.4" in keys
    assert len(jax_ranks) == len(port_ranks) == 1
    np.testing.assert_array_equal(jax_ranks[0], port_ranks[0])
    for key in keys:
        assert metadata["eval"][key] == reference["eval"][key], key


def test_tsv_dataset_old_protocol_matches_jax(data_root,
                                              checkpoint_and_whitening,
                                              tmp_path, monkeypatch):
    """CirDatasetAp's tsv db/query mode and the old 'ok' protocol."""
    import json

    from mdir_tpu.learning import load_network as jax_load_network

    net_path, _ = checkpoint_and_whitening
    imgdir = str(data_root / "data" / "test" / "roxford5k" / "jpg")
    with open(tmp_path / "db.tsv", "w") as handle:
        handle.write("identifier\n")
        for i in range(8):
            handle.write("img%02d.jpg\n" % i)
    with open(tmp_path / "queries.tsv", "w") as handle:
        handle.write("query\tbbx\tok\tjunk\n")
        handle.write("img00.jpg\t%s\t%s\t%s\n" % (
            json.dumps([2.0, 2.0, 70.0, 50.0]),
            json.dumps(["img01.jpg", "img02.jpg"]),
            json.dumps(["img00.jpg"])))
        handle.write("img03.jpg\t\t%s\t%s\n" % (
            json.dumps(["img04.jpg"]), json.dumps([])))
    score = {
        "type": "cirdatasetap", "image_size": 96,
        "dataset": {"name": "mini-tsv",
                    "queries": str(tmp_path / "queries.tsv"),
                    "db": str(tmp_path / "db.tsv"), "imgdir": imgdir},
        "transforms": "pil2np | totensor | normalize",
        "mean_std": [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]],
    }
    runtime = {"wrappers": {"train": None,
                            "eval": {"0_cirmultiscale": {"scales": True}}}}
    jax_ranks = _recording(jax_scores, monkeypatch)
    port_ranks = _recording(port_scores, monkeypatch)
    reference = jax_scores.initialize_score(score)(
        jax_load_network({"path": net_path, "runtime": runtime}).eval(),
        None, None)
    ours = port_scores.initialize_score(score)(
        load_network({"path": net_path, "runtime": runtime},
                     device="cpu").eval())
    assert set(ours) == set(reference) == {"map"}
    np.testing.assert_array_equal(jax_ranks[0], port_ranks[0])
    assert ours["map"] == reference["map"]


def test_validate_default_device_needs_a_card(checkpoint_and_whitening):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    net_path, whit_path = checkpoint_and_whitening
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate(_scenario(net_path, whit_path), ())


ALEXNET = dict(MODEL, cir_architecture="alexnet")


@pytest.fixture(scope="module")
def alexnet_checkpoint(data_root):
    model = jax_initialize_model(ALEXNET)
    network = JaxCirNetwork(
        model,
        JaxCirNetwork.NetworkParams(
            model=dict(ALEXNET),
            runtime={"wrappers": "",
                     "data": {"mean_std": [model.meta["mean"],
                                           model.meta["std"]],
                              "transforms": "pil2np | totensor | normalize"}}))
    net_path = data_root / "alexnet_checkpoint.ckpt"
    save_state(network.state_dict()["net"], net_path)
    rng = np.random.RandomState(1)
    dim = model.meta["out_channels"]
    whit_path = data_root / "whitening_alexnet.pkl"
    with open(whit_path, "wb") as handle:
        pickle.dump({"P": np.eye(dim) + 0.01 * rng.randn(dim, dim),
                     "m": 0.01 * rng.randn(dim, 1)}, handle)
    return str(net_path), str(whit_path)


def test_validate_stage_with_clahe_matches_jax(alexnet_checkpoint,
                                               monkeypatch):
    """The paper's CLAHE scenario: AlexNet-GeM, ``apply_clahe`` in the
    transform, multiscale, Lw. Both packages run their device chains."""
    net_path, whit_path = alexnet_checkpoint
    jax_ranks = _recording(jax_scores, monkeypatch)
    port_ranks = _recording(port_scores, monkeypatch)

    def scenario():
        params = _scenario(net_path, whit_path)
        criterion = params["validation"]["roxford5k"]["criterion"]
        criterion["transforms"] = \
            "pil2np | apply_clahe:4:lab:8 | totensor | normalize"
        return params

    reference, = jax_validate(scenario(), ())
    metadata, = validate(scenario(), (), device="cpu")

    keys = metadata["eval"].keys()
    assert keys == reference["eval"].keys()
    assert len(jax_ranks) == len(port_ranks) == 1
    np.testing.assert_array_equal(jax_ranks[0], port_ranks[0])
    for key in keys:
        assert metadata["eval"][key] == reference["eval"][key], key


@pytest.mark.parametrize("transforms", [
    "pil2np | apply_clahe:4:lsh:8 | totensor | normalize",
    "pil2np | apply_clahe:4:luv:8 | totensor | normalize",
])
def test_validate_stage_photometric_matches_jax(alexnet_checkpoint,
                                                monkeypatch, transforms):
    """The paper's other CLAHE spaces, lsh and luv, on both packages'
    device chains, at one scale (the chain is what differs from the lab
    scenario above): equal metric keys, ranks and mAP."""
    net_path, whit_path = alexnet_checkpoint
    jax_ranks = _recording(jax_scores, monkeypatch)
    port_ranks = _recording(port_scores, monkeypatch)

    def scenario():
        params = _scenario(net_path, whit_path)
        params["network"]["runtime"]["wrappers"]["eval"][
            "1_cirmultiscale"] = {"scales": False}
        params["validation"]["roxford5k"]["criterion"]["transforms"] = \
            transforms
        return params

    reference, = jax_validate(scenario(), ())
    metadata, = validate(scenario(), (), device="cpu")

    keys = metadata["eval"].keys()
    assert keys == reference["eval"].keys()
    assert len(jax_ranks) == len(port_ranks) == 1
    np.testing.assert_array_equal(jax_ranks[0], port_ranks[0])
    for key in keys:
        assert metadata["eval"][key] == reference["eval"][key], key
