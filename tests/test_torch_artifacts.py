"""Published files named by URL on every entry of the port: a network
checkpoint ``path`` (``learning/checkpoints.py::Checkpoints.load_network``,
so ``learning.load_network`` and the train and infer stages) and a
``whitening`` pkl (the ``cirwhiten`` wrapper, ``learning/wrappers.py::
CirtorchWhiten``, and a ``cirnet``'s whitening, ``models.
load_whitening_pkl``) are read from ``<data root>/networks/<basename>``
(``tools/utils.py::resolve_artifact``) with the sha256 prefix in the name
checked, as the JAX package reads what it cached there. Nothing is
downloaded: a missing file raises with the path to put it at. The files
here are synthetic, under a temporary data root.
"""
import hashlib
import io
import pickle

import numpy as np
import pytest
import torch

from mdir_tpu_torch.learning import load_network
from mdir_tpu_torch.learning.checkpoints import Checkpoints
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.learning.wrappers import CirtorchWhiten
from mdir_tpu_torch.models import initialize_model, load_whitening_pkl

ALEXNET = {"architecture": "cirnet", "cir_architecture": "alexnet",
           "local_whitening": False, "pooling": "gem", "regional": False,
           "whitening": True, "pretrained": False}
HOST = "http://files.invalid/networks/"


@pytest.fixture(autouse=True)
def data_root(tmp_path, monkeypatch):
    monkeypatch.setenv("MDIR_TPU_ROOT", str(tmp_path))
    monkeypatch.delenv("CIRTORCH_ROOT", raising=False)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path / "data" / "networks"
    torch.set_num_threads(old)


def publish(directory, stem, suffix, content):
    """``content`` as ``<stem>-<sha256 prefix>.<suffix>``; its URL."""
    name = "%s-%s.%s" % (stem, hashlib.sha256(content).hexdigest()[:8],
                         suffix)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / name).write_bytes(content)
    return HOST + name


def whitening(rng, dim=256):
    return {"P": np.eye(dim) + 0.01 * rng.randn(dim, dim),
            "m": 0.01 * rng.randn(dim, 1)}


def test_network_path_by_url(data_root):
    model = initialize_model(ALEXNET, device="cpu", seed=3)
    network = CirNetwork(model, CirNetwork.NetworkParams(
        model=dict(ALEXNET), runtime={"wrappers": ""}))
    buffer = io.BytesIO()
    torch.save(network.state_dict()["net"], buffer)
    url = publish(data_root, "retrieval-alexnet", "pth", buffer.getvalue())
    for loaded in (Checkpoints.load_network(url)["net"]["model_state"],
                   load_network({"path": url, "runtime": {}},
                                device="cpu").model.state_dict(),
                   CirNetwork.initialize({"path": url, "runtime": {}},
                                         device="cpu").model.state_dict()):
        for key, value in model.state_dict().items():
            assert torch.equal(loaded[key], value), key


def test_whitening_by_url(data_root):
    whit = whitening(np.random.RandomState(0))
    url = publish(data_root, "retrieval-alexnet-whiten", "pkl",
                  pickle.dumps(whit))
    wrapper = CirtorchWhiten(url)
    np.testing.assert_array_equal(wrapper.P.numpy(),
                                  whit["P"].astype(np.float32))
    np.testing.assert_array_equal(wrapper.m.numpy(),
                                  whit["m"].astype(np.float32))

    P = whit["P"].astype(np.float32)
    bias = (-P @ whit["m"].astype(np.float32)).reshape(-1)
    for model in (load_whitening_pkl(initialize_model(
            ALEXNET, device="cpu"), url),
            initialize_model(dict(ALEXNET, whitening=url), device="cpu")):
        np.testing.assert_array_equal(model.whiten.weight.detach().numpy(),
                                      P)
        np.testing.assert_array_equal(model.whiten.bias.detach().numpy(),
                                      bias)


def test_missing_file_raises_with_its_path(data_root):
    model = initialize_model(ALEXNET, device="cpu")
    for call, name in (
            (Checkpoints.load_network, "net-0123abcd.pth"),
            (lambda url: load_network({"path": url, "runtime": {}},
                                      device="cpu"), "net-0123abcd.pth"),
            (CirtorchWhiten, "whiten-0123abcd.pkl"),
            (lambda url: load_whitening_pkl(model, url),
             "whiten-0123abcd.pkl")):
        with pytest.raises(FileNotFoundError, match=str(data_root / name)):
            call(HOST + name)


def test_corrupt_file_fails_its_hash(data_root):
    url = publish(data_root, "whiten", "pkl",
                  pickle.dumps(whitening(np.random.RandomState(1), 8)))
    path = data_root / url.rsplit("/", 1)[1]
    path.write_bytes(path.read_bytes() + b"\0")
    with pytest.raises(ValueError, match="hash"):
        CirtorchWhiten(url)
