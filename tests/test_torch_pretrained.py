"""``pretrained: true`` in the port against the JAX package: the caffe trunk
features file (cirtorch's ``imagenet-caffe-<arch>-features-<hash>.pth``)
loads into the same weights in both.

The published files are not in the repository, so the file here is a
synthetic one in cirtorch's layout, written under a temporary data root
(``MDIR_TPU_ROOT``) with a sha256 prefix in its name, for a short ResNet50
((1, 1, 1, 1) bottleneck layers at full widths in both packages).
"""
import hashlib
import io

import numpy as np
import pytest

import jax
import torch

from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import torch_import as jax_torch_import
from mdir_tpu.models import trunks as jax_trunks

from mdir_tpu_torch.models import initialize_model, torch_import, trunks
from mdir_tpu_torch.models.convert import from_jax_variables

RESNET50 = {"architecture": "cirnet", "cir_architecture": "resnet50",
            "local_whitening": False, "pooling": "gem", "regional": False,
            "whitening": False, "pretrained": True}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture
def short_resnet50(monkeypatch):
    monkeypatch.setitem(jax_trunks.RESNET_LAYERS, "resnet50",
                        (jax_trunks.Bottleneck, (1, 1, 1, 1)))
    monkeypatch.setitem(trunks.RESNET_LAYERS, "resnet50",
                        (trunks.Bottleneck, (1, 1, 1, 1)))


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    monkeypatch.setenv("MDIR_TPU_ROOT", str(tmp_path))
    monkeypatch.delenv("CIRTORCH_ROOT", raising=False)
    monkeypatch.delenv("MDIR_TPU_ARTIFACTS", raising=False)
    return tmp_path / "data" / "networks"


def _features_file(directory, state):
    """``state`` saved as cirtorch names a features file: the first 8 hex
    digits of its sha256 in the name (checked on load)."""
    buffer = io.BytesIO()
    torch.save(state, buffer)
    content = buffer.getvalue()
    name = "imagenet-caffe-resnet50-features-%s.pth" \
        % hashlib.sha256(content).hexdigest()[:8]
    directory.mkdir(parents=True, exist_ok=True)
    (directory / name).write_bytes(content)
    return "http://files.invalid/networks/imagenet/" + name


def _caffe_state(rng):
    """A features state dict in cirtorch's layout (``0.weight``,
    ``4.0.conv1.weight``, ...): random weights and BatchNorm statistics,
    and a ``num_batches_tracked`` counter as newer torch writes one."""
    model = initialize_model(dict(RESNET50, pretrained=False), device="cpu",
                             seed=7)
    state = {}
    for key, value in model.features.state_dict().items():
        if key.endswith("running_var"):
            value = torch.from_numpy(
                rng.uniform(0.5, 2.0, value.shape).astype(np.float32))
        elif key.endswith(("running_mean", "bias")):
            value = torch.from_numpy(
                rng.normal(0, 0.1, value.shape).astype(np.float32))
        state[key] = value.clone()
    state["1.num_batches_tracked"] = torch.tensor(0)
    return state


def test_features_load_as_the_jax_package_loads_them(short_resnet50,
                                                     data_root, monkeypatch):
    state = _caffe_state(np.random.RandomState(0))
    url = _features_file(data_root, state)
    monkeypatch.setitem(jax_torch_import.FEATURES_URLS, "resnet50", url)
    monkeypatch.setitem(torch_import.FEATURES_URLS, "resnet50", url)

    jax_model = jax_initialize_model(dict(RESNET50))
    port_model = initialize_model(dict(RESNET50), device="cpu")
    theirs = from_jax_variables(jax.tree.map(np.asarray,
                                             jax_model.variables))
    ours = port_model.state_dict()
    trunk = [key for key in ours if key.startswith("features.")]
    assert trunk and set(trunk) == {k for k in theirs
                                    if k.startswith("features.")}
    for key in trunk:
        assert torch.equal(ours[key], theirs[key]), key
        assert torch.equal(ours[key], state[key[len("features."):]]), key


def test_absent_features_file_raises(short_resnet50, data_root):
    expected = data_root / torch_import.FEATURES_URLS["resnet50"].rsplit(
        "/", 1)[1]
    with pytest.raises(FileNotFoundError, match=str(expected)):
        initialize_model(dict(RESNET50), device="cpu")


def test_corrupt_features_file_raises(short_resnet50, data_root,
                                      monkeypatch):
    url = _features_file(data_root, _caffe_state(np.random.RandomState(1)))
    path = data_root / url.rsplit("/", 1)[1]
    path.write_bytes(path.read_bytes() + b"\0")
    monkeypatch.setitem(torch_import.FEATURES_URLS, "resnet50", url)
    with pytest.raises(ValueError, match="hash"):
        initialize_model(dict(RESNET50), device="cpu")


def test_alexnet_has_no_features_file(data_root):
    """No caffe features for AlexNet: ``pretrained: true`` keeps the seeded
    weights, as the JAX package keeps its initialisation."""
    params = dict(RESNET50, cir_architecture="alexnet")
    pretrained = initialize_model(params, device="cpu", seed=3)
    seeded = initialize_model(dict(params, pretrained=False), device="cpu",
                              seed=3)
    for (name, a), (_, b) in zip(pretrained.state_dict().items(),
                                 seeded.state_dict().items()):
        assert torch.equal(a, b), name
