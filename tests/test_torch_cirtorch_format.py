"""The cirtorch_format stages in both packages, on official-schema files
(``{"meta", "state_dict"}`` as cirtorch writes them, torch tensors in
cirtorch names) that both packages read: the JAX package through its
``import_state_dict``, the port through ``import_model_state``.

Five nets: a ResNet101-GeM whose layer table is cut to (1, 1, 1, 1) in
both packages, with local and global whitening, two AlexNet-GeMs, one
without whitening (its multiscale power is its p) and one with (its power
is 1), an AlexNet-GeM-Rpool (``-r``) and an AlexNet-RMAC. ``convert_contained_net`` of the ResNet and the plain AlexNet gives
checkpoints whose descriptors agree (the AlexNet's within 1e-4 of the JAX
package's own forward); ``embed`` (multiscale,
with a whitening pkl) with either AlexNet agrees within 1e-4.
``learn_whitening`` extracts its database within 1e-4 of JAX's; fed JAX's
descriptor matrix, it learns JAX's Lw to 1e-12, so the comparison of Lw
does not rest on how well conditioned it is. ``load_whitening`` writes the
same pkl.
"""
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mdir_tpu.models.torch_import as jax_torch_import
import mdir_tpu.tools.utils as jax_utils
from mdir_tpu.learning import load_network as jax_load_network
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.stages import cirtorch_format as jax_stage

from mdir_tpu_torch.learning import load_network
from mdir_tpu_torch.models import initialize_model, trunks
from mdir_tpu_torch.stages import cirtorch_format as stage

DESC_ATOL = 1e-4  # descriptors against the JAX package
LEARN_ATOL = 1e-12  # the same float64 numpy in both packages
MEAN_STD = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
NETS = {
    "resnet101_whitened": {"architecture": "resnet101",
                           "local_whitening": True, "pooling": "gem",
                           "regional": False, "whitening": True},
    "alexnet_gem": {"architecture": "alexnet", "local_whitening": False,
                    "pooling": "gem", "regional": False, "whitening": False},
    "alexnet_whitened": {"architecture": "alexnet", "local_whitening": False,
                         "pooling": "gem", "regional": False,
                         "whitening": True},
    "alexnet_gem_r": {"architecture": "alexnet", "local_whitening": False,
                      "pooling": "gem", "regional": True, "whitening": True},
    "alexnet_rmac": {"architecture": "alexnet", "local_whitening": False,
                     "pooling": "rmac", "regional": False,
                     "whitening": False},
}
SHAPES = [(64, 48), (48, 64), (56, 60), (64, 64), (40, 52), (60, 40)]
DB = "retrieval-SfM-test"
CIDS = ["c%010d" % (i * 7919) for i in range(len(SHAPES))]


@pytest.fixture(autouse=True, scope="module")
def _jax_init_without_compile():
    """The JAX package builds each model it loads with a jitted init, then
    overwrites every variable from the checkpoint: here its init makes
    host zeros of the right shapes instead (no compile, no device work)."""
    def init(self, rng, sample_hw=(64, 64)):
        dummy = jnp.zeros((1,) + tuple(sample_hw) + (3,), jnp.float32)
        shapes = jax.eval_shape(self.module.init, {"params": rng}, dummy)
        self.variables = jax.tree.map(
            lambda leaf: np.zeros(leaf.shape, leaf.dtype), shapes)
        return self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", init)
        yield


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True, scope="module")
def _jax_offline():
    """A converted checkpoint says ``pretrained: true``, and the JAX
    package, loading it, would fetch the caffe trunk features before
    overwriting them: here it has none to fetch (as for AlexNet), and any
    download raises at once."""
    def no_download(url, *args, **kwargs):
        raise AssertionError("the test tried to download %s" % url)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_torch_import, "FEATURES_URLS", {})
        mp.setattr(jax_torch_import, "load_url", no_download)
        mp.setattr(jax_utils, "urlopen", no_download)
        yield


@pytest.fixture(autouse=True, scope="module")
def short_resnet101():
    """resnet101 -> Bottleneck (1, 1, 1, 1) in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                   (jax_trunks.Bottleneck, (1, 1, 1, 1)))
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, (1, 1, 1, 1)))
        yield


def _official(path, net, seed):
    """An official cirtorch checkpoint of seeded weights: BatchNorm
    statistics and affine parameters drawn around their defaults, GeM's p
    2.8, BatchNorm's ``num_batches_tracked`` counters as torch writes
    them."""
    model = initialize_model(dict(net, cir_architecture=net["architecture"],
                                  architecture="cirnet", pretrained=False),
                             device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in model.state_dict().items():
        if key.endswith("running_var"):
            value = torch.rand(value.shape, generator=gen) + 0.5
        elif key.endswith(("running_mean", "bias")) and value.dim() == 1:
            value = 0.1 * torch.randn(value.shape, generator=gen)
        elif key in ("pool.p", "pool.rpool.p"):
            value = torch.tensor([2.8])
        elif key.startswith(("whiten.", "lwhiten.", "pool.whiten.")) \
                and value.dim() == 2:
            value = torch.eye(value.shape[0]) \
                + 0.05 * torch.randn(value.shape, generator=gen)
        state[key] = value.clone()
        if key.endswith("running_var"):
            state[key.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    meta = dict(net, outputdim=model.meta["outputdim"], Lw=None, **MEAN_STD)
    torch.save({"meta": meta, "state_dict": state}, path)
    return path


def _jpg(path, shape, rng):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((rng.rand(*shape, 3) * 255).astype(np.uint8)).save(
        path, format="JPEG", quality=95)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both official nets, a data root with a whiten database and its
    images (cirtorch's hashed layout), and an image directory."""
    root = tmp_path_factory.mktemp("cirtorch")
    rng = np.random.RandomState(0)
    nets = {kind: str(_official(root / (kind + ".pth"), net, seed))
            for seed, (kind, net) in enumerate(sorted(NETS.items()))}
    db_root = root / "data" / "train" / DB
    from mdir_tpu_torch.data.datasets import cid2filename

    for cid, shape in zip(CIDS, SHAPES):
        _jpg(cid2filename(cid, str(db_root / "ims")), shape, rng)
    with open(db_root / ("%s-whiten.pkl" % DB), "wb") as handle:
        pickle.dump({"cids": CIDS, "qidxs": [0, 2, 4, 1],
                     "pidxs": [1, 3, 5, 0]}, handle)
    names = []
    for i, shape in enumerate(SHAPES[:4]):
        names.append("im%d.jpg" % i)
        _jpg(str(root / "images" / names[-1]), shape, rng)
    return {"root": root, "nets": nets, "names": names}


def _convert_both(files, kind, tmp_path):
    """The official net ``kind`` converted by each package; both loaded by
    the port, the JAX package's also by the JAX package."""
    ours_path, theirs_path = tmp_path / "ours.ckpt", tmp_path / "theirs.ckpt"
    assert stage.convert_contained_net(
        {"source": files["nets"][kind], "net": str(ours_path)}, ()) == ({},)
    jax_stage.convert_contained_net(
        {"source": files["nets"][kind], "net": str(theirs_path)}, ())
    ours, again = (load_network({"path": str(path), "runtime": None},
                                device="cpu").eval()
                   for path in (ours_path, theirs_path))
    theirs = jax_load_network({"path": str(theirs_path),
                               "runtime": None}).eval()
    assert ours.network_params._asdict() == theirs.network_params._asdict()
    if NETS[kind]["pooling"] == "gem":
        assert ours.model.pool_p == pytest.approx(2.8)
    img = np.random.RandomState(3).rand(56, 60, 3).astype(np.float32)
    return img, ours, again, theirs


def test_convert_matches_jax(files, tmp_path):
    img, ours, again, theirs = _convert_both(files, "alexnet_gem", tmp_path)
    np.testing.assert_allclose(
        ours(img).cpu().numpy().reshape(-1),
        np.asarray(theirs(img)).reshape(-1), rtol=0, atol=DESC_ATOL)
    np.testing.assert_array_equal(again(img).cpu().numpy(),
                                  ours(img).cpu().numpy())


@pytest.mark.parametrize("kind", ["alexnet_gem_r", "alexnet_rmac"])
def test_convert_regional_matches_jax(files, kind, tmp_path):
    """An official ``-r`` (Rpool: ``pool.rpool.p``, ``pool.whiten``) and an
    RMAC file: ``regional`` and ``pooling`` survive the conversion in both
    packages, and the descriptors agree with the JAX package's."""
    _, ours, again, theirs = _convert_both(files, kind, tmp_path)
    model = ours.network_params.model
    assert (model["pooling"], model["regional"]) \
        == (NETS[kind]["pooling"], NETS[kind]["regional"])
    img = np.random.RandomState(6).rand(96, 128, 3).astype(np.float32)
    np.testing.assert_allclose(
        ours(img).cpu().numpy().reshape(-1),
        np.asarray(theirs(img)).reshape(-1), rtol=0, atol=DESC_ATOL)
    np.testing.assert_array_equal(again(img).cpu().numpy(),
                                  ours(img).cpu().numpy())


def test_convert_resnet_matches_jax_conversion(files, tmp_path):
    """BatchNorm (its counters dropped), local and global whitening: the
    JAX package's conversion, loaded by the port, gives the port's
    descriptors (the JAX ResNet's own forward is held against the port's
    in ``tests/test_torch_validate.py``)."""
    img, ours, again, _ = _convert_both(files, "resnet101_whitened",
                                        tmp_path)
    np.testing.assert_allclose(again(img).cpu().numpy(),
                               ours(img).cpu().numpy(), rtol=0, atol=1e-6)


def _lw_pkl(directory, dim):
    rng = np.random.RandomState(4)
    lw = {"m": 0.01 * rng.randn(dim, 1),
          "P": np.eye(dim) + 0.01 * rng.randn(dim, dim)}
    os.makedirs(directory, exist_ok=True)
    name = "%s_%s_%s_%s.lw.pkl" % ("sfm", None, 64, True)
    with open(os.path.join(directory, name), "wb") as handle:
        pickle.dump(lw, handle)


@pytest.mark.parametrize("kind", ["alexnet_gem", "alexnet_whitened"])
def test_embed_matches_jax(files, kind, tmp_path):
    dim = 256
    _lw_pkl(str(tmp_path), dim)

    def params():
        return {"net": files["nets"][kind],
                "imgdir": str(files["root"] / "images"), "image_size": 64,
                "multiscale": True, "whitening": "sfm",
                "whitening_dir": str(tmp_path)}

    ours = stage.embed(params(), (list(files["names"]),), device="cpu")
    theirs = jax_stage.embed(params(), (list(files["names"]),))
    assert ours[0] == theirs[0] == {}
    assert list(ours[1]) == list(theirs[1]) == files["names"]
    for a, b in zip(ours[2:], theirs[2:]):
        assert a.shape == (len(files["names"]), dim)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=DESC_ATOL)
    skipped = stage.embed(params(), ([],), device="cpu")
    assert skipped == ({"status": "skipped"}, [], [], [])


def test_learn_whitening_matches_jax(files, monkeypatch):
    monkeypatch.setenv("MDIR_TPU_ROOT", str(files["root"]))
    seen = {}

    def recording(module, key, feed=None):
        real = module.whitenlearn

        def fn(X, qidxs, pidxs):
            seen[key] = np.asarray(X)
            return real(seen[feed] if feed else X, qidxs, pidxs)
        return fn

    params = {"net": files["nets"]["alexnet_gem"], "whitening": DB,
              "image_size": 64, "multiscale": True}
    monkeypatch.setattr(jax_stage, "whitenlearn",
                        recording(jax_stage, "theirs"))
    jmeta, jlw = jax_stage.learn_whitening(dict(params), ())
    monkeypatch.setattr(stage, "whitenlearn",
                        recording(stage, "ours", feed="theirs"))
    meta, lw = stage.learn_whitening(dict(params), (), device="cpu")

    assert meta.keys() == jmeta.keys() == {"whitening_learn"}
    assert seen["ours"].shape == seen["theirs"].shape == (256, len(CIDS))
    np.testing.assert_allclose(seen["ours"], seen["theirs"], rtol=0,
                               atol=DESC_ATOL)
    for key in ("m", "P"):
        np.testing.assert_allclose(lw[key], jlw[key], rtol=0,
                                   atol=LEARN_ATOL)


def test_learn_whitening_writes_the_pkl(files, monkeypatch, tmp_path):
    monkeypatch.setenv("MDIR_TPU_ROOT", str(files["root"]))
    out = stage.learn_whitening(
        {"net": files["nets"]["alexnet_gem"], "whitening": DB,
         "image_size": 64, "multiscale": False,
         "whitening_dir": str(tmp_path)}, (), device="cpu")
    assert len(out) == 1 and "whitening_learn" in out[0]
    with open(tmp_path / ("%s_None_64_False.lw.pkl" % DB), "rb") as handle:
        lw = pickle.load(handle)
    assert lw["P"].shape == (256, 256) and np.isfinite(lw["P"]).all()


def test_load_whitening_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    lw = {"ms": {"m": rng.randn(4, 1), "P": rng.randn(4, 4)},
          "ss": {"m": rng.randn(4, 1), "P": rng.randn(4, 4)}}
    pth = tmp_path / "whitened.pth"
    torch.save({"meta": {"architecture": "alexnet",
                         "Lw": {"retrieval-SfM-120k": lw}},
                "state_dict": {}}, pth)
    for multiscale in (True, False):
        params = {"net": str(pth), "whitening": "sfm120k",
                  "multiscale": multiscale}
        ours = stage.load_whitening(dict(params), ())
        theirs = jax_stage.load_whitening(dict(params), ())
        assert ours[0] == theirs[0] == {}
        for key in ("m", "P"):
            np.testing.assert_array_equal(ours[1][key], theirs[1][key])
        for side, module in (("ours", stage), ("theirs", jax_stage)):
            assert module.load_whitening(
                dict(params, whitening_dir=str(tmp_path / side)), ()) \
                == ({},)
        name = "retrieval-SfM-120k_None_1024_%s.lw.pkl" % multiscale
        with open(tmp_path / "ours" / name, "rb") as a, \
                open(tmp_path / "theirs" / name, "rb") as b:
            ours_lw, theirs_lw = pickle.load(a), pickle.load(b)
        for key in ("m", "P"):
            np.testing.assert_array_equal(ours_lw[key], theirs_lw[key])


def test_missing_files_raise_naming_them(files, tmp_path, monkeypatch):
    absent = str(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError, match=absent):
        stage.convert_contained_net({"source": absent,
                                     "net": str(tmp_path / "x.ckpt")}, ())
    with pytest.raises(FileNotFoundError, match=absent):
        stage.load_whitening({"net": absent, "whitening": "sfm120k"}, ())
    monkeypatch.setenv("MDIR_TPU_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="whiten.pkl"):
        stage.learn_whitening({"net": files["nets"]["alexnet_gem"],
                               "whitening": "sfm120k"}, (), device="cpu")


def test_official_key_the_port_lacks_raises(files, tmp_path):
    state = torch.load(files["nets"]["alexnet_gem"], weights_only=False)
    state["state_dict"]["pool.rpool.p"] = torch.tensor([3.0])
    torch.save(state, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="pool.rpool.p"):
        stage.convert_contained_net({"source": str(tmp_path / "extra.pth"),
                                     "net": str(tmp_path / "x.ckpt")}, ())


def test_stages_raise_without_a_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage.embed({"net": files["nets"]["alexnet_gem"],
                     "imgdir": str(files["root"] / "images")},
                    (list(files["names"]),))
