"""The infer stage in both packages, on checkpoints the JAX package writes
(seeded weights; the port reads them through ``models.convert``):

* the embedding output of an AlexNet-GeM on 12 jpgs of at most 64 px and
  one missing image (``ignore_errors``): descriptors within 1e-4 of the JAX
  package's infer stage, NaN rows at the same index;
* the port's batched route within 1e-5 of its per-item loop;
* the append resume and the empty-input fast path give ``skipped``;
* the rgb output of a 2-level P2pUNet (``reflectpad_divisible:32``): PNGs
  within one level of the JAX package's, the share of differing pixels
  printed; ``async: true`` writes the same files;
* the translator's batches in flight (1, 2, 3) give depth 0's results, in
  launch order.
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.learning.checkpoints import save_state
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.network import SingleNetwork as JaxSingleNetwork
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.stages.infer import infer as jax_infer
from test_torch_composition import _seeded

from mdir_tpu_torch.stages import infer as infer_mod
from mdir_tpu_torch.stages.infer import infer

DESC_ATOL = 1e-4  # descriptors against the JAX package
PATH_ATOL = 1e-5  # batched route against the per-item loop
MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
PLAIN = "pil2np | totensor | normalize"
EMBED = {"architecture": "cirnet", "cir_architecture": "alexnet",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
UNET = {"architecture": "p2p_unet", "in_channels": 3, "out_channels": 3,
        "nested_levels": 2}
PAD = "reflectpad_divisible:32"
EMBED_SHAPES = [(64, 48), (48, 64), (64, 64), (60, 52), (40, 64), (64, 37),
                (50, 50), (64, 48), (33, 61), (64, 56), (47, 47), (62, 64)]
MISSING = 3  # index of the name with no file
# one padded shape at divisor 32: the rgb route runs one batch
RGB_SHAPES = [(40, 56), (33, 47), (64, 64), (50, 60)]


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


def _jpgs(directory, shapes, seed):
    from PIL import Image

    directory.mkdir()
    rng = np.random.RandomState(seed)
    names = []
    for i, (h, w) in enumerate(shapes):
        name = "img%02d.jpg" % i
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            directory / name, quality=95)
        names.append(name)
    return names


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The images and the two checkpoints, written by the JAX package."""
    root = tmp_path_factory.mktemp("infer")
    rng = np.random.RandomState(0)
    embed_names = _jpgs(root / "embed", EMBED_SHAPES, 1)
    embed_names.insert(MISSING, "missing.jpg")
    rgb_names = _jpgs(root / "rgb", RGB_SHAPES, 2)

    model = jax_initialize_model(dict(EMBED))
    model.variables = _seeded(model.variables, rng)
    embedder = JaxCirNetwork(model, JaxCirNetwork.NetworkParams(
        model=dict(EMBED), runtime={"wrappers": "", "data": {
            "mean_std": MEAN_STD, "transforms": PLAIN}}))
    save_state(embedder.state_dict()["net"], root / "embed.ckpt")

    model = jax_initialize_model(dict(UNET))
    model.variables = _seeded(model.variables, rng)
    translator = JaxSingleNetwork(model, JaxSingleNetwork.NetworkParams(
        model=dict(UNET), runtime={"wrappers": PAD, "data": {
            "mean_std": [[0.5] * 3, [0.5] * 3], "transforms": PLAIN}}))
    save_state(translator.state_dict()["net"], root / "unet.ckpt")
    return {"root": root, "embed": embed_names, "rgb": rgb_names}


def _embed_params(files):
    return {
        "network": {"path": str(files["root"] / "embed.ckpt"),
                    "runtime": None},
        "output": {"inference": {"name": "embedding"}, "debug": False},
        "data": {"test": {
            "dataset": {"name": "CirImageList",
                        "image_dir": str(files["root"] / "embed"),
                        "image_size": 64, "ignore_errors": True},
            "loader": {"num_workers": 0}}},
    }


def _rgb_params(files, out_dir, **output):
    return {
        "network": {"path": str(files["root"] / "unet.ckpt"),
                    "runtime": None},
        "output": {"inference": dict({"name": "rgb",
                                      "image_dir": str(out_dir)}, **output),
                   "debug": False},
        "data": {"test": {
            "dataset": {"name": "CirImageList",
                        "image_dir": str(files["root"] / "rgb"),
                        "image_size": 64},
            "loader": {"num_workers": 0}}},
    }


@pytest.fixture(scope="module")
def port_embedding(files):
    return infer(_embed_params(files), (list(files["embed"]),), device="cpu")


def test_embedding_matches_jax(files, port_embedding):
    meta, names, vecs = port_embedding
    jmeta, jnames, jvecs = jax_infer(_embed_params(files),
                                     (list(files["embed"]),))
    assert list(names) == list(jnames) == files["embed"]
    assert meta.keys() == jmeta.keys() == {"stats", "resource_usage"}
    assert meta["stats"]["items"] == jmeta["stats"]["items"] == len(
        EMBED_SHAPES)
    assert vecs.shape == jvecs.shape == (len(names), 256)
    nan_rows = np.isnan(vecs).all(axis=1)
    assert nan_rows.tolist() == np.isnan(jvecs).all(axis=1).tolist()
    assert np.flatnonzero(nan_rows).tolist() == [MISSING]
    good = ~nan_rows
    assert np.isfinite(vecs[good]).all()
    np.testing.assert_allclose(vecs[good], jvecs[good], rtol=0,
                               atol=DESC_ATOL)


def test_embedding_batched_equals_per_item(files, port_embedding,
                                           monkeypatch):
    monkeypatch.setattr(infer_mod, "_run_batched", lambda *a, **k: None)
    _, names, vecs = infer(_embed_params(files), (list(files["embed"]),),
                           device="cpu")
    assert np.flatnonzero(np.isnan(vecs).all(axis=1)).tolist() == [MISSING]
    batched = port_embedding[2]
    good = ~np.isnan(batched).all(axis=1)
    np.testing.assert_allclose(batched[good], vecs[good], rtol=0,
                               atol=PATH_ATOL)


def test_embedding_loader_hook(files, port_embedding):
    """A dataset ``loader`` (in-memory uint8 arrays) keeps the batched route
    and gives the rows the files give; its OSError is a missing image."""
    from mdir_tpu_torch.data.images import as_uint8, pil_loader

    def loader(path):
        img = pil_loader(path)
        return img if isinstance(img, Exception) else as_uint8(img)

    params = _embed_params(files)
    params["data"]["test"]["dataset"]["loader"] = loader
    _, _, vecs = infer(params, (list(files["embed"]),), device="cpu")
    np.testing.assert_array_equal(vecs, port_embedding[2])


def test_skipped_without_work(files, tmp_path):
    """Empty input skips before the network loads (its path does not
    exist); an append output that finds every file skips after."""
    params = _embed_params(files)
    params["network"]["path"] = str(tmp_path / "absent.ckpt")
    for run in (infer, jax_infer):
        assert run(copy.deepcopy(params), ([],))[0] == {"status": "skipped"}

    params = _rgb_params(files, tmp_path / "out", append=True)
    meta, _ = infer(copy.deepcopy(params), (list(files["rgb"]),),
                    device="cpu")
    assert "stats" in meta
    meta, fnames = infer(copy.deepcopy(params), (list(files["rgb"]),),
                         device="cpu")
    assert meta == {"status": "skipped"}
    assert fnames == files["rgb"]


def _read(path):
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.int16)


def test_rgb_output_matches_jax(files, tmp_path):
    meta, fnames = infer(_rgb_params(files, tmp_path / "ours"),
                         (list(files["rgb"]),), device="cpu")
    jmeta, jfnames = jax_infer(_rgb_params(files, tmp_path / "theirs"),
                               (list(files["rgb"]),))
    assert fnames == jfnames == files["rgb"]
    assert meta["stats"]["items"] == jmeta["stats"]["items"] == len(
        RGB_SHAPES)
    differ = total = 0
    for name, shape in zip(files["rgb"], RGB_SHAPES):
        ours, theirs = (_read(tmp_path / side / name)
                        for side in ("ours", "theirs"))
        assert ours.shape == theirs.shape == shape + (3,)
        assert np.abs(ours - theirs).max() <= 1, name
        differ += int((ours != theirs).sum())
        total += ours.size
    print("rgb output against JAX: %d of %d values (%.4f%%) differ by one "
          "level" % (differ, total, 100.0 * differ / total))


def test_rgb_async_writes_the_same_files(files, tmp_path):
    for side, asynchronous in (("sync", False), ("async", True)):
        infer(_rgb_params(files, tmp_path / side, **{"async": asynchronous}),
              (list(files["rgb"]),), device="cpu")
    for name in files["rgb"]:
        assert (tmp_path / "sync" / name).read_bytes() \
            == (tmp_path / "async" / name).read_bytes(), name


def test_rgb_batched_equals_per_item(files, tmp_path, monkeypatch):
    infer(_rgb_params(files, tmp_path / "batched"), (list(files["rgb"]),),
          device="cpu")
    monkeypatch.setattr(infer_mod, "_run_batched", lambda *a, **k: None)
    infer(_rgb_params(files, tmp_path / "per_item"), (list(files["rgb"]),),
          device="cpu")
    for name in files["rgb"]:
        a, b = (_read(tmp_path / side / name)
                for side in ("batched", "per_item"))
        assert np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("transforms", [
    "pil2np | apply_clahe:4:lab:8 | totensor | normalize",
    "pil2np | apply_clahe:2:luv:4 | totensor | normalize"])
def test_rgb_output_with_a_photometric_step_matches_jax(files, tmp_path,
                                                        transforms):
    """A photometric step before the translator runs on the host, in the
    JAX package on cv2 and in the port with its device steps on the
    network's device, on both packages' batched route: PNGs within one
    level of the JAX package's."""
    def params(side):
        out = _rgb_params(files, tmp_path / side)
        out["data"]["test"].update(transforms=transforms,
                                   mean_std=[[0.5] * 3, [0.5] * 3])
        return out

    infer(params("ours"), (list(files["rgb"]),), device="cpu")
    jax_infer(params("theirs"), (list(files["rgb"]),))
    for name, shape in zip(files["rgb"], RGB_SHAPES):
        ours, theirs = (_read(tmp_path / side / name)
                        for side in ("ours", "theirs"))
        assert ours.shape == theirs.shape == shape + (3,)
        assert np.abs(ours - theirs).max() <= 1, name


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_translator_depth_keeps_results(depth):
    """Batches kept in flight change when a result is delivered, not what
    it is or its order: every depth gives the arrays of depth 0 (each
    batch drained as soon as it is queued), in launch order."""
    from mdir_tpu_torch.learning.network import SingleNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.parallel.translate import StreamingTranslator

    unet = dict(UNET, nested_levels=1)
    network = SingleNetwork(
        initialize_model(unet, device="cpu", seed=0),
        SingleNetwork.NetworkParams(
            model=unet, runtime={"wrappers": "reflectpad_divisible:8"}))
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, shape + (3,), dtype=np.uint8)
              for shape in [(16, 12), (15, 11), (9, 20), (16, 10), (10, 17),
                            (14, 14), (16, 16), (11, 18), (13, 9), (16, 24),
                            (12, 15), (9, 13), (12, 21)]]
    results = {}
    for d in (0, depth):
        got = results[d] = []
        stream = StreamingTranslator(
            network.eval(), lambda i, inp, out: got.append((i, out)),
            mean_std=[[0.5] * 3, [0.5] * 3], depth=d)
        for i, img in enumerate(images):
            stream.add(i, img)
        stream.finish()
        assert stream.batches == 4  # 8 images padded to 16 x 16, 5 to 16 x 24
    assert [i for i, _ in results[depth]] == [i for i, _ in results[0]]
    for (i, a), (_, b) in zip(results[depth], results[0]):
        assert a.shape == (1,) + images[i].shape and np.array_equal(a, b), i


def test_infer_raises_without_a_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer(_embed_params(files), (list(files["embed"]),))
