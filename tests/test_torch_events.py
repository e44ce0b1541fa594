"""The port's event tools against the JAX package's
(``mdir_tpu_torch/tools/{events,htmlreport,plots,imgtools,sysstats,
warmup}.py``):

* ``tests/test_events.py``'s cases, each run through both packages' brokers
  with the same rows and compared: metric aggregation, best epochs, the
  state round trip, coverage errors, weight histograms and blobs, the html
  report, the tensorboard streamer (a fake writer, and none), the metric
  accessor, ``makegrid`` and the plots;
* the standard-library PNG encoder against PIL's decode, and the
  histogram counted on a tensor's device against ``np.histogram``;
* ``test_tools_misc.py``'s ``test_sysstats`` (the card's statistics with
  ``torch.cuda`` stood in for) and ``test_warmup_extraction_compiles_
  buckets``;
* ``mdir_tpu/stages/example_params.yml``'s ``output.learning`` section
  (progress, tensorboard, htmlreport) through one short training of each
  package from the same weights: the same event keys, weight histograms,
  blob files and report.
"""
import builtins
import copy
import json
import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdir_tpu.learning import learning as jax_learning
from mdir_tpu.models import Model as JaxModel
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.stages.train import train as jax_train
from mdir_tpu.tools import events as jax_events
from mdir_tpu.tools import imgtools as jax_imgtools
from mdir_tpu.tools import plots as jax_plots
from mdir_tpu.tools import warmup as jax_warmup

from mdir_tpu_torch.learning import learning
from mdir_tpu_torch.models import convert, initialize_model
from mdir_tpu_torch.stages.train import train
from mdir_tpu_torch.tools import events, imgtools, plots, sysstats, warmup

Image = pytest.importorskip("PIL.Image")
PACKAGES = {"jax": jax_events, "port": events}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_no_jax_init():
    """JAX compiles out of the persistent cache, torch on one thread, and a
    shape-only JAX ``Model.init`` (every JAX weight is overwritten)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old, threads = getattr(jax.config, key), torch.get_num_threads()
    jax.config.update(key, 1e9)
    torch.set_num_threads(1)

    def init(self, rng, sample_hw=(64, 64)):
        dummy = jnp.zeros((1,) + tuple(sample_hw)
                          + (self.meta.get("in_channels", 3),), jnp.float32)
        shapes = jax.eval_shape(self.module.init, {"params": rng}, dummy)
        self.variables = jax.tree.map(
            lambda leaf: jnp.zeros(leaf.shape, leaf.dtype), shapes)
        return self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", init)
        yield
    jax.config.update(key, old)
    torch.set_num_threads(threads)


def _feed_epoch(broker, epoch, losses, score=None):
    for i, loss in enumerate(losses):
        broker.register_data(epoch, i, len(losses), "train/learning/loss",
                             {"total": loss}, "scalar/loss")
        broker.register_data(epoch, i, len(losses),
                             "train/learning/iteration", {"step": 0.1},
                             "scalar/time")
    if score is not None:
        broker.register_data(epoch, None, 1, "val/learning/score",
                             {"total": score}, "scalar/score")
    broker.close_epoch()


def both(params, dataroots=(None, None)):
    return {name: module.initialize_processor(dict(params), dataroot=root)
            for (name, module), root in zip(PACKAGES.items(), dataroots)}


def test_metadata_aggregation():
    brokers = both({})
    for broker in brokers.values():
        _feed_epoch(broker, 0, [2.0, 4.0], score=0.5)
        _feed_epoch(broker, 1, [1.0, 3.0], score=0.7)
    md = brokers["port"].metadata.metadata()
    np.testing.assert_allclose(md["train/learning/loss:total_avg.4"],
                               [3.0, 2.0])
    assert md["val/learning/score:total"] == [0.5, 0.7]
    assert md == brokers["jax"].metadata.metadata()


def test_is_last_best_and_best_epoch():
    for broker in both({}).values():
        _feed_epoch(broker, 0, [2.0], score=0.5)
        assert broker.metadata.is_last_best("val/learning/score:total")
        _feed_epoch(broker, 1, [1.0], score=0.3)
        assert not broker.metadata.is_last_best("val/learning/score:total")
        assert broker.metadata.is_last_best("train/learning/loss:total")
        assert broker.metadata.best_epoch("val/learning/score:total")[
            "index"] == 0
        assert broker.metadata.is_last_best("epoch")


def test_state_roundtrip():
    for name, module in PACKAGES.items():
        broker = module.initialize_processor({}, dataroot=None)
        _feed_epoch(broker, 0, [2.0])
        state = broker.state_dict()
        assert set(state) == {"name", "params", "consts", "data"}, name
        resumed = module.initialize_processor({}, dataroot=None,
                                              state=state)
        _feed_epoch(resumed, 1, [1.0])
        np.testing.assert_allclose(resumed.metadata.metadata()[
            "train/learning/loss:total_avg.4"], [2.0, 1.0])
    with pytest.raises(AssertionError, match="mismatch"):
        events.initialize_processor({"progress": {"print_each": 1}},
                                    state=state)


def test_errors_coverage():
    reports = {}
    for name, broker in both({}).items():
        _feed_epoch(broker, 0, [2.0], score=0.5)
        _feed_epoch(broker, 1, [1.0])  # the score missing in epoch 1
        reports[name] = broker.metadata.errors()
    assert any("epoch coverage" in e["message"] for e in reports["port"])
    assert reports["port"] == reports["jax"]


def _png(path):
    return np.asarray(Image.open(path))


def test_weight_histograms_and_blobs(tmp_path, rng):
    """The same rows give the same histograms (from a tensor counted where
    it lies, and from float and integer arrays) and the same blob files."""
    w = rng.randn(100)
    ints = rng.randint(-7, 9, 100)
    img = rng.rand(8, 8, 3)
    gray = (rng.rand(5, 7) * 300).astype(np.float32)
    roots = (tmp_path / "jax", tmp_path / "port")
    brokers = both({}, roots)
    for name, broker in brokers.items():
        weights = {"w": w, "i": ints,
                   "t": torch.from_numpy(w.astype(np.float32))} \
            if name == "port" else {"w": w, "i": ints,
                                    "t": w.astype(np.float32)}
        broker.register_data(0, 0, 1, "net/params", weights, "weight/param")
        broker.register_data(0, 0, 1, "data/input", {
            "img.rgb": {"dtype": "image:rgb", "data": img.copy()},
            "img.chan4": {"dtype": "image:gray", "data": gray.copy()}},
            "blob")
        broker.close_epoch()
    for root in roots:
        assert sorted(p.name for p in (root / "blobs").iterdir()) == [
            "data_input:img.chan4:0:0.png", "data_input:img.rgb:0:0.png"]
        for blob in (root / "blobs").iterdir():
            np.testing.assert_array_equal(_png(blob),
                                          _png(roots[0] / "blobs" / blob.name))
    data = {name: broker.data[0]["net/params"]["data"]
            for name, broker in brokers.items()}
    for key in ("w", "i", "t"):
        (centers, counts), = data["port"][key]
        (want_centers, want_counts), = data["jax"][key]
        assert len(centers) == 200 and counts.sum() == 100
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(centers, want_centers)
        assert centers.dtype == want_centers.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_histogram_counts_match_numpy(rng, dtype):
    """Random weights, values on the bin edges, a constant tensor and a
    2-valued one: counts and edges equal numpy's."""
    cases = [torch.from_numpy(rng.randn(3, 4, 5, 7)),
             torch.from_numpy(rng.randn(10000) * 1e-3 + 5),
             torch.full((17,), 0.25), torch.tensor([1.0, 2.0] * 7)]
    edges = np.linspace(-1.0, 1.0, 201)
    cases.append(torch.from_numpy(np.concatenate([edges, edges[::3]])))
    for values in cases:
        values = values.to(dtype)
        got_edges, got = events.histogram_counts(values)
        want, want_edges = np.histogram(values.numpy(), bins=200)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_edges, want_edges)
        assert got.sum() == values.numel()
    with pytest.raises(ValueError, match="not finite"):
        events.histogram_counts(torch.tensor([0.0, float("nan")]))


@pytest.mark.parametrize("shape", [(5, 7), (6, 9, 3), (4, 3, 4), (3, 8, 2),
                                   (1, 1, 1), (13, 1, 3)])
def test_png_encoder_decodes_in_pil(tmp_path, rng, shape):
    array = rng.randint(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(events.encode_png(array))
    decoded = np.asarray(Image.open(path))
    np.testing.assert_array_equal(decoded, array.reshape(decoded.shape))
    assert decoded.shape == (shape if len(shape) == 2 or shape[-1] > 1
                             else shape[:2])


def test_htmlreport_renders(tmp_path):
    pytest.importorskip("matplotlib")
    for name, broker in both({"htmlreport": True},
                             (tmp_path / "jax", tmp_path / "port")).items():
        _feed_epoch(broker, 0, [2.0, 1.5], score=0.4)
        content = (tmp_path / name / "report.html").read_text()
        assert "train/learning/loss" in content
        assert "unavailable" not in content


def test_htmlreport_renders_iteration_blobs_and_weights(tmp_path, rng):
    pytest.importorskip("matplotlib")
    for name, broker in both({"htmlreport": True},
                             (tmp_path / "jax", tmp_path / "port")).items():
        for epoch in range(2):
            for i in range(2):
                broker.register_data(epoch, i, 2, "train/learning/loss",
                                     {"total": 1.0 - i * 0.1}, "scalar/loss")
                broker.register_data(epoch, i, 2, "train_data/input", {
                    "img.rgb": {"dtype": "image:rgb",
                                "data": rng.rand(8, 8, 3)}}, "blob")
            broker.register_data(epoch, 1, 2, "train/net/params",
                                 {"w": rng.randn(50)}, "weight/param")
            broker.close_epoch()
        report = (tmp_path / name / "report.html").read_text()
        assert "train_data/input" in report and "train/net/params" in report
        assert "missing blob" not in report and "unavailable" not in report


def test_htmlreport_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        events.initialize_processor({"htmlreport": True},
                                    dataroot=str(tmp_path))
    # switched off, or without a data root, it draws nothing and needs none
    events.initialize_processor({"htmlreport": False},
                                dataroot=str(tmp_path))


def _fake_tensorboardx(monkeypatch, calls):
    class FakeWriter:
        def __init__(self, path):
            self.path = path
            calls.append(("init", path))

        def add_scalar(self, tag, value, step):
            calls.append(("scalar", tag, float(value), int(step)))

    module = types.ModuleType("tensorboardX")
    module.SummaryWriter = FakeWriter
    monkeypatch.setitem(sys.modules, "tensorboardX", module)


def test_tensorboard_streamer_with_fake_writer(tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    for name, module in PACKAGES.items():
        _fake_tensorboardx(monkeypatch, calls[name])
        broker = module.initialize_processor({"tensorboard": True},
                                             dataroot=str(tmp_path))
        _feed_epoch(broker, 0, [2.0, 1.5], score=0.4)
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", str(tmp_path))
    live = [c for c in calls["port"] if c[0] == "scalar"
            and c[1].startswith("train/learning/loss")]
    assert [(c[2], c[3]) for c in live[:2]] == [(2.0, 0), (1.5, 1)]
    epoch_rows = {c[1]: c[2] for c in calls["port"]
                  if c[0] == "scalar" and c[1].startswith("epoch/")}
    assert epoch_rows["epoch/train/learning/loss/total"] \
        == pytest.approx(1.75)


def test_tensorboard_without_tensorboardx_warns(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    real_import = builtins.__import__

    def block(name, *args, **kwargs):
        if name == "tensorboardX":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", block)
    with pytest.warns(UserWarning, match="tensorboardX not available"):
        broker = events.initialize_processor({"tensorboard": True},
                                             dataroot=str(tmp_path))
    _feed_epoch(broker, 0, [1.0], score=0.1)
    assert os.listdir(tmp_path) == []


def test_metadata_metric_accessor():
    for broker in both({}).values():
        broker.register_data(0, None, None, "train/learning/loss",
                             {"total": 0.5}, "scalar/loss")
        broker.close_epoch()
        assert broker.metadata.metric("train/learning/loss", "total") \
            == [0.5]


def test_imgtools_makegrid(rng):
    mean_std = [[0.5] * 3, [0.5] * 3]
    imgs = [rng.rand(16, 16, 3).astype(np.float32) for _ in range(3)]
    for n in (1, 2, 3):
        grid = imgtools.makegrid(imgs[:n], 12, mean_std, "")
        assert grid.dtype == np.uint8 and grid.ndim == 3
        np.testing.assert_array_equal(
            grid, jax_imgtools.makegrid(imgs[:n], 12, mean_std, ""))


def test_plots_render(rng):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    centers = np.linspace(0, 1, 16)
    for module in (plots, jax_plots):
        fig, ax = plt.subplots()
        module.plot_distribution([(float(i), centers, rng.rand(16))
                                  for i in range(4)], ax)
        module.plot_curve([(0, 1.0), (1, 0.5)], ax)
        plt.close(fig)
        fig, ax = plt.subplots()
        module.plot_histogram([("h%d" % i, centers, rng.rand(16))
                               for i in range(3)], ax)
        plt.close(fig)


def test_sysstats(monkeypatch):
    """Without a card no device; with ``torch.cuda`` stood in for, the
    allocator's and the device's numbers; the host's from /proc."""
    assert sysstats.DeviceStats.memory_usage() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (30, 80))
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 12, "allocated_bytes.all.peak": 20,
        "reserved_bytes.all.current": 16})
    assert sysstats.DeviceStats.memory_usage() == {"cuda:0": {
        "bytes_in_use": 12, "bytes_limit": 80, "bytes_reserved": 16,
        "peak_bytes_in_use": 20}}
    assert sysstats.DeviceStats.memory_usage_by_pid() == {os.getpid(): 12}
    used, total = sysstats.HostStats.memory_gb()
    assert 0 < used <= total
    assert len(sysstats.HostStats.loadavg()) == 3


def test_warmup_extraction_compiles_buckets():
    shapes = [(65, 70), (60, 66), (128, 64)]
    assert warmup.bucket_shapes(shapes, 64) \
        == jax_warmup.bucket_shapes(shapes, 64) \
        == [(64, 128), (128, 64), (128, 128)]
    model = initialize_model({
        "architecture": "cirnet", "cir_architecture": "alexnet",
        "local_whitening": False, "pooling": "gem", "regional": False,
        "whitening": False, "pretrained": False}, device="cpu")
    assert warmup.warmup_extraction(
        model, shapes=[(64, 80), (64, 80)], scales=(1,), max_batch=2,
        mean_std=([0.5] * 3, [0.5] * 3)) == [(64, 80)]
    assert warmup.warmup_extraction(model, shapes=[(40, 48)],
                                    max_batch=2) == [(40, 48)]


# --- example_params.yml's output.learning through one short training ------

OUTPUT_LEARNING = {"progress": {"print_each": 10}, "tensorboard": True,
                   "htmlreport": True}
PIXELCONV = {"architecture": "pixelconv_regr", "in_channels": 3,
             "out_channels": 3, "hidden": [8]}


@pytest.fixture(scope="module")
def image_pairs(tmp_path_factory):
    """8 pairs of 40 x 48 images in a tsv of json rows."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(7)
    with open(root / "tuples.tsv", "w") as handle:
        handle.write("pair\n")
        for i in range(8):
            names = ["p%d_%d.png" % (i, j) for j in range(2)]
            for name in names:
                Image.fromarray((rng.rand(40, 48, 3) * 255).astype(
                    np.uint8)).save(root / name)
            handle.write(json.dumps(names) + "\n")
    return root


def _scenario(directory, epochs, pairs, start):
    ms = [[0.5] * 3, [0.5] * 3]
    transforms = "pil2np | center_crop:32 | totensor | normalize"
    network = {"type": "SingleNetwork", "path": None, "model": PIXELCONV,
               "initialize": {"weights": "default", "seed": 0},
               "runtime": {"wrappers": "",
                           "data": {"mean_std": ms,
                                    "transforms": transforms}}}
    if start is not None:
        network = {"type": "SingleNetwork",
                   "path": str(start / "net_notrain.ckpt"),
                   "runtime": "load_from_checkpoint"}
    return {
        "network": network,
        "learning": {
            "type": "TrainValLearning",
            "checkpoints": {"directory": str(directory), "store_every": 0,
                            "checkpoint_every": 1},
            "training": {
                "type": "EpochTraining", "epochs": epochs,
                "deterministic": True, "seed": 0,
                "criterion": {"loss": "l1"},
                "optimizer": {"algorithm": "sgd", "lr": 0.05,
                              "momentum": 0.0, "weight_decay": 0},
                "scheduler": {"algorithm": "const"},
                "epoch_iteration": {
                    "type": "SupervisedEpoch", "data": "train",
                    "criterion": "default", "batch_average": True,
                    "fakebatch": False}},
            "validation": False},
        # the starting checkpoint's run needs no summaries
        "output": {"learning": copy.deepcopy(
            OUTPUT_LEARNING if start is not None
            else {"progress": OUTPUT_LEARNING["progress"]})},
        "data": {"train": {
            "mean_std": ms, "transforms": transforms,
            "dataset": {"name": "PregeneratedImageTuple",
                        "dataset": str(pairs / "tuples.tsv"),
                        "data_key": "pair", "image_dir": str(pairs),
                        "idx": "0_-1"},
            "loader": {"batch_size": 4, "num_workers": 0}}}}


def _jax_to_port_names(model_params):
    """flax param path "a.b.kernel" -> the port's parameter name."""
    like = jax.tree.map(np.asarray,
                        jax_initialize_model(dict(model_params)).variables)
    return {".".join(path): name for collection, path, name, _, _
            in convert._entries(like) if collection == "params"}


def test_example_output_learning_matches_jax(image_pairs, tmp_path,
                                             monkeypatch):
    """The summaries go to a stand-in tensorboardX writer that records
    them per run directory, so that the two packages' calls compare."""
    pytest.importorskip("matplotlib")
    calls = []
    _fake_tensorboardx(monkeypatch, calls)
    brokers = {}
    for name, module in (("jax", jax_learning), ("port", learning)):
        make = module.initialize_processor

        def record(*args, name=name, make=make, **kwargs):
            brokers[name] = make(*args, **kwargs)
            return brokers[name]
        monkeypatch.setattr(module, "initialize_processor", record)
    train(_scenario(tmp_path / "notrain", 0, image_pairs, None), (),
          device="cpu")
    start = tmp_path / "notrain" / "epochs"
    # the JAX package opens tensorboard on "<dir>/epochs/../epochs", which
    # tensorboardX's makedirs fails on before "<dir>/epochs" exists; the
    # port's run starts from nothing
    (tmp_path / "jax" / "epochs").mkdir(parents=True)
    jax_train(_scenario(tmp_path / "jax", 1, image_pairs, start), ())
    train(_scenario(tmp_path / "port", 1, image_pairs, start), (),
          device="cpu")

    jax_epoch, port_epoch = (brokers[n].data[0] for n in ("jax", "port"))
    assert port_epoch.keys() == jax_epoch.keys()
    assert {"train/net/params", "train/data/input", "train/data/output",
            "train/data/target"} <= port_epoch.keys()
    for key, item in port_epoch.items():
        assert item["dtype"] == jax_epoch[key]["dtype"], key
        assert np.array_equal(item["relative_iteration"],
                              jax_epoch[key]["relative_iteration"]), key
    assert brokers["port"].const_log.consts.keys() \
        == brokers["jax"].const_log.consts.keys()

    # the weights before the first step: the same histograms per tensor
    names = _jax_to_port_names(PIXELCONV)
    theirs = jax_epoch["train/net/params"]["data"]
    ours = port_epoch["train/net/params"]["data"]
    assert {names[k] for k in theirs} == set(ours)
    for key, rows in theirs.items():
        (want_c, want_n), (got_c, got_n) = rows[0], ours[names[key]][0]
        np.testing.assert_array_equal(got_n, want_n, err_msg=key)
        np.testing.assert_array_equal(got_c, want_c, err_msg=key)
        assert len(ours[names[key]]) == len(rows) == 2

    # the same blob files; the samples' inputs and targets equal, outputs
    # within a level
    roots = {n: tmp_path / n / "epochs" / "blobs" for n in ("jax", "port")}
    files = sorted(os.listdir(roots["port"]))
    assert files == sorted(os.listdir(roots["jax"])) and files
    for fname in files:
        if fname.startswith("net_network_graph"):
            continue  # each package draws its own module summary
        got, want = (_png(roots[n] / fname).astype(int)
                     for n in ("port", "jax"))
        tol = 1 if "output" in fname else 0
        assert got.shape == want.shape and np.abs(got - want).max() <= tol, \
            fname
    for n in ("jax", "port"):
        report = (tmp_path / n / "epochs" / "report.html").read_text()
        assert "train/data/input" in report and "train/net/params" in report

    # the same tensorboard summaries (the JAX package streams each loss a
    # step late, so in another order): tags and steps, and the losses
    runs, run = {}, None
    for call in calls:
        if call[0] == "init":
            run = runs.setdefault(os.path.basename(os.path.dirname(
                os.path.normpath(call[1]))), [])
        else:
            run.append(call[1:])
    port, theirs = (sorted(runs[n], key=lambda c: c[::2])
                    for n in ("port", "jax"))
    assert [c[::2] for c in port] == [c[::2] for c in theirs]
    losses = [(c[1], d[1]) for c, d in zip(port, theirs) if "/loss/" in c[0]]
    assert losses
    np.testing.assert_allclose(*zip(*losses), rtol=1e-5)
