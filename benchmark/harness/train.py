"""The train harness: whole epochs of ``SupervisedEpoch.iterate``.

Set-up builds the port's kernels, draws the trunk's weights and GeM's p
from the seed on the device, makes the mix's database on the device (kept
on the host, where the dataset's ``loader`` serves it from memory), writes
the dataset pkl to a temporary directory, and builds one training object:
the port's ``CirNetwork``, its Adam optimizer and contrastive criterion, and
the ``SupervisedEpoch`` over a ``CirTuples`` dataset. It then runs epoch 0
through that object: mining, then every step. The plain reference follows
that epoch's first three steps from the seed's draw, and each window
epoch's first three from the weights and Adam's state it started with.

An epoch is mining (the query subset and the negative pool extracted, the
pool ranked, the hardest negatives picked) and one optimizer step per batch
of tuples. The host RNGs are seeded with ``seed + epoch`` at each epoch's
start, as the train stage seeds them. The window starts epochs until the
first that ends after ``seconds``; ``tuples_per_s`` is every tuple trained
in those epochs over their whole wall time. With ``trace`` the first
window epoch's mining and first ``TRACED_STEPS`` steps run under
``torch.profiler`` inside the span ``bench.window``, and the per-layer
readers get the epochs' time without the profiler's collection of the
trace (``epochs_s``).

What the epochs produced is recorded from the program's own calls (per
epoch: the weights and Adam's state it started with, the mining's
descriptors and picks, the steps' losses, the gradient step 1 gave Adam
and the weights after step 3) and judged once the window has closed and
the peak memory has been read (``training_check``).
"""
import contextlib
import io
import os
import pickle
import random
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from harness import images as bench_images
from harness import training_check
from harness.training_check import tuple_images
from harness.eval import WINDOW_SPAN, _sync, note
from harness.registry import Registry
from reference import nets, training

TRACED_STEPS = 5
control = training_check.control  # the control of these cells


def reference_config(config, mix):
    tr = config["train"]
    return dict(config["reference"], scales=[1], mean=tr["mean_std"][0],
                std=tr["mean_std"][1], **mix["check"])


class Recorder:
    """Per epoch: the mining's descriptor calls (image indices and the
    (D, n) descriptors), the picks, the tuple indices in step order, the
    steps' losses and the stopwatch laps the epoch logged."""

    def __init__(self):
        self.epochs = []

    def start(self):
        self.epochs.append({"mined": [], "tuples": [], "losses": [],
                            "prepare_s": 0.0, "process_s": []})

    def logger(self, iteration, size, label, value, dtype):
        del iteration, size, dtype
        if label == "learning/prepare_epoch":
            self.epochs[-1]["prepare_s"] += value["prepare_data"]
        elif label == "learning/iteration":
            self.epochs[-1]["process_s"].append(value["process_batch"])

    @contextlib.contextmanager
    def recording(self, dataset_cls):
        describe = dataset_cls.descriptors
        getitem = dataset_cls.__getitem__
        recorder = self

        def descriptors(dataset, network, indices):
            with torch.profiler.record_function("bench.mine"):
                out = describe(dataset, network, indices)
            recorder.epochs[-1]["mined"].append((list(indices), out))
            return out

        def item(dataset, index):
            recorder.epochs[-1]["tuples"].append(int(index))
            return getitem(dataset, index)

        with mock.patch.object(dataset_cls, "descriptors", descriptors), \
                mock.patch.object(dataset_cls, "__getitem__", item):
            yield


def _snapshot(model):
    """A copy of the model's parameters and statistics, by name."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _adam_state(optimizer, by_name):
    """A copy of Adam's state of each parameter that has one, by name."""
    inner = getattr(optimizer, "optimizer", optimizer)
    out = {}
    for k, p in by_name.items():
        state = inner.state.get(p)
        if state:
            out[k] = {"step": float(state["step"]),
                      "exp_avg": state["exp_avg"].detach().clone(),
                      "exp_avg_sq": state["exp_avg_sq"].detach().clone()}
    return out


def run(cell, config, mix, seed, seconds, trace, device, started,
        warmup=True, after=None):
    """One run of a train cell; returns the run's result dict.
    ``warmup`` is kept for the harnesses' common call: epoch 0 is the
    set-up the reference follows and always runs. ``after(inputs)``, if
    given, is called with the run's inputs once the run is judged."""
    del warmup
    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.datasets import TuplesDataset
    from mdir_tpu_torch.learning.epoch_iteration import SupervisedEpoch
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.optim.criteria import initialize_criterion
    from mdir_tpu_torch.optim.optimizers import initialize_optimizer

    note(started, "imports")
    if device.type == "cuda":
        _build.build(_build.sources())
    note(started, "kernels built")
    tr = config["train"]
    generator = torch.Generator(device=device).manual_seed(seed)
    ref = reference_config(config, mix)
    params0 = nets.draw_params(ref["trunk"], ref["trunk_cfg"], generator,
                               device, ref["gem_p"])
    traffic = Registry.generator(mix).generate(mix, seed)
    colour = bench_images.fields(traffic["templates"], traffic["field"],
                                 generator, device)
    pixels = bench_images.render(traffic["images"], colour,
                                 traffic["noise"], generator)
    del colour
    with torch.device(device):
        model = initialize_model(config["model"], device=device, seed=None)
    model.load_state_dict(params0, strict=True)
    note(started, "weights, images and the net made")

    with tempfile.TemporaryDirectory() as tmp:
        db_pkl = os.path.join(tmp, "db.pkl")
        names = [spec["name"] for spec in traffic["images"]]
        with open(db_pkl, "wb") as handle:
            pickle.dump({"train": {"cids": ["/mem/" + n for n in names],
                                   "cluster": traffic["cluster"],
                                   "qidxs": traffic["qidxs"],
                                   "pidxs": traffic["pidxs"]}}, handle)
        network = CirNetwork(model, CirNetwork.NetworkParams(
            model=dict(config["model"]), runtime=dict(
                config["runtime"],
                wrappers={"train": "cirfaketuplebatch", "eval": ""},
                data={"transforms": tr["transforms"],
                      "mean_std": tr["mean_std"]})))
        criterion = initialize_criterion(dict(tr["criterion"]))
        optimizer = initialize_optimizer(network=network,
                                         params=dict(tr["optimizer"]))
        iteration = SupervisedEpoch.initialize(
            {"data": "train", "criterion": "default",
             "batch_average": False, "fakebatch": True},
            data=(), params_data={"train": {
                "dataset": {
                    "name": "CirTuples", "dataset": "retrieval-SfM-bench",
                    "split": "train", "image_size": tr["image_size"],
                    "neg_num": tr["neg_num"], "dataset_pkl": db_pkl,
                    "image_dir": None, "query_size": mix["query_size"],
                    "pool_size": mix["pool_size"],
                    "loader": lambda path: pixels[os.path.basename(path)]},
                "loader": {"batch_size": tr["batch_size"]}}},
            default_criterion=criterion,
            net_defaults=network.network_params.runtime["data"])
        dataset = iteration.data_loader.dataset
        recorder = Recorder()
        printed = io.StringIO()
        by_name = dict(network.model.named_parameters())

        def epoch(k, watch=None):
            np.random.seed((seed + k) % 2 ** 32)
            random.seed(seed + k)
            recorder.start()
            record = recorder.epochs[-1]
            record["weights"] = _snapshot(network.model)
            record["adam"] = _adam_state(optimizer, by_name)
            with contextlib.redirect_stdout(printed):
                steps = iteration.steps(k).iterate(network, optimizer,
                                                   recorder.logger)
                for i, losses in enumerate(steps):
                    record["losses"].append(losses["total"])
                    if i == 0:  # the steps the reference follows
                        record["first"] = first_gradients(
                            optimizer, by_name, record["adam"])
                    elif i == 2:
                        record["after3"] = _snapshot(network.model)
                    if watch is not None:
                        watch(i)
            record["picks"] = (
                list(dataset.qidxs), list(dataset.pidxs),
                [list(n) for n in dataset.nidxs])
            _sync(device)

        with recorder.recording(TuplesDataset):
            epoch(0)
            if trace:  # the profiler's own start-up, outside the window
                with torch.profiler.profile():
                    torch.ones(1, device=device).add_(1)
            _sync(device)
            setup_s = time.perf_counter() - started
            note(started, "epoch 0 done")
            prof = None
            k = 1
            t0 = time.perf_counter()
            while True:
                if trace and prof is None:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    span = torch.profiler.record_function(WINDOW_SPAN)
                    prof.start()
                    span.__enter__()

                    traced = []

                    def stop(i=None):
                        if not traced and i in (TRACED_STEPS - 1, None):
                            _sync(device)
                            span.__exit__(None, None, None)
                            t = time.perf_counter()
                            prof.stop()
                            traced.append(time.perf_counter() - t)
                    epoch(k, stop)
                    stop()  # an epoch of fewer steps
                else:
                    epoch(k)
                note(started, "epoch %d done" % k)
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del network, model, optimizer, iteration, by_name, dataset
    if device.type == "cuda":
        torch.cuda.empty_cache()

    window = recorder.epochs[1:]
    n_tuples = sum(len(e["tuples"]) for e in window)
    out = {
        "end_to_end": {"tuples_per_s": n_tuples / window_s,
                       "setup_s": setup_s},
        "attempted": n_tuples,
        "peak_bytes": peak,
    }
    inputs = {"traffic": traffic, "pixels": pixels, "params0": params0,
              "ref": ref, "seed": seed, "device": device,
              "train": dict(tr, lr=tr["optimizer"]["lr"],
                            weight_decay=tr["optimizer"]["weight_decay"],
                            margin=tr["criterion"]["margin"]),
              "epochs": recorder.epochs, "limits": config["limits"]}
    out.update(training_check.judge(inputs, config["limits"]))
    note(started, "window closed %.2f s, then judged" % window_s)
    if after is not None:
        out["after"] = after(inputs)
    if trace:
        from harness import trace as bench_trace
        summary = bench_trace.summarize(prof.events(), WINDOW_SPAN)
        out["trace"] = summary
        shapes = [tuple(s["hw"]) for s in traffic["images"]]
        first = window[0]
        mined = [i for indices, _ in first["mined"] for i in indices]
        stepped = [i for t in first["tuples"][:TRACED_STEPS
                                              * tr["batch_size"]]
                   for i in tuple_images(first, t)]
        out["layer_ctx"] = {
            "workload": cell["name"], "reference": ref,
            "epochs_s": window_s - sum(traced),
            "kernels": summary["kernels"],
            "op_device_s": summary["op_device_s"],
            "busy_s": summary["busy_s"], "traced_s": summary["window_s"],
            "peak_bytes": peak,
            "traced_forward": [shapes[i] for i in mined],
            "traced_step": [shapes[i] for i in stepped],
            "window_forward": [shapes[i] for e in window
                               for indices, _ in e["mined"]
                               for i in indices],
            "window_step": [shapes[i] for e in window
                            for t in e["tuples"]
                            for i in tuple_images(e, t)],
            "mined_images": sum(len(ix) for e in window
                                for ix, _ in e["mined"]),
            "prepare_s": sum(e["prepare_s"] for e in window),
            "process_s": [s for e in window for s in e["process_s"]]}
    return out


def first_gradients(optimizer, by_name, before):
    """Each parameter's gradient as Adam got it at the step just taken,
    from the change of its first moment since ``before`` (the state the
    epoch started with); zeros where the step kept no state."""
    inner = getattr(optimizer, "optimizer", optimizer)
    out = {}
    for k, p in by_name.items():
        moment = inner.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p) if moment is None else \
            training.first_gradient(moment, before.get(k, {}).get("exp_avg"))
    return out
