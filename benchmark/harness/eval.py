"""The eval harness: whole passes of the validate stage's score.

Set-up builds the port's kernels (in the checkout's ``build/``), draws the
trunk's weights, GeM's p and the learned whitening from the seed on the
device, builds the port's ``CirNetwork`` in place on the device and loads
them, makes the mix's images on the device and keeps them on the host,
where the score's ``loader`` serves them from memory, writes the datasets'
tsv files and the whitening pkl to a temporary directory, and runs one
untimed pass, which warms every shape the cell uses.

A pass is one call of ``optim/scores.py::CirDatasetAp``: the database
extracted, the queries extracted (cropped to their boxes), ranked and
scored. The window starts passes until the first that ends after
``seconds``; ``images_per_s`` is every image of those passes over their
whole wall time. With ``trace`` the first pass of the window runs under
``torch.profiler`` inside the span ``bench.window``, and the per-layer
readers get the passes' own time (``passes_s``), without the profiler's
start and its collection of the trace.

What the window's passes produced (the descriptors, the ranks, the mAP) is
recorded from the score's calls and judged once the window has closed,
the peak memory has been read and the program's state is freed
(``retrieval_check``).
"""
import contextlib
import io
import json
import math
import os
import pickle
import sys
import tempfile
import time
from unittest import mock

import torch

from harness import images as bench_images
from harness import retrieval_check
from harness.registry import Registry
from reference import nets

WINDOW_SPAN = "bench.window"
control = retrieval_check.control  # the control of these cells


def reference_config(config):
    """The configuration's ``reference`` section with the eval's scales
    and the normalisation."""
    ev = config["eval"]
    return dict(config["reference"], scales=ev["scales"],
                mean=ev["mean_std"][0], std=ev["mean_std"][1])


def draw_whitening(dim, generator, device):
    """A seeded learned whitening: P near the identity, m small."""
    z = torch.randn((dim + 1, dim), generator=generator, device=device)
    P = torch.eye(dim, device=device) + (0.5 / math.sqrt(dim)) * z[:dim]
    m = (0.05 / math.sqrt(dim)) * z[dim]
    return P, m


def _write_tsvs(directory, traffic):
    db = os.path.join(directory, "db.tsv")
    with open(db, "w") as handle:
        handle.write("identifier\n")
        for spec in traffic["database"]:
            handle.write(spec["name"] + "\n")
    queries = os.path.join(directory, "queries.tsv")
    names = [spec["name"] for spec in traffic["database"]]
    with open(queries, "w") as handle:
        handle.write("query\tbbx\tok\tjunk\n")
        for spec, gnd in zip(traffic["queries"], traffic["gnd"]):
            handle.write("%s\t%s\t%s\t%s\n" % (
                spec["name"], json.dumps(list(spec["bbx"])),
                json.dumps([names[i] for i in gnd["ok"]]),
                json.dumps([names[i] for i in gnd["junk"]])))
    return db, queries


class Recorder:
    """What the score's calls return, pass by pass, each call inside a
    span of its own."""

    def __init__(self, scores):
        self.scores = scores
        self.passes = []

    def _wrap(self, name, fn, key):
        def call(*args, **kwargs):
            with torch.profiler.record_function("bench." + name):
                out = fn(*args, **kwargs)
            self.passes[-1][key].append(out)
            return out
        return call

    @contextlib.contextmanager
    def recording(self):
        s = self.scores
        with mock.patch.object(s, "extract_vectors_network", self._wrap(
                "extract", s.extract_vectors_network, "vecs")), \
                mock.patch.object(s, "rank_database", self._wrap(
                    "rank", s.rank_database, "ranks")), \
                mock.patch.object(s, "compute_map_and_print", self._wrap(
                    "map", s.compute_map_and_print, "map")):
            yield

    def start_pass(self):
        self.passes.append({"vecs": [], "ranks": [], "map": []})

    def results(self):
        """Per pass: database and query descriptors, ranks (numpy), mAP."""
        out = []
        for rec in self.passes:
            vecs = rec["vecs"][0]
            qvecs = rec["vecs"][1] if len(rec["vecs"]) > 1 else vecs
            out.append({"vecs": vecs, "qvecs": qvecs,
                        "ranks": rec["ranks"][0].cpu().numpy(),
                        "map": rec["map"][0][0]["map"]})
        return out


def note(started, what):
    """A set-up phase's end, in seconds since the process started."""
    sys.stderr.write("[bench] %s at %.2f s\n" % (what,
                                                  time.perf_counter() - started))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def served_shapes(traffic):
    """(h, w) of every image of a pass as the score serves it."""
    shapes = [tuple(spec["hw"]) for spec in traffic["database"]]
    for spec in traffic["queries"]:
        x0, y0, x1, y1 = spec["bbx"]
        shapes.append((y1 - y0, x1 - x0))
    return shapes


def run(cell, config, mix, seed, seconds, trace, device, started,
        warmup=True, after=None):
    """One run of an eval cell; returns the run's result dict.
    ``warmup`` False leaves out the untimed pass; ``after(inputs)``, if
    given, is called with the run's inputs once the run is judged and its
    result goes under ``"after"``."""
    from mdir_tpu_torch import _build
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.optim import scores

    note(started, "imports")
    if device.type == "cuda":
        _build.build(_build.sources())
    note(started, "kernels built")
    generator = torch.Generator(device=device).manual_seed(seed)
    ref = dict(reference_config(config), **mix["check"])
    params = nets.draw_params(ref["trunk"], ref["trunk_cfg"], generator,
                              device, ref["gem_p"])
    dim = nets.out_channels(ref["trunk"], ref["trunk_cfg"])
    P, m = draw_whitening(dim, generator, device)
    traffic = Registry.generator(mix).generate(mix, seed)
    colour = bench_images.fields(traffic["templates"], traffic["field"],
                                 generator, device)
    pixels = bench_images.render(traffic["database"] + traffic["queries"],
                                 colour, traffic["noise"], generator)
    del colour
    with torch.device(device):
        model = initialize_model(config["model"], device=device, seed=None)
    model.load_state_dict(params, strict=True)
    note(started, "weights, images and the net made")

    ev = config["eval"]
    with tempfile.TemporaryDirectory() as tmp:
        whiten = os.path.join(tmp, "whiten.pkl")
        with open(whiten, "wb") as handle:
            pickle.dump({"P": P.double().cpu().numpy(),
                         "m": m.double().cpu().numpy()[:, None]}, handle)
        runtime = dict(config["runtime"], wrappers={"train": None, "eval": {
            "0_cirwhiten": {"whitening": whiten, "dimensions": None},
            "1_cirmultiscale": {"scales": ev["scales"]}}})
        network = CirNetwork(model, CirNetwork.NetworkParams(
            model=dict(config["model"]), runtime=runtime), frozen=True)
        db_tsv, q_tsv = _write_tsvs(tmp, traffic)
        imgdir = os.path.join(tmp, "images")
        score = scores.initialize_score({
            "type": "cirdatasetap", "image_size": ev["image_size"],
            "dataset": {"name": cell["name"], "db": db_tsv,
                        "queries": q_tsv, "imgdir": imgdir},
            "transforms": ev["transforms"], "mean_std": ev["mean_std"],
            "loader": lambda path: pixels[os.path.basename(path)]})
        recorder = Recorder(scores)
        printed = io.StringIO()

        def one_pass():
            recorder.start_pass()
            with contextlib.redirect_stdout(printed):
                score(network.eval())
            _sync(device)

        with recorder.recording():
            if warmup:
                one_pass()  # warms every shape of the cell
            if trace:  # the profiler's own start-up, outside the window
                with torch.profiler.profile():
                    torch.ones(1, device=device).add_(1)
            recorder.passes.clear()
            _sync(device)
            setup_s = time.perf_counter() - started
            note(started, "warm-up pass done")
            prof = None
            passes_s = 0.0  # the passes' own time, without the profiler's
            t0 = time.perf_counter()
            while True:
                if trace and prof is None:
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        with torch.profiler.record_function(WINDOW_SPAN):
                            t = time.perf_counter()
                            one_pass()
                            passes_s += time.perf_counter() - t
                else:
                    t = time.perf_counter()
                    one_pass()
                    passes_s += time.perf_counter() - t
                note(started, "pass %d done" % len(recorder.passes))
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    results = recorder.results()
    del network, model, score, recorder
    if device.type == "cuda":
        torch.cuda.empty_cache()

    shapes = served_shapes(traffic)
    n_images = len(shapes) * len(results)
    out = {
        "end_to_end": {"images_per_s": n_images / window_s,
                       "setup_s": setup_s},
        "attempted": n_images,
        "peak_bytes": peak,
    }
    out.update(retrieval_check.judge(results, traffic, pixels, params, P, m,
                                     ref, config["limits"], seed, device))
    note(started, "window closed %.2f s, then judged" % window_s)
    if after is not None:
        out["after"] = after({"traffic": traffic, "pixels": pixels,
                              "params": params, "P": P, "m": m, "ref": ref,
                              "seed": seed, "device": device,
                              "limits": config["limits"]})
    if trace:
        from harness import trace as bench_trace
        summary = bench_trace.summarize(prof.events(), WINDOW_SPAN)
        out["trace"] = summary
        out["layer_ctx"] = {
            "workload": cell["name"], "reference": ref, "shapes": shapes,
            "passes": len(results), "passes_s": passes_s,
            "kernels": summary["kernels"],
            "op_device_s": summary["op_device_s"],
            "busy_s": summary["busy_s"],
            "traced_s": summary["window_s"], "peak_bytes": peak}
    return out
