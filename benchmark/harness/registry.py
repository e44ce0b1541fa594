"""Finding the benchmark's parts by name.

``BENCHMARK.json`` at the repository root lists the cells, configurations
and metrics. Everything that belongs to one of them is a file of its own
that is found by its name, so a later change adds a cell, a configuration,
a mix or a per-layer metric by adding files and entries, and edits none:

* ``configs/<config>.json``: the configuration as it is run (the entry's
  ``file``);
* ``mixes/<traffic>.json``: the traffic's parameters, naming the
  ``harness`` that runs it (``harness/<harness>.py``) and the ``generator``
  that makes its inputs (``harness/<generator>.py``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None when it finds nothing to read.
"""
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as handle:
        return json.load(handle)


class Registry:
    """The benchmark's description and the files it names, under
    ``root`` (the repository root) and ``bench_dir`` (this package)."""

    def __init__(self, root=ROOT, bench_dir=BENCH_DIR, description=None):
        self.root = root
        self.bench_dir = bench_dir
        self.description = description if description is not None \
            else load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name):
        for cell in self.description["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, name):
        for entry in self.description["configs"]:
            if entry["name"] == name:
                return load_json(os.path.join(self.root, entry["file"]))
        raise KeyError("no configuration %r in BENCHMARK.json" % name)

    def mix(self, traffic):
        return load_json(os.path.join(self.bench_dir, "mixes",
                                      traffic + ".json"))

    @staticmethod
    def harness(mix):
        return importlib.import_module("harness." + mix["harness"])

    @staticmethod
    def generator(mix):
        return importlib.import_module("harness." + mix["generator"])

    def metrics_of(self, cell, kind):
        """The cell's ``end_to_end`` or ``per_layer`` metric entries: those
        that list it under ``workloads``; a per-layer metric without the
        key goes to every cell that reports the end-to-end metric it
        moves."""
        end_to_end = [m for m in self.description["end_to_end"]
                      if cell["name"] in m.get("workloads", [cell["name"]])]
        if kind == "end_to_end":
            return end_to_end
        moved = {m["name"] for m in end_to_end}
        return [m for m in self.description["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric_name):
        """The ``read`` function of ``metrics/<metric_name>.py``."""
        path = os.path.join(self.bench_dir, "metrics", metric_name + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
