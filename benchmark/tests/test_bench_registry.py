"""Configurations, mixes and metrics are found by name, new files too, and
BENCHMARK.json keeps to the shape its readers expect."""
import json
import os
import re

import pytest

from harness.registry import BENCH_DIR, ROOT, Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_named_file_is_found():
    registry = Registry()
    desc = registry.description
    for cell in desc["workloads"]:
        config = registry.config(cell["config"])
        assert config["name"] == cell["config"]
        mix = registry.mix(cell["traffic"])
        assert registry.harness(mix).run
        assert registry.generator(mix).generate
        assert registry.metrics_of(cell, "per_layer")
        names = {m["name"] for m in registry.metrics_of(cell, "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
    for metric in desc["per_layer"]:
        assert callable(registry.reader(metric["name"]))


def test_description_shape():
    desc = Registry().description
    assert set(desc) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in desc[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for config in desc["configs"]:
        assert config["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, config["file"])) as handle:
            data = json.load(handle)
        assert data["reduced"] == config["reduced"]
    for metric in desc["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
    layers = {m["layer"] for m in desc["per_layer"]}
    assert all(layer.strip() == layer and "\n" not in layer
               for layer in layers)


def _tmp_registry(tmp_path):
    """A registry over a copy of the description, a new configuration, a
    new mix and a new metric, all in a temporary directory."""
    registry = Registry()
    desc = json.loads(json.dumps(registry.description))
    bench = tmp_path / "bench"
    (bench / "mixes").mkdir(parents=True)
    (bench / "metrics").mkdir()
    (bench / "configs").mkdir()
    config = registry.config("resnet101-gem")
    config["name"] = "resnet50-gem"
    config["model"]["cir_architecture"] = "resnet50"
    (bench / "configs" / "resnet50-gem.json").write_text(json.dumps(config))
    mix = registry.mix("eval-db")
    mix["templates"] = 4
    (bench / "mixes" / "eval-few.json").write_text(json.dumps(mix))
    (bench / "metrics" / "images_seen.eval.py").write_text(
        "def read(ctx):\n    return float(len(ctx['shapes']))\n")
    desc["configs"].append({"name": "resnet50-gem", "source": "x",
                            "file": "bench/configs/resnet50-gem.json",
                            "reduced": [], "why": "a test"})
    desc["workloads"].append({"name": "resnet50-gem.eval-few",
                              "config": "resnet50-gem",
                              "traffic": "eval-few", "chips": 1,
                              "why": "a test"})
    desc["end_to_end"][0]["workloads"].append("resnet50-gem.eval-few")
    desc["per_layer"].append({"name": "images_seen.eval", "unit": "images",
                              "better": "higher", "source": "host_clock",
                              "layer": "whole pass", "moves": "images_per_s"})
    return Registry(root=str(tmp_path), bench_dir=str(bench),
                    description=desc)


def test_new_files_are_found_by_name(tmp_path):
    registry = _tmp_registry(tmp_path)
    cell = registry.workload("resnet50-gem.eval-few")
    assert registry.config(cell["config"])["model"]["cir_architecture"] \
        == "resnet50"
    assert registry.mix(cell["traffic"])["templates"] == 4
    per_layer = [m["name"] for m in registry.metrics_of(cell, "per_layer")]
    # a metric without ``workloads`` goes to every cell of what it moves
    assert per_layer == ["images_seen.eval"]
    old = registry.workload("vgg16-gem-clahe.eval-db")
    assert "images_seen.eval" in [m["name"] for m in
                                  registry.metrics_of(old, "per_layer")]
    assert registry.reader("images_seen.eval")({"shapes": [1, 2]}) == 2.0


def test_unknown_names_raise():
    registry = Registry()
    with pytest.raises(KeyError):
        registry.workload("no-such.cell")
    with pytest.raises(KeyError):
        registry.config("no-such-config")
    assert os.path.isdir(os.path.join(BENCH_DIR, "metrics"))
