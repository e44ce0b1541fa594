"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

They put the benchmark's directory and the repository root on the path, and
give a registry of the real files whose configurations and mixes are cut
to a size the CPU runs in seconds (a narrow VGG16, a one-block-a-stage
ResNet101, images of 64 pixels), the port's trunk tables patched to
match."""
import copy
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

NARROW_VGG = [8, "M", 16, "M", 32, "M"]
SHORT_RESNET = [1, 1, 1, 1]


def shrink_config(config):
    config = copy.deepcopy(config)
    config["eval"]["image_size"] = 64
    if "train" in config:
        config["train"]["image_size"] = 64
    config["reference"]["trunk_cfg"] = NARROW_VGG \
        if config["reference"]["trunk"] == "vgg" else SHORT_RESNET
    return config


def shrink_mix(mix):
    mix = copy.deepcopy(mix)
    mix["database"]["shapes"] = [[48, 64, 5], [64, 48, 3]]
    mix["queries"].update(count=3, source_side=64, longer_side=64)
    mix["templates"] = 3
    mix["margin"] = 8
    mix["check"] = {"sample_db": 8, "sample_queries": 3}
    return mix


@pytest.fixture
def tiny_registry(monkeypatch):
    """The benchmark's registry at a CPU size."""
    from harness.registry import Registry
    from mdir_tpu_torch.models import trunks

    monkeypatch.setitem(trunks.VGG_CFGS, "vgg16", NARROW_VGG)
    monkeypatch.setitem(trunks.OUTPUT_DIM, "vgg16", 32)
    monkeypatch.setitem(trunks.RESNET_LAYERS, "resnet101",
                        (trunks.Bottleneck, tuple(SHORT_RESNET)))
    registry = Registry()
    monkeypatch.setattr(registry, "config", lambda name: shrink_config(
        Registry.config(registry, name)))
    monkeypatch.setattr(registry, "mix", lambda name: (
        shrink_train_mix if name == "train" else shrink_mix)(
            Registry.mix(registry, name)))
    return registry


def shrink_train_mix(mix):
    mix = copy.deepcopy(mix)
    mix.update(clusters=12, views=3, margin=8, query_size=15, pool_size=24)
    mix["shapes"] = [[48, 64, 20], [64, 48, 10], [40, 64, 6]]
    mix["check"] = {"sample_mine": 4}
    return mix
