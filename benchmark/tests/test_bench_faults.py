"""The comparison that decides ``correct`` fails on each fault the cells
can have, planted under the timed path (for training also from the window
on alone), and on the control: the reference in bfloat16 put in the
program's place and judged by the same limits. At a CPU size."""
import time

import pytest
import torch

from harness import faults
from harness.registry import Registry

CELLS = [c["name"] for c in Registry().description["workloads"]]


def run(registry, cell, fault=None, after=None, seed=2 ** 32 + 3):
    entry = registry.workload(cell)
    config = registry.config(entry["config"])
    mix = registry.mix(entry["traffic"])
    loop = registry.harness(mix)

    def go():
        return loop.run(entry, config, mix, seed, 0.0, False,
                        torch.device("cpu"), time.perf_counter(),
                        after=after)
    if fault is None:
        return go()
    with faults.FAULTS[mix["harness"]][fault]():
        return go()


def _harness(cell):
    registry = Registry()
    return registry.mix(registry.workload(cell)["traffic"])["harness"]


CELL_FAULTS = [(cell, fault) for cell in CELLS
               for fault in sorted(faults.FAULTS[_harness(cell)])]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_fault_is_not_correct(tiny_registry, cell, fault):
    out = run(tiny_registry, cell, fault)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_registry, cell):
    out = run(tiny_registry, cell)
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(tiny_registry, cell):
    entry = tiny_registry.workload(cell)
    loop = tiny_registry.harness(tiny_registry.mix(entry["traffic"]))
    out = run(tiny_registry, cell, after=loop.control)
    assert out["correct"] is True
    assert out["after"]["correct"] is False and out["after"]["failed"] > 0
