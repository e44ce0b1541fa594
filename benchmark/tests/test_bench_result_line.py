"""A whole run of each cell at a CPU size, the look for a card skipped:
the result line's keys, and ``run.py``'s refusals."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from harness import runner
from harness.registry import BENCH_DIR, ROOT, Registry

CELLS = [c["name"] for c in Registry().description["workloads"]]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_registry, cell, trace):
    line = runner.execute(tiny_registry, cell, 2 ** 33 + 5, 0.2, trace,
                          torch.device("cpu"), time.perf_counter())
    keys = list(line)
    assert keys[:5] == REQUIRED and keys[-1] == "compare"
    assert set(keys) == set(REQUIRED + ["compare"]
                            + (["breakdown"] if trace else []))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    entry = tiny_registry.workload(cell)
    kind = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in tiny_registry.metrics_of(entry, kind)}
    assert set(line["metrics"]) <= wanted
    if not trace:
        assert set(line["metrics"]) == wanted
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for compared in line["compare"].values():
        assert set(compared) == {"value", "limit"}
    json.dumps(line)
    assert runner.forbidden_modules() == []


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(str(tmp_path))
    assert proc.returncode != 0 and proc.stdout == ""
