"""The port's profiling hooks (``tools/profiling.py``) against the JAX
package's (``mdir_tpu/tools/profiling.py``): ``trace`` of a small CPU
extraction writes a Chrome trace that holds its operations; ``timed``
prints JAX's line, the same regex matching both; a device memory profile
has no CPU counterpart and raises; ``device="cuda"`` without a card
raises, as every entry point of the port does."""
import json
import os
import re

import numpy as np
import pytest

import torch

from mdir_tpu.tools import profiling as jax_profiling

from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.parallel.extract import extract_vectors_batched
from mdir_tpu_torch.tools import profiling

TIMED_LINE = re.compile(r"^\[block\] \d+\.\d{3}s$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trace_of_a_cpu_extraction_writes_a_file(tmp_path):
    model = initialize_model({
        "architecture": "cirnet", "cir_architecture": "alexnet",
        "local_whitening": False, "pooling": "gem", "regional": False,
        "whitening": False, "pretrained": False}, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    arrays = [(rng.rand(70, 90, 3) * 255).astype(np.uint8),
              (rng.rand(64, 60, 3) * 255).astype(np.uint8)]
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, device="cpu") as prof:
        vecs = extract_vectors_batched(
            model, arrays, normalize_mean_std=([0.5] * 3, [0.5] * 3))
    assert vecs.shape == (256, 2) and np.isfinite(vecs).all()
    assert os.listdir(log_dir) == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as handle:
        events = json.load(handle)["traceEvents"]
    names = {event.get("name") for event in events}
    assert "aten::conv2d" in names
    assert any(row.key == "aten::conv2d" and row.count > 0
               for row in prof.key_averages())


def test_timed_prints_the_jax_line(capsys):
    lines = []
    for package in (jax_profiling, profiling):
        kwargs = {} if package is jax_profiling else {"device": "cpu"}
        with package.timed("block", **kwargs):
            np.ones((4,)).sum()
        with package.timed("block", sink=lines.append, **kwargs):
            pass
        lines.append(capsys.readouterr().out.rstrip("\n"))
    assert len(lines) == 4
    for line in lines:
        assert TIMED_LINE.match(line), line


def test_device_memory_profile_has_no_cpu_counterpart(tmp_path):
    with pytest.raises(ValueError, match="cpu"):
        profiling.device_memory_profile(device="cpu")
    with pytest.raises(ValueError, match="cpu"):
        profiling.device_memory_profile(str(tmp_path / "mem"), device="cpu")
    assert not os.path.exists(tmp_path / "mem")


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: profiling.device_memory_profile(),
                 lambda: profiling.trace("unused").__enter__(),
                 lambda: profiling.timed("block").__enter__()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
