"""The port's import closure, and what ``chip_smoke.py`` does without a card.

The card's machine has torch, numpy and scipy but no JAX and no PIL, cv2,
yaml or msgpack. A subprocess with those modules blocked imports every module
of ``mdir_tpu_torch`` and ``chip_smoke`` itself.
"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "mdir_tpu", "cv2", "PIL", "yaml",
           "msgpack")

IMPORT_ALL = """
import importlib, pkgutil, sys
for name in %r:
    sys.modules[name] = None  # any import of it raises ImportError
import mdir_tpu_torch
for module in pkgutil.walk_packages(mdir_tpu_torch.__path__,
                                    "mdir_tpu_torch."):
    importlib.import_module(module.name)
import chip_smoke
loaded = sorted(name for name in sys.modules
                if name.split(".")[0] in %r and sys.modules[name] is not None)
assert not loaded, loaded
print("imported", len([m for m in sys.modules
                       if m.startswith("mdir_tpu_torch")]))
""" % (BLOCKED, BLOCKED)


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_without_jax_pil_yaml_msgpack():
    result = _run(["-c", IMPORT_ALL], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert int(result.stdout.split()[-1]) >= 25, result.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke runs there")
    result = _run(["chip_smoke.py"], ROOT)
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
    assert "no CUDA device" in result.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    result = _run(["chip_smoke.py"], str(tmp_path))
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
    assert os.listdir(tmp_path) == ["chip_smoke.py"]


def test_kernel_times_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs there")
    result = _run(["kernel_times.py"], ROOT)
    assert result.returncode != 0
    assert "no CUDA device" in result.stderr


RUN_CHAIN = """
import sys
for name in %r:
    sys.modules[name] = None
import numpy as np, torch
from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.ops import clahe, colorspace, lab_trilinear, preprocess
from mdir_tpu_torch.parallel import extract
chain = preprocess.chain_from_transform(initialize_transforms(
    "pil2np | apply_clahe | totensor | normalize", [[0.5] * 3, [0.5] * 3]))
batch = torch.from_numpy(np.random.RandomState(0).randint(
    0, 256, (1, 16, 24, 3)).astype(np.uint8))
aux = clahe.aux_to_device(clahe.clahe_bucket_aux([(13, 21)], (16, 24)),
                          "cpu")
out = preprocess.make_bucketed_chain(chain)(batch, aux)
print(tuple(out.shape), bool(torch.isfinite(out).all()))
""" % (BLOCKED,)


def test_clahe_chain_runs_without_jax_cv2_pil():
    """The lab CLAHE chain's modules (with their own node table) import and
    run on the CPU with JAX, the JAX package, cv2 and PIL blocked."""
    result = _run(["-c", RUN_CHAIN], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "(1, 16, 24, 3) True"
