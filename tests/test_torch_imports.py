"""The port's import closure, and what ``chip_smoke.py`` does without a card.

The card's machine has torch, numpy and scipy but no JAX and no PIL, cv2,
yaml or msgpack. A subprocess with those modules blocked imports every module
of ``mdir_tpu_torch`` and ``chip_smoke`` itself, runs the lab CLAHE chain,
and trains (and resumes) a small net on in-memory images as the smoke does.
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
trained = {"mdir_tpu_torch.stages.train", "mdir_tpu_torch.learning.learning",
           "mdir_tpu_torch.learning.training",
           "mdir_tpu_torch.learning.epoch_iteration",
           "mdir_tpu_torch.learning.train_step",
           "mdir_tpu_torch.learning.resume",
           "mdir_tpu_torch.optim.criteria", "mdir_tpu_torch.optim.optimizers",
           "mdir_tpu_torch.optim.schedulers", "mdir_tpu_torch.data.datasets",
           "mdir_tpu_torch.data.loaders", "mdir_tpu_torch.tools.stats",
           "mdir_tpu_torch.models.weight_init"}
assert trained <= set(sys.modules), trained - set(sys.modules)
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
    assert int(result.stdout.split()[-1]) >= 38, result.stdout


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


def test_train_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the stage runs there")
    from mdir_tpu_torch.stages.train import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train({}, (), device="cuda")


RUN_TRAIN = """
import sys
for name in %r:
    sys.modules[name] = None
import os, pickle, tempfile
import numpy as np
from mdir_tpu_torch.stages.train import train

rng = np.random.RandomState(0)
IMAGES = {"im%%d" %% i: rng.randint(0, 256, (40 + i %% 3 * 8, 48, 3)).astype(
    np.uint8) for i in range(8)}


def load(path):
    return IMAGES[os.path.basename(path)]


root = tempfile.mkdtemp()
db = os.path.join(root, "db.pkl")
with open(db, "wb") as handle:
    pickle.dump({"train": {"cids": ["/x/im%%d" %% i for i in range(8)],
                           "cluster": [i // 2 for i in range(8)],
                           "qidxs": [0, 2], "pidxs": [1, 3]}}, handle)
mean_std = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
chain = "pil2np | apply_clahe:4:lab:8 | totensor | normalize"


def scenario(epochs):
    model = {"architecture": "cirnet", "cir_architecture": "alexnet",
             "local_whitening": False, "pooling": "gem", "regional": False,
             "whitening": False, "pretrained": False}
    return {
        "network": {"type": "CirNetwork", "path": None, "model": model,
                    "initialize": {"weights": "default", "seed": 0},
                    "runtime": {"wrappers": {"train": "cirfaketuplebatch",
                                             "eval": ""},
                                "data": {"mean_std": mean_std,
                                         "transforms": chain}}},
        "learning": {"type": "TrainValLearning",
                     "checkpoints": {"directory": root, "store_every": 0,
                                     "checkpoint_every": 1},
                     "training": {
                         "type": "EpochTraining", "epochs": epochs,
                         "deterministic": True, "seed": 0,
                         "criterion": {"loss": "contrastive", "margin": 0.7,
                                       "eps": 1e-6},
                         "optimizer": {"algorithm": "adam", "lr": 1e-6,
                                       "weight_decay": 1e-6},
                         "scheduler": {"algorithm": "gamma",
                                       "gamma": "exp(-0.01)"},
                         "epoch_iteration": {
                             "type": "SupervisedEpoch", "data": "train",
                             "criterion": "default", "batch_average": False,
                             "fakebatch": True}},
                     "validation": False},
        "output": {"learning": {"progress": {"print_each": 0}}},
        "data": {"train": {"mean_std": mean_std, "transforms": chain,
                           "dataset": {"name": "CirTuples",
                                       "dataset": "retrieval-SfM-mem",
                                       "split": "train", "image_size": 64,
                                       "neg_num": 2, "dataset_pkl": db,
                                       "image_dir": None, "query_size": 2,
                                       "pool_size": 8, "loader": load},
                           "loader": {"batch_size": 2}}}}


train(scenario(1), (), device="cpu")
meta, = train(scenario(2), (), device="cpu")
losses = meta["metrics"]["train/learning/loss:total_avg.4"]
assert len(losses) == 2 and all(np.isfinite(losses)), losses
print("trained", len(losses))
""" % (BLOCKED,)


def test_train_stage_runs_without_jax_cv2_pil():
    """The train stage with the lab CLAHE chain, images from an in-memory
    loader, and its resume, with JAX, the JAX package, cv2, PIL, yaml and
    msgpack blocked."""
    result = _run(["-c", RUN_TRAIN], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "trained 2"
