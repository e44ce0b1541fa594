"""The port's import closure, and what ``chip_smoke.py`` does without a card.

The card's machine has torch, numpy and scipy but no JAX and no PIL, cv2,
yaml, msgpack, tensorboardX or matplotlib. A subprocess with those modules
blocked imports every module of ``mdir_tpu_torch``, ``chip_smoke``,
``cards_check`` and ``trace_check`` (the parallel mesh and the dry run
among them), and the
parts that the whole-batch parallel tests' ranks run
(``tests/whole_batch_ranks.py``), runs the lab CLAHE chain, trains (and
resumes) a small net on in-memory images (its image samples written
without PIL), trains a U-Net translator on in-memory image pairs through
the six augmentations with loss validation, and then jointly with an
embedder, and runs a U-Net composition's extraction and the eval entry's
URL lookup, as the smoke does, and the device image cache's hand-off and
the profiling hooks on the CPU.
"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "mdir_tpu", "cv2", "PIL", "yaml",
           "msgpack", "tensorboardX", "matplotlib")

IMPORT_ALL = """
import importlib, pkgutil, sys
for name in %r:
    sys.modules[name] = None  # any import of it raises ImportError
import mdir_tpu_torch
for module in pkgutil.walk_packages(mdir_tpu_torch.__path__,
                                    "mdir_tpu_torch."):
    importlib.import_module(module.name)
import chip_smoke
import cards_check
import trace_check
sys.path.insert(0, "tests")
import whole_batch_ranks
trained = {"mdir_tpu_torch.stages.train", "mdir_tpu_torch.learning.learning",
           "mdir_tpu_torch.learning.training",
           "mdir_tpu_torch.learning.epoch_iteration",
           "mdir_tpu_torch.learning.train_step",
           "mdir_tpu_torch.learning.resume",
           "mdir_tpu_torch.optim.criteria", "mdir_tpu_torch.optim.optimizers",
           "mdir_tpu_torch.optim.schedulers", "mdir_tpu_torch.data.datasets",
           "mdir_tpu_torch.data.loaders", "mdir_tpu_torch.tools.stats",
           "mdir_tpu_torch.models.weight_init", "mdir_tpu_torch.models.unet",
           "mdir_tpu_torch.models.autoencoder", "mdir_tpu_torch.eval",
           "mdir_tpu_torch.config.overlay", "mdir_tpu_torch.models.layers",
           "mdir_tpu_torch.models.convert", "mdir_tpu_torch.ops.resize",
           "mdir_tpu_torch.learning.validation",
           "mdir_tpu_torch.learning.checkpoints",
           "mdir_tpu_torch.data.transforms", "mdir_tpu_torch.data.readers",
           "mdir_tpu_torch.models.branched", "mdir_tpu_torch.tools.events",
           "mdir_tpu_torch.tools.htmlreport", "mdir_tpu_torch.tools.plots",
           "mdir_tpu_torch.tools.sysstats", "mdir_tpu_torch.tools.warmup"}
assert trained <= set(sys.modules), trained - set(sys.modules)
parallel = {"mdir_tpu_torch.parallel.mesh", "mdir_tpu_torch.dryrun",
            "mdir_tpu_torch.parallel.device_cache",
            "mdir_tpu_torch.tools.profiling"}
assert parallel <= set(sys.modules), parallel - set(sys.modules)
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


# the environment variables the port reads: the data root (the JAX
# package's, and cirtorch's), the CUDA toolkit's home and torchrun's local
# rank; none other of the port's own
ENVIRONMENT = {"MDIR_TPU_ROOT", "CIRTORCH_ROOT", "CUDA_HOME", "LOCAL_RANK"}
READERS = {"tools/utils.py", "_build.py", "parallel/mesh.py"}


def test_port_reads_no_environment_variable_of_its_own():
    """Only three modules read the environment, and the variable names
    that appear in the port are ENVIRONMENT's (no ``MDIR_*`` switch but
    the data root)."""
    import ast
    import re

    package = os.path.join(ROOT, "mdir_tpu_torch")
    names, readers = set(), set()
    for base, _, files in os.walk(package):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            with open(path) as handle:
                tree = ast.parse(handle.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) \
                        and node.attr in ("environ", "getenv", "putenv"):
                    readers.add(os.path.relpath(path, package))
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) and re.fullmatch(
                            r"[A-Z][A-Z0-9]*(_[A-Z0-9]+)+", node.value):
                    names.add(node.value)
    assert readers <= READERS, readers - READERS
    assert names == ENVIRONMENT, names ^ ENVIRONMENT


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


def test_cards_check_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs there")
    result = _run(["cards_check.py"], ROOT)
    assert result.returncode != 0
    assert "no CUDA device" in result.stderr


def test_trace_check_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs there")
    result = _run(["trace_check.py"], ROOT)
    assert result.returncode != 0
    assert "no CUDA device" in result.stderr


RUN_CACHE = """
import sys
for name in %r:
    sys.modules[name] = None
import os, tempfile
import numpy as np, torch
from mdir_tpu_torch.parallel.device_cache import (CachedImageRef, assemble,
                                                  shared_cache)
from mdir_tpu_torch.tools.profiling import device_memory_profile, timed, trace

cache = shared_cache("cpu", 1)
assert cache is shared_cache("cpu", 0.5) and cache.budget_bytes == 10 ** 6
img = np.random.RandomState(0).randint(0, 256, (40, 50, 3)).astype(np.uint8)
padded = np.zeros((64, 64, 3), np.uint8)
padded[:40, :50] = img
entry = cache.put("a@64", padded, (40, 50))
bucket, valid, miss = assemble([CachedImageRef("a@64", (40, 50), entry), img])
assert torch.equal(bucket[0], bucket[1]) and miss == 64 * 64 * 3, miss
with trace(tempfile.mkdtemp(), device="cpu") as prof:
    (torch.ones(4) * 2).sum()
assert os.path.getsize(prof.trace_path) > 0
with timed("block", device="cpu"):
    pass
try:
    device_memory_profile(device="cpu")
except ValueError:
    pass
else:
    raise AssertionError("a CPU memory profile")
print("cached", cache.stats()["entries"])
""" % (BLOCKED,)


def test_device_cache_and_profiling_run_without_jax_cv2_pil():
    """The device image cache's assembly and the torch.profiler hooks on
    the CPU with JAX, the JAX package, cv2 and PIL blocked."""
    result = _run(["-c", RUN_CACHE], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "cached 1"


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
# the first step's image samples, written without PIL
blobs = os.listdir(os.path.join(root, "epochs", "blobs"))
assert "train_data_input:image0.rgb:0:0.png" in blobs, blobs
print("trained", len(losses))
""" % (BLOCKED,)


def test_train_stage_runs_without_jax_cv2_pil():
    """The train stage with the lab CLAHE chain, images from an in-memory
    loader, and its resume, with JAX, the JAX package, cv2, PIL, yaml and
    msgpack blocked."""
    result = _run(["-c", RUN_TRAIN], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "trained 2"


RUN_IMAGE_TRAIN = """
import sys
for name in %r:
    sys.modules[name] = None
import copy, json, os, pickle, tempfile
import numpy as np
import torch
from mdir_tpu_torch.stages.train import train

torch.set_num_threads(1)  # small nets, beside the other test workers

rng = np.random.RandomState(0)
IMAGES = {"im%%d" %% i: rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
          for i in range(8)}


def load(path):
    return IMAGES[os.path.basename(path)]


root = tempfile.mkdtemp()
with open(os.path.join(root, "pairs.tsv"), "w") as handle:
    handle.write("pair\\n")
    for i in range(0, 8, 2):
        handle.write(json.dumps(["im%%d" %% i, "im%%d" %% (i + 1)]) + "\\n")
with open(os.path.join(root, "db.pkl"), "wb") as handle:
    pickle.dump({"train": {"cids": ["/x/im%%d" %% i for i in range(8)],
                           "cluster": [i // 2 for i in range(8)],
                           "qidxs": [0, 2], "pidxs": [1, 3]}}, handle)
ms = [[0.5] * 3, [0.5] * 3]
augment = ("pil2np | downscale:36 | scalecrop:32_32:0.9_1 | mirror | "
           "random_crop:32 | gaussian_noise:0.02 | totensor | normalize")
unet = {"architecture": "p2p_unet", "in_channels": 3, "out_channels": 3,
        "nested_levels": 1, "dropout": 0.5}


def pairs(transforms, label):
    return {"mean_std": ms, "transforms": transforms,
            "dataset": {"name": label,
                        "dataset": os.path.join(root, "pairs.tsv"),
                        "data_key": "pair", "image_dir": "/x", "idx": "0_1",
                        "loader": load}, "loader": {"batch_size": 2}}


def scenario(directory, epochs, network, optimizer, validation, data):
    network, optimizer = copy.deepcopy((network, optimizer))
    return {"network": network,
            "learning": {"type": "TrainValLearning",
                         "checkpoints": {"directory": directory,
                                         "store_every": 0,
                                         "checkpoint_every": 1},
                         "training": {"type": "EpochTraining",
                                      "epochs": epochs, "deterministic": True,
                                      "seed": 0, "criterion": data.pop("loss"),
                                      "optimizer": optimizer,
                                      "scheduler": None,
                                      "epoch_iteration": {
                                          "type": "SupervisedEpoch",
                                          "data": "train",
                                          "criterion": "default",
                                          "batch_average": True,
                                          "fakebatch": False}},
                         "validation": validation},
            "output": {"learning": {"progress": {"print_each": 0}}},
            "data": data}


translator = {"type": "SingleNetwork", "path": None, "model": unet,
              "initialize": {"weights": "normal_p2p", "seed": 0},
              "runtime": {"wrappers": "", "data": {"mean_std": ms}}}
adam = {"algorithm": "adam", "lr": 1e-3, "weight_decay": 0}
meta, = train(scenario(os.path.join(root, "unet"), 2, translator, adam,
                       {"type": "SingleValidation", "data": "val",
                        "criterion": "default", "network_overlay": None,
                        "frequency": 1},
                       {"loss": {"loss": "l1"},
                        "train": pairs(augment, "RandomImageTuple"),
                        "val": pairs("pil2np | center_crop:32 | totensor | "
                                     "normalize", "PregeneratedImageTuple")}),
              (), device="cpu")
val = meta["metrics"]["val/learning/loss:total_avg.4"]
assert len(val) == 2 and all(np.isfinite(val)), val
embed = {"type": "CirNetwork", "path": None,
         "model": {"architecture": "cirnet", "cir_architecture": "alexnet",
                   "local_whitening": False, "pooling": "gem",
                   "regional": False, "whitening": False,
                   "pretrained": False},
         "initialize": {"weights": "default", "seed": 0},
         "runtime": {"wrappers": {"train": "cirfaketuplebatch",
                                  "eval": ""}}}
joint = {"type": "SequentialNetwork", "sequence": "translate,embed",
         "translate": dict(translator, model=dict(unet, dropout=0.0)),
         "embed": embed}
optimizer = {"composition": {"type": "alternation",
                             "alternate_iteration": None, "order": None},
             "translate": adam, "embed": None}
tuples = {"mean_std": ms, "transforms": "pil2np | totensor | normalize",
          "dataset": {"name": "CirTuples", "dataset": "retrieval-SfM-mem",
                      "split": "train", "image_size": 48, "neg_num": 1,
                      "dataset_pkl": os.path.join(root, "db.pkl"),
                      "image_dir": None, "query_size": 2, "pool_size": 8,
                      "loader": load}, "loader": {"batch_size": 2}}
for epochs in (1, 2):
    meta, = train(scenario(os.path.join(root, "joint"), epochs,
                           joint, optimizer, False,
                           {"loss": {"loss": "contrastive"},
                            "train": tuples}), (), device="cpu")
losses = meta["metrics"]["train/learning/loss:total_avg.4"]
assert len(losses) == 2 and all(np.isfinite(losses)), losses
print("trained", len(val), len(losses))
""" % (BLOCKED,)


def test_image_training_runs_without_jax_cv2_pil():
    """The translator's L1 training through the six augmentations with loss
    validation, and the joint training of a composition resumed from its
    multi-network checkpoint, on in-memory images with JAX, the JAX
    package, cv2, PIL, yaml and msgpack blocked."""
    result = _run(["-c", RUN_IMAGE_TRAIN], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "trained 2 2"


RUN_COMPOSITION = """
import sys
for name in %r:
    sys.modules[name] = None
import hashlib, os, tempfile
import numpy as np
from mdir_tpu_torch import eval as entry
from mdir_tpu_torch.config.overlay import load_scenario
from mdir_tpu_torch.learning.network import SequentialNetwork
from mdir_tpu_torch.parallel.extract import ComposedExtractor

mean_std = [[0.5] * 3, [0.5] * 3]
network = SequentialNetwork.initialize({
    "sequence": "translate,embed",
    "translate": {"type": "SingleNetwork", "initialize": None,
                  "model": {"architecture": "p2p_unet", "in_channels": 3,
                            "out_channels": 3, "nested_levels": 1},
                  "runtime": {"wrappers": "reflectpad_divisible:8",
                              "data": {"mean_std": mean_std}}},
    "embed": {"type": "CirNetwork", "initialize": None,
              "model": {"architecture": "cirnet",
                        "cir_architecture": "alexnet",
                        "local_whitening": False, "pooling": "gem",
                        "regional": False, "whitening": False,
                        "pretrained": False},
              "runtime": {"wrappers": {"train": None, "eval": {
                  "0_cirmultiscale": {"scales": True}}}}}},
    device="cpu").eval()
extractor = ComposedExtractor(network, mean_std)
rng = np.random.RandomState(0)
for i, shape in enumerate([(70, 66), (64, 90)]):
    extractor.add(i, rng.randint(0, 256, shape + (3,)).astype(np.uint8))
vecs = extractor.finish(2)
assert vecs.shape == (256, 2) and np.isfinite(vecs).all(), vecs.shape

root = tempfile.mkdtemp()
name = "lw-%%s.pkl" %% hashlib.sha256(b"w").hexdigest()[:8]
with open(os.path.join(root, name), "wb") as handle:
    handle.write(b"w")
scenario = entry.resolve_urls({"network": {"path": None, "runtime": {
    "wrappers": {"eval": {"0_cirwhiten": {
        "whitening": "http://artifacts.invalid/" + name}}}}}}, root)
assert scenario["network"]["runtime"]["wrappers"]["eval"]["0_cirwhiten"][
    "whitening"] == os.path.join(root, name)
assert load_scenario([]) == {}
print("composed", extractor.chunks)
""" % (BLOCKED,)


def test_composition_runs_without_jax_pil_yaml():
    """A U-Net composition's batched extraction on in-memory images and the
    eval entry's artifact lookup, with JAX, the JAX package, cv2, PIL, yaml
    and msgpack blocked."""
    result = _run(["-c", RUN_COMPOSITION], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "composed 2"


RUN_DUMP = """
import sys
for name in %r + ("h5py",):
    sys.modules[name] = None
import os, pickle, tempfile
import numpy as np, torch
from mdir_tpu_torch.learning.checkpoints import save_state
from mdir_tpu_torch.learning.network import CirNetwork, SingleNetwork
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.parallel.translate import StreamingTranslator
from mdir_tpu_torch.stages import cirtorch_format, infer, whiten

rng = np.random.RandomState(0)
IMAGES = {"im%%d" %% i: rng.randint(0, 256, (40 + i %% 3 * 8, 48, 3)).astype(
    np.uint8) for i in range(8)}


def load(path):
    name = os.path.basename(path)
    return IMAGES[name] if name in IMAGES else FileNotFoundError(path)


root = tempfile.mkdtemp()
model = {"architecture": "cirnet", "cir_architecture": "alexnet",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
chain = "pil2np | apply_clahe:4:lab:8 | totensor | normalize"
net = CirNetwork(initialize_model(model, device="cpu"),
                 CirNetwork.NetworkParams(model=model, runtime={
                     "wrappers": {"train": None, "eval": {
                         "0_cirmultiscale": {"scales": True}}},
                     "data": {"transforms": chain}}))
save_state(net.state_dict()["net"], os.path.join(root, "net.ckpt"))
names = sorted(IMAGES) + ["absent"]
meta, out_names, vecs = infer.infer({
    "network": {"path": os.path.join(root, "net.ckpt"), "runtime": None},
    "output": {"inference": {"name": "embedding"}},
    "data": {"test": {"dataset": {
        "name": "CirImageList", "image_dir": root, "image_size": 64,
        "ignore_errors": True, "loader": load}}}}, (names,), device="cpu")
assert np.isnan(vecs[-1]).all() and np.isfinite(vecs[:-1]).all()
pairs = [("im%%d" %% i, "im%%d" %% (i + 1)) for i in range(0, 8, 2)]
_, lw = whiten.learn_lw_whitening({}, (names[:-1], vecs[:-1],
                                       [q for q, _ in pairs],
                                       [p for _, p in pairs]))
assert lw["P"].shape == (256, 256)
_, _, white = whiten.whiten({"dimensions": 16}, (
    {"m": np.zeros((256, 1)), "P": np.eye(256)}, names[:-1], vecs[:-1]),
    device="cpu")
assert white.shape == (8, 16) and np.isfinite(white).all()

unet = {"architecture": "p2p_unet", "in_channels": 3, "out_channels": 3,
        "nested_levels": 1}
translator = SingleNetwork(initialize_model(unet, device="cpu"),
                           SingleNetwork.NetworkParams(model=unet, runtime={
                               "wrappers": "reflectpad_divisible:8"}))
kept = {}
stream = StreamingTranslator(translator.eval(), lambda i, a, b: kept.update(
    {i: b}), mean_std=[[0.5] * 3, [0.5] * 3])
for i, name in enumerate(sorted(IMAGES)):
    stream.add(i, IMAGES[name])
stream.finish()
assert all(kept[i].shape[1:3] == IMAGES[n].shape[:2]
           for i, n in enumerate(sorted(IMAGES)))

official = os.path.join(root, "official.pth")
state = initialize_model(model, device="cpu").state_dict()
torch.save({"state_dict": state, "meta": {
    "architecture": "alexnet", "pooling": "gem", "whitening": False,
    "mean": [0.5] * 3, "std": [0.5] * 3, "outputdim": 256}}, official)
cirtorch_format.convert_contained_net(
    {"source": official, "net": os.path.join(root, "converted.ckpt")}, ())
loaded, meta, _ = cirtorch_format._load_official(official, "cpu")
wvecs = cirtorch_format._extract(loaded, meta, list(IMAGES.values()), 64,
                                 [1, 0.5])
print("dumped", vecs.shape[0], len(kept), wvecs.shape[1])
""" % (BLOCKED,)


def test_descriptor_dump_runs_without_jax_pil_h5py():
    """The descriptor-dump and Lw path as the smoke drives it: the infer
    stage's embedding output of a lab CLAHE net on images from an in-memory
    loader (one missing), the whiten stages, the streaming translator and
    the cirtorch_format conversion and extraction, with JAX, the JAX
    package, cv2, PIL, h5py, yaml and msgpack blocked."""
    result = _run(["-c", RUN_DUMP], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "dumped 9 8 8"


RUN_PHOTOMETRIC = """
import sys
for name in %r:
    sys.modules[name] = None
import numpy as np, torch
from mdir_tpu_torch.data import transforms as T
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.ops import clahe, histogram, preprocess
from mdir_tpu_torch.parallel.extract import network_extractor
from mdir_tpu_torch.tools import imgtools

mean_std = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
rng = np.random.RandomState(0)
images = [rng.randint(0, 256, s + (3,)).astype(np.uint8)
          for s in ((40, 48), (33, 45))]
model = {"architecture": "cirnet", "cir_architecture": "alexnet",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
net = CirNetwork(initialize_model(model, device="cpu"),
                 CirNetwork.NetworkParams(model=model, runtime={
                     "wrappers": {"train": None, "eval": {
                         "0_cirmultiscale": {"scales": False}}}}),
                 frozen=True)
routes = []
for dsl in ("pil2np | apply_clahe:4:lsh:8 | totensor | normalize",
            "pil2np | apply_clahe:4:luv:8 | tospace:luv | totensor "
            "| normalize",
            "pil2np | tospace:lab | apply_clahe:4:lab:8 "
            "| gamma_equalize:0.5:lsh | match_histogram:eq:luv "
            "| add_clahe_fromrgb:2:8:lsh | np_chanselect:0:3 | totensor "
            "| normalize"):
    transform = T.initialize_transforms(dsl, mean_std)
    extractor = network_extractor(net, transform)
    host = extractor.device_chain is None
    for i, img in enumerate(images):
        extractor.add(i, transform(img) if host else img)
    vecs = extractor.finish(len(images))
    assert vecs.shape == (256, 2) and np.isfinite(vecs).all(), dsl
    routes.append("host" if host else "device")
chan = torch.from_numpy(rng.rand(16, 16).astype(np.float32))
assert torch.isfinite(histogram.channel_gamma_matching_torch(chan, 0.4)).all()
rgb = imgtools.get_image([None, rng.rand(8, 8, 3).astype(np.float32)],
                         ([50, 0, 0], [20, 30, 30]),
                         "pil2np | tospace:lab | totensor | normalize")
assert rgb.shape == (8, 8, 3) and rgb.dtype == np.uint8
print(" ".join(routes))
""" % (BLOCKED,)


def test_photometric_paths_run_without_jax_cv2_pil():
    """lsh and luv CLAHE (the latter before a float tospace) as device
    chains, and a host route (tospace before CLAHE, the histogram
    transforms, an appended lsh CLAHE channel, a channel select) through
    the extractor, the torch gamma solver and the colorspace inversion of
    the rgb saver, with JAX, the JAX package, cv2, PIL, yaml and msgpack
    blocked."""
    result = _run(["-c", RUN_PHOTOMETRIC], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "device device host"


RUN_REGIONAL = """
import sys
for name in %r:
    sys.modules[name] = None
import numpy as np, torch
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.models import initialize_model, trunks
from mdir_tpu_torch.parallel import extract
torch.set_num_threads(1)  # small tensors, beside the other test workers
trunks.DENSENET_CFGS["densenet121"] = (64, 32, (1, 1, 1, 1))
trunks.OUTPUT_DIM["densenet121"] = 68  # the cut blocks' width
rng = np.random.RandomState(0)
images = [(rng.rand(*s, 3) * 255).astype(np.uint8)
          for s in ((96, 72), (70, 70))]
mean_std = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
shapes = []
for arch, pool, regional in (("alexnet", "rmac", False),
                             ("alexnet", "gem", True),
                             ("squeezenet1_1", "gem", False),
                             ("densenet121", "spoc", True)):
    params = {"architecture": "cirnet", "cir_architecture": arch,
              "local_whitening": False, "pooling": pool,
              "regional": regional, "whitening": False, "pretrained": False}
    net = CirNetwork(initialize_model(params, device="cpu"),
                     CirNetwork.NetworkParams(model=params, runtime={
                         "wrappers": "cirmultiscale:True"}), frozen=True)
    extractor = extract.StreamingExtractor(
        net.model, scales=[1, 0.5], normalize_mean_std=mean_std)
    for i, img in enumerate(images):
        extractor.add(i, img)
    out = extractor.finish(len(images))
    assert np.isfinite(out).all() and extractor.region_pooling == (
        pool == "rmac" or regional)
    shapes.append(out.shape[0])
regional = extract.extract_regional_vectors(net, images[:1], None,
                                            lambda a: a.astype(np.float32))
local = extract.extract_local_vectors(net, images[:1], None,
                                      lambda a: a.astype(np.float32))
print(shapes, regional[0].shape[1], local[0].shape[0])
""" % (BLOCKED,)


def test_regional_nets_run_without_jax_pil():
    """RMAC and Rpool nets through the batched extractor (region boxes per
    scale), the squeezenet and densenet trunks, and the regional and local
    vectors, with JAX, the JAX package, cv2, PIL, yaml and msgpack
    blocked."""
    result = _run(["-c", RUN_REGIONAL], ROOT)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split("\n")[-2] == "[256, 256, 512, 68] 68 68"
