"""The port's compute-dtype policy and its guards (``ops/dtypes.py``), case
by case as ``tests/test_dtypes.py`` holds the JAX package's, and the bf16
programs against the JAX package's bf16 programs.

On the CPU ``auto`` resolves to float32, so these tests force bfloat16, or
make the CPU count as an accelerator, to run the fast path and both guard
verdicts. Parity bars with the JAX package (the same seeded weights and
numpy inputs, both packages in bfloat16):

* descriptors: every row of the port's bf16 output at cosine >= 0.999 of
  the JAX package's bf16 row, and each package's bf16 rows at cosine
  >= 0.997 (the guard's bar) of the port's float32 rows, which equal the
  JAX package's float32 rows within 1e-4 (``tests/test_torch_extract.py``,
  ``tests/test_torch_composition.py``);
* one train step: the losses within 1 % of each other and of float32, the
  two packages' flattened bf16 gradients at cosine >= 0.999 of each other,
  and each at cosine >= 0.95 (the training guard's bar) of the port's
  float32 gradient (0.988 on this AlexNet batch, as a bf16 trunk moves
  the gradient in either package).
"""
import copy
import gc
import pickle

import numpy as np
import pytest

import jax
import torch

from mdir_tpu.data.transforms import initialize_transforms as jax_tf
from mdir_tpu.learning import load_network as jax_load_network
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.train_step import TrainStep as JaxTrainStep
from mdir_tpu.learning.train_step import prepare_batch as jax_prepare_batch
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import trunks as jax_trunks
from mdir_tpu.ops.preprocess import chain_from_transform as jax_chain_of
from mdir_tpu.optim.criteria import initialize_criterion as jax_criterion
from mdir_tpu.parallel.extract import StreamingExtractor as JaxExtractor
from mdir_tpu.parallel.extract import \
    extract_vectors_composed as jax_composed
from test_torch_composition import checkpoints  # noqa: F401

from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.device import check_compute_dtype
from mdir_tpu_torch.learning import load_network
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.learning.train_step import TrainStep
from mdir_tpu_torch.models import initialize_model, trunks
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.ops import dtypes as dtype_policy
from mdir_tpu_torch.ops import pooling, pooling_kernel
from mdir_tpu_torch.ops.preprocess import chain_from_transform
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.parallel import extract

BF16 = torch.bfloat16
MEAN_STD = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
SCALES = [1, 1 / np.sqrt(2), 0.5]
CRITERION = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
ALEXNET = {"architecture": "cirnet", "cir_architecture": "alexnet",
           "local_whitening": False, "pooling": "gem", "regional": False,
           "whitening": False, "pretrained": False}
RESNET = dict(ALEXNET, cir_architecture="resnet101")
CLAHE_DSL = "pil2np | apply_clahe | totensor | normalize"
PACKAGES_MIN_COSINE = 0.999  # port bf16 rows against JAX bf16 rows
STEP_LOSS_RTOL, STEP_MIN_COSINE = 0.01, 0.999


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True)
def _fresh_decisions():
    dtype_policy._GUARD_DECISIONS.clear()
    yield
    dtype_policy._GUARD_DECISIONS.clear()


@pytest.fixture
def accelerator(monkeypatch):
    """``auto`` resolves as on a card."""
    monkeypatch.setattr(dtype_policy, "on_accelerator", lambda device: True)


def _min_cosine(a, b):
    """Least cosine of matching columns of two (D, N) blocks."""
    return float(dtype_policy.row_cosines(np.asarray(a).T,
                                          np.asarray(b).T).min())


def test_policy_resolution():
    resolve = dtype_policy.resolve_compute_dtype
    # the CPU: auto stays exact
    assert resolve({}, "cpu") == (None, False)
    assert resolve(None, torch.device("cpu")) == (None, False)
    # a card: auto = bf16 + guard
    assert resolve({}, "cuda") == (BF16, True)
    assert resolve({"compute_dtype": "auto"}, "cuda:1") == (BF16, True)
    # explicit runtime selection: forced, no guard, on either
    for device in ("cpu", "cuda"):
        assert resolve({"compute_dtype": "float32"}, device) == (None, False)
        assert resolve({"compute_dtype": "f32"}, device) == (None, False)
        assert resolve({"compute_dtype": None}, device) == (None, False)
        assert resolve({"compute_dtype": "bfloat16"}, device) \
            == (BF16, False)
    for name in ("float16", "bf16", "int8"):
        with pytest.raises(ValueError, match="unknown compute_dtype"):
            resolve({"compute_dtype": name}, "cpu")
        with pytest.raises(ValueError, match="unknown compute_dtype"):
            check_compute_dtype(name)
    check_compute_dtype("bfloat16")  # no longer raises


def _alexnet(seed=0):
    return initialize_model(ALEXNET, device="cpu", seed=seed)


def _extract(model, arrays, scales=(1,), **kwargs):
    ext = extract.StreamingExtractor(model, scales=scales, msp=1.0,
                                     max_batch=2,
                                     normalize_mean_std=MEAN_STD, **kwargs)
    for i, arr in enumerate(arrays):
        ext.add(i, arr)
    return ext.finish(len(arrays)), ext


def _uint8(rng, n, shape=(96, 96)):
    return [(rng.rand(*shape, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_extraction_guard_accepts_and_caches(rng):
    model = _alexnet()
    arrays = _uint8(rng, 4)
    f32, _ = _extract(model, arrays)
    fast, ext = _extract(model, arrays, compute_dtype=BF16, dtype_guard=True)
    # accepted: bf16 descriptors within the cosine bar, verdict cached
    assert dtype_policy.guard_decision(model) is True
    assert ext.guard_report["ok"] and ext.compute_dtype == BF16
    assert ext.guard_report["min_cosine"] >= dtype_policy.GUARD_MIN_COSINE
    assert _min_cosine(f32, fast) >= dtype_policy.GUARD_MIN_COSINE
    assert not np.array_equal(f32, fast)  # it did compute bf16
    # a later extractor of the model reads the verdict: no second check
    again, ext = _extract(model, arrays, compute_dtype=BF16,
                          dtype_guard=True)
    assert ext.guard_report is None and ext.compute_dtype == BF16
    np.testing.assert_array_equal(again, fast)


def test_extraction_guard_fallback_ships_f32(rng, monkeypatch, capsys):
    model = _alexnet()
    arrays = _uint8(rng, 4)
    f32, _ = _extract(model, arrays)
    monkeypatch.setattr(dtype_policy, "cosine_rows_ok",
                        lambda *a, **k: False)
    fast, ext = _extract(model, arrays, compute_dtype=BF16, dtype_guard=True)
    # rejected: every chunk (the first included) ships the float32 result
    assert dtype_policy.guard_decision(model) is False
    assert ext.guard_report["ok"] is False and ext.compute_dtype is None
    assert "guard" in capsys.readouterr().out  # printed, never silent
    np.testing.assert_array_equal(f32, fast)
    # later extractors see the cached verdict and never leave float32
    monkeypatch.undo()
    again, ext = _extract(model, arrays, compute_dtype=BF16,
                          dtype_guard=True)
    assert ext.compute_dtype is None and ext.fast_model is model
    np.testing.assert_array_equal(f32, again)


def test_cast_at_conv_boundary_on_non_unit_scales(rng):
    """The input of the first conv is bf16 at every scale: a cast before
    the float32-weighted resize gather would come out float32 again."""
    model = _alexnet()
    ext = extract.StreamingExtractor(model, scales=SCALES, max_batch=2,
                                     normalize_mean_std=MEAN_STD,
                                     compute_dtype=BF16)
    seen = []
    first_conv = next(m for m in ext.fast_model.modules()
                      if isinstance(m, torch.nn.Conv2d))
    first_conv.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].dtype))
    for i, arr in enumerate(_uint8(rng, 2, (80, 100))):
        ext.add(i, arr)
    out = ext.finish(2)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert seen == [BF16] * len(SCALES)
    # the float32 model is untouched: the fast copy holds the bf16 weights
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.dtype == BF16 for p in ext.fast_model.parameters())
    assert ext.fast_model.pool.p.dtype == BF16


def test_network_extractor_resolves_the_runtime(rng, accelerator):
    def network(runtime):
        return CirNetwork(_alexnet(), CirNetwork.NetworkParams(
            model={}, runtime=dict(runtime, wrappers="")), frozen=True)

    transform = initialize_transforms("pil2np | totensor | normalize",
                                      MEAN_STD)
    for runtime, expected in (({}, (BF16, True)),
                              ({"compute_dtype": "bfloat16"}, (BF16, False)),
                              ({"compute_dtype": "float32"}, (None, False))):
        ext = extract.network_extractor(network(runtime), transform)
        assert (ext.compute_dtype, ext.guard_pending) == expected


def test_gem_wrapper_takes_bf16_on_the_cpu(rng):
    """The plain version of the bf16 kernel is gem_l2n_plain(x.float())."""
    x = torch.from_numpy(rng.rand(3, 64, 7, 9).astype(np.float32)).to(BF16)
    valid = torch.tensor([[7, 9], [3, 4], [1, 1]], dtype=torch.int32)
    for p in (torch.tensor([3.0], dtype=BF16), torch.tensor([2.5]), 3.0):
        before = pooling_kernel.launches
        out = pooling_kernel.gem_l2n(x, valid, p)
        assert pooling_kernel.launches == before and out.dtype == torch.float32
        ref = pooling.gem_l2n_plain(x.float(), valid, torch.as_tensor(
            p, dtype=torch.float32).reshape(1))
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _train_fixture(rng, arch="alexnet"):
    model = initialize_model(dict(ALEXNET, cir_architecture=arch),
                             device="cpu")
    network = CirNetwork(model, CirNetwork.NetworkParams(
        model={}, runtime={"wrappers": ""}))
    images = [[rng.rand(64, 64, 3).astype(np.float32) for _ in range(3)]
              for _ in range(2)]
    targets = [np.array([-1.0, 1.0, 0.0], np.float32)] * 2
    return network, initialize_criterion(CRITERION), (images, targets)


def _step(step, batch):
    """A zeroed step's loss and its parameters' gradients."""
    step.network.model.zero_grad(set_to_none=True)
    loss, _ = step.gradients(*batch)
    return float(loss), {name: p.grad.clone() for name, p
                         in step.network.model.named_parameters()}


def _flat(grads):
    return torch.cat([g.reshape(-1) for g in grads.values()])


def test_train_step_bf16_matches_f32_semantics(rng):
    """bf16 trunk with float32 master parameters: the loss close and the
    gradient direction essentially float32's (the guard's criterion)."""
    network, criterion, batch = _train_fixture(rng)
    loss_e, grads_e = _step(TrainStep(network, criterion,
                                      compute_dtype="float32"), batch)
    fast = TrainStep(network, criterion, compute_dtype="bfloat16")
    assert fast.compute_dtype == BF16 and not fast.guard_pending
    loss_f, grads_f = _step(fast, batch)
    assert abs(loss_f - loss_e) <= 0.05 * abs(loss_e)
    assert all(g.dtype == torch.float32 for g in grads_f.values())
    cos = float(dtype_policy.row_cosines(_flat(grads_f), _flat(grads_e)))
    assert cos >= 0.99
    assert not torch.equal(_flat(grads_f), _flat(grads_e))


def test_train_guard_fallback(rng, accelerator, monkeypatch, capsys):
    network, criterion, batch = _train_fixture(rng)
    loss_e, grads_e = _step(TrainStep(network, criterion,
                                      compute_dtype="float32"), batch)
    monkeypatch.setattr(dtype_policy, "cosine_rows_ok",
                        lambda *a, **k: False)
    guarded = TrainStep(network, criterion)
    assert guarded.compute_dtype == BF16 and guarded.guard_pending
    loss_g, grads_g = _step(guarded, batch)
    # rejected: the float32 result is what comes back, verdict cached
    assert dtype_policy.guard_decision(network.model, "train") is False
    assert guarded.compute_dtype is None
    assert guarded.guard_reports[-1]["ok"] is False
    assert "train guard" in capsys.readouterr().out
    assert loss_g == loss_e
    for name, grad in grads_g.items():
        assert torch.equal(grad, grads_e[name]), name
    monkeypatch.undo()
    monkeypatch.setattr(dtype_policy, "on_accelerator", lambda device: True)
    # a fresh step for the same module starts straight in float32
    later = TrainStep(network, criterion)
    assert later.compute_dtype is None and not later.guard_pending


def test_train_guard_accepts(rng, accelerator):
    network, criterion, batch = _train_fixture(rng)
    loss_f, grads_f = _step(TrainStep(network, criterion,
                                      compute_dtype="bfloat16"), batch)
    guarded = TrainStep(network, criterion)
    assert guarded.compute_dtype == BF16 and guarded.guard_pending
    loss, grads = _step(guarded, batch)
    assert dtype_policy.guard_decision(network.model, "train") is True
    report, = guarded.guard_reports
    assert report["ok"] and report["finite"] and report["step"] == 1
    assert report["loss_gap"] <= dtype_policy.TRAIN_GUARD_LOSS_RTOL
    assert report["grad_cosine"] >= dtype_policy.TRAIN_GUARD_MIN_COSINE
    # the bf16 result is kept, and only it: no float32 gradient added in
    assert loss == loss_f
    for name, grad in grads.items():
        assert torch.equal(grad, grads_f[name]), name


def test_train_guard_keeps_earlier_accumulation(rng, accelerator):
    """Gradients already in ``.grad`` when the guard runs are set aside and
    added back once: the guard's two runs never add into each other."""
    network, criterion, batch = _train_fixture(rng)
    _, grads_f = _step(TrainStep(network, criterion,
                                 compute_dtype="bfloat16"), batch)
    model = network.model
    model.zero_grad(set_to_none=True)
    TrainStep(network, criterion, compute_dtype="bfloat16").gradients(*batch)
    first = {name: p.grad.clone() for name, p in model.named_parameters()}
    guarded = TrainStep(network, criterion)
    guarded.gradients(*batch)  # onto the first batch's gradients
    assert guarded.guard_reports[-1]["ok"]
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, first[name] + grads_f[name],
                                   rtol=0, atol=0)


def test_train_guard_rearms_and_catches_midrun_drift(rng, accelerator,
                                                     monkeypatch):
    """The guard runs again every TRAIN_GUARD_REARM steps: a run whose bf16
    gradients drift only after the accepted first step still falls back to
    float32 at the next check."""
    network, criterion, batch = _train_fixture(rng)
    monkeypatch.setattr(dtype_policy, "TRAIN_GUARD_REARM", 2)
    guarded = TrainStep(network, criterion)
    assert guarded.rearm_every == 2 and guarded.guard_pending

    # step 1: healthy, the guard accepts
    _step(guarded, batch)
    assert dtype_policy.guard_decision(network.model, "train") is True
    assert guarded.compute_dtype == BF16

    # drift appears after acceptance
    real_ok = dtype_policy.cosine_rows_ok
    monkeypatch.setattr(dtype_policy, "cosine_rows_ok",
                        lambda *a, **k: False)

    # step 2: between checks, the fast path, no check yet
    _step(guarded, batch)
    assert guarded.compute_dtype == BF16 and len(guarded.guard_reports) == 1

    # step 3: the check fires, drift found: float32 result, cached verdict
    loss_e, _ = _step(TrainStep(network, criterion,
                                compute_dtype="float32"), batch)
    loss_g, _ = _step(guarded, batch)
    assert guarded.compute_dtype is None
    assert guarded.guard_reports[-1]["step"] == 3
    assert dtype_policy.guard_decision(network.model, "train") is False
    assert loss_g == loss_e
    monkeypatch.setattr(dtype_policy, "cosine_rows_ok", real_ok)

    # after the fallback: float32, no more checks
    _step(guarded, batch)
    _step(guarded, batch)
    assert guarded.compute_dtype is None and not guarded.guard_pending
    assert len(guarded.guard_reports) == 2


def test_train_cast_scopes_to_trunk(rng):
    """Only the trunk is cast (every parameter and buffer of ``features``);
    the head's parameters stay float32 and, through ``head_dtype``, take
    float32 features: the pool's gradient input is float32."""
    network, criterion, batch = _train_fixture(rng, "resnet101")
    model = network.model
    cast = dtype_policy.cast_trunk(model, BF16)
    trunk = {name for name, _ in model.named_parameters()
             if name.startswith("features.")} \
        | {name for name, t in model.named_buffers()
           if name.startswith("features.") and t.is_floating_point()}
    assert set(cast) == trunk and "features.1.running_var" in cast
    assert all(t.dtype == BF16 for t in cast.values())
    assert "pool.p" not in cast
    seen = []
    model.pool.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].dtype))
    model.features.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].dtype))
    step = TrainStep(network, criterion, compute_dtype="bfloat16")
    _step(step, batch)
    assert seen[:2] == [BF16, torch.float32]  # trunk input, head input
    assert model.pool.p.grad.dtype == torch.float32


def test_train_bf16_exclusions():
    """No bf16 step for a module without the head seam (a U-Net)."""
    unet = {"architecture": "p2p_unet", "in_channels": 3,
            "out_channels": 3, "nested_levels": 2}
    from mdir_tpu_torch.learning.network import SingleNetwork

    network = SingleNetwork(initialize_model(unet, device="cpu"),
                            SingleNetwork.NetworkParams(
                                model=unet,
                                runtime={"compute_dtype": "bfloat16"}))
    step = TrainStep(network, initialize_criterion({"loss": "l1"}))
    assert step.compute_dtype is None and not step.guard_pending


def test_train_guard_threshold_calibration(monkeypatch):
    """The training bar is the calibrated 0.95, not the extraction guard's
    0.997; the re-arm period is 100 steps; both are module constants."""
    assert dtype_policy.TRAIN_GUARD_MIN_COSINE == 0.95
    assert dtype_policy.GUARD_MIN_COSINE == 0.997
    assert dtype_policy.TRAIN_GUARD_REARM == 100
    assert dtype_policy.TRAIN_GUARD_LOSS_RTOL == 0.05
    monkeypatch.setattr(dtype_policy, "TRAIN_GUARD_MIN_COSINE", 0.99)
    flat = torch.tensor([[1.0, 0.1]])
    assert not dtype_policy.cosine_rows_ok(
        flat, torch.tensor([[1.0, 0.3]]), dtype_policy.TRAIN_GUARD_MIN_COSINE)


def test_head_dtype_seam_forces_f32_descriptors(rng):
    """A bf16 net asked for head_dtype float32 returns float32 descriptors
    (the pool/L2N tail runs in full precision), and without it a bf16 net
    feeds its pool the trunk's bf16 map."""
    model = dtype_policy.fast_copy(_alexnet(), BF16)
    batch = torch.from_numpy(rng.rand(1, 3, 64, 64).astype(np.float32))
    pooled = []
    model.pool.register_forward_pre_hook(
        lambda module, args: pooled.append(args[0].dtype))
    with torch.no_grad():
        out = model(batch.to(BF16), head_dtype=torch.float32)
        assert out.dtype == torch.float32
        model(batch.to(BF16))
    assert pooled == [torch.float32, BF16]


def test_guard_decision_evicted_on_module_gc():
    """A verdict dies with its module: an id-keyed entry surviving it would
    let a new module at a recycled address inherit it unchecked."""
    module = _alexnet()
    dtype_policy.record_guard_decision(module, True)
    key = ("extract", id(module))
    assert dtype_policy._GUARD_DECISIONS.get(key) is True
    dtype_policy.record_guard_decision(module, False)  # one finalizer
    assert dtype_policy._GUARD_DECISIONS.get(key) is False
    del module
    gc.collect()
    assert key not in dtype_policy._GUARD_DECISIONS


# ---- parity with the JAX package at bf16 -----------------------------------

@pytest.fixture(scope="module")
def short_resnets():
    """The same (1, 1, 1, 1) ResNet-GeM in both packages, JAX weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_trunks.RESNET_LAYERS, "resnet101",
                   (jax_trunks.Bottleneck, (1, 1, 1, 1)))
        mp.setitem(trunks.RESNET_LAYERS, "resnet101",
                   (trunks.Bottleneck, (1, 1, 1, 1)))
        jax_model = jax_initialize_model(RESNET)
        port_model = initialize_model(RESNET, device="cpu")
        port_model.load_state_dict(from_jax_variables(
            jax.tree.map(np.asarray, jax_model.variables)), strict=True)
        yield jax_model, port_model


def _whiten(tmp_path, dim, rng):
    from mdir_tpu.learning.wrappers import CirtorchWhiten as JaxWhiten

    from mdir_tpu_torch.learning.wrappers import CirtorchWhiten

    path = str(tmp_path / "whiten.pkl")
    with open(path, "wb") as handle:
        pickle.dump({"P": np.eye(dim) + 0.01 * rng.randn(dim, dim),
                     "m": 0.01 * rng.randn(dim, 1)}, handle)
    return JaxWhiten(path), CirtorchWhiten(path)


def _both(jax_ex, port_ex, arrays):
    for i, arr in enumerate(arrays):
        jax_ex.add(i, arr)
        port_ex.add(i, arr)
    return jax_ex.finish(len(arrays)), port_ex.finish(len(arrays))


def _hold_parity(theirs, ours, f32):
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    assert _min_cosine(ours, theirs) >= PACKAGES_MIN_COSINE
    for fast in (ours, theirs):
        assert _min_cosine(fast, f32) >= dtype_policy.GUARD_MIN_COSINE
    assert not np.array_equal(ours, f32)


def test_resnet_extractor_bf16_matches_jax(short_resnets, tmp_path):
    """A short ResNet101-GeM, three scales and Lw, uint8 ingress."""
    jax_model, port_model = short_resnets
    rng = np.random.RandomState(3)
    jax_whiten, whiten = _whiten(tmp_path, 2048, rng)
    arrays = _uint8(rng, 2, (70, 90))
    msp = float(jax_model.pool_p)
    kwargs = dict(scales=SCALES, msp=msp, max_batch=2,
                  normalize_mean_std=MEAN_STD)
    f32, _ = _extract(port_model, arrays, SCALES, whiten=whiten)
    theirs, ours = _both(
        JaxExtractor(jax_model, whiten=jax_whiten, compute_dtype="bfloat16",
                     **kwargs),
        extract.StreamingExtractor(port_model, whiten=whiten,
                                   compute_dtype=BF16, **kwargs), arrays)
    _hold_parity(theirs, ours, f32)


def test_clahe_extractor_bf16_matches_jax(tmp_path):
    """AlexNet-GeM with the lab CLAHE device chain, three scales."""
    jax_model = jax_initialize_model(ALEXNET)
    port_model = initialize_model(ALEXNET, device="cpu")
    port_model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jax_model.variables)), strict=True)
    rng = np.random.RandomState(8)
    arrays = [(rng.rand(*shape, 3) * 255).astype(np.uint8)
              for shape in ((80, 100), (70, 110))]
    msp = float(jax_model.pool_p)
    kwargs = dict(scales=SCALES, msp=msp, max_batch=2)

    def chain():
        return chain_from_transform(initialize_transforms(CLAHE_DSL,
                                                          MEAN_STD))

    f32_ex = extract.StreamingExtractor(port_model, device_chain=chain(),
                                        **kwargs)
    for i, arr in enumerate(arrays):
        f32_ex.add(i, arr)
    f32 = f32_ex.finish(len(arrays))
    theirs, ours = _both(
        JaxExtractor(jax_model, compute_dtype="bfloat16",
                     device_chain=jax_chain_of(jax_tf(CLAHE_DSL, MEAN_STD)),
                     **kwargs),
        extract.StreamingExtractor(port_model, device_chain=chain(),
                                   compute_dtype=BF16, **kwargs), arrays)
    _hold_parity(theirs, ours, f32)


def _composition(checkpoints, compute_dtype):
    runtime = {"wrappers": {"train": None, "eval": {
        "0_cirwhiten": {"whitening": checkpoints["whiten"],
                        "dimensions": None},
        "1_cirmultiscale": {"scales": True}}}}
    if compute_dtype:
        runtime["compute_dtype"] = compute_dtype  # routed to the embedder
    params = {"path": checkpoints["directory"], "runtime": runtime}
    return jax_load_network(copy.deepcopy(params)).eval(), \
        load_network(copy.deepcopy(params), device="cpu").eval()


def test_composed_extractor_bf16_matches_jax(checkpoints):
    """A two-level U-Net before an AlexNet-GeM, three scales and Lw, from
    the JAX package's checkpoint; ``compute_dtype`` in the composition's
    runtime reaches the embedder, as in yaml."""
    images = [(np.random.RandomState(5).rand(h, w, 3) * 255)
              .astype(np.uint8) for h, w in ((90, 70), (75, 66))]
    _, f32_net = _composition(checkpoints, None)
    f32 = extract.extract_vectors_composed(
        f32_net, images, None, initialize_transforms(
            "pil2np | totensor | normalize", [[0.5] * 3, [0.5] * 3]))
    jax_net, port_net = _composition(checkpoints, "bfloat16")
    assert port_net["embed"].network_params.runtime["compute_dtype"] \
        == "bfloat16"
    ext = extract.ComposedExtractor(port_net, [[0.5] * 3, [0.5] * 3])
    assert ext.compute_dtype == BF16 and not ext.guard_pending
    assert all(p.dtype == BF16 for m in (ext.translate, ext.embed)
               for p in m.parameters())
    for i, img in enumerate(images):
        ext.add(i, img)
    ours = ext.finish(len(images))
    theirs = jax_composed(jax_net, images, None,
                          jax_tf("pil2np | totensor | normalize",
                                 [[0.5] * 3, [0.5] * 3]))
    _hold_parity(theirs, ours, f32)


def test_composed_guard_accepts_caches_and_falls_back(checkpoints,
                                                      accelerator,
                                                      monkeypatch):
    """``auto`` on a card: the first composed chunk is checked under the
    kind ``composed``; a rejection ships the float32 chunk."""
    images = [(np.random.RandomState(6).rand(64, 64, 3) * 255)
              .astype(np.uint8)]
    _, network = _composition(checkpoints, "auto")
    embed = network["embed"].model

    def run():
        ext = extract.ComposedExtractor(network, [[0.5] * 3, [0.5] * 3])
        for i, img in enumerate(images):
            ext.add(i, img)
        return ext.finish(len(images)), ext

    fast, ext = run()
    assert ext.guard_report["ok"] and ext.compute_dtype == BF16
    assert dtype_policy.guard_decision(embed, "composed") is True
    assert dtype_policy.guard_decision(embed) is None  # its own kind
    again, ext = run()
    assert ext.guard_report is None
    np.testing.assert_array_equal(fast, again)

    dtype_policy._GUARD_DECISIONS.clear()
    monkeypatch.setattr(dtype_policy, "cosine_rows_ok",
                        lambda *a, **k: False)
    shipped, ext = run()
    assert ext.guard_report["ok"] is False and ext.compute_dtype is None
    assert dtype_policy.guard_decision(embed, "composed") is False
    _, f32_net = _composition(checkpoints, "float32")
    f32 = extract.ComposedExtractor(f32_net, [[0.5] * 3, [0.5] * 3])
    f32.add(0, images[0])
    np.testing.assert_array_equal(shipped, f32.finish(1))


def test_train_step_bf16_matches_jax(rng):
    """One contrastive step of AlexNet-GeM in bf16 in both packages, on
    host-normalised tuples (the port per tuple, JAX as one bucket)."""
    jax_model = jax_initialize_model(ALEXNET)
    jax_net = JaxCirNetwork(jax_model, JaxCirNetwork.NetworkParams(
        model=dict(ALEXNET), runtime={"wrappers": ""}))
    port_model = initialize_model(ALEXNET, device="cpu")
    port_model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jax_model.variables)), strict=True)
    network = CirNetwork(port_model, CirNetwork.NetworkParams(
        model=dict(ALEXNET), runtime={"wrappers": ""}))
    images = [[rng.rand(rng.randint(48, 65), rng.randint(48, 65),
                        3).astype(np.float32) for _ in range(4)]
              for _ in range(2)]
    targets = [np.array([-1.0, 1.0, 0.0, 0.0], np.float32)] * 2
    criterion = initialize_criterion(CRITERION)

    step = JaxTrainStep(jax_net, jax_criterion(CRITERION),
                        batch_average=False, compute_dtype="bfloat16")
    assert step.compute_dtype == "bfloat16"
    batch, valid, tgt, _ = jax_prepare_batch(images, targets)
    (loss_jax, _), grads = step.gradients(jax_model.params, batch, valid,
                                          tgt, jax.random.PRNGKey(0))
    grads_jax = from_jax_variables(
        {"params": jax.tree.map(lambda g: np.asarray(g, np.float32),
                                grads)})
    loss_e, grads_e = _step(TrainStep(network, criterion,
                                      compute_dtype="float32"),
                            (images, targets))
    loss_f, grads_f = _step(TrainStep(network, criterion,
                                      compute_dtype="bfloat16"),
                            (images, targets))
    grads_jax = {name: grads_jax[name] for name in grads_f}
    for loss in (float(loss_jax), loss_e):
        assert abs(loss_f - loss) <= STEP_LOSS_RTOL * abs(loss)
    assert abs(float(loss_jax) - loss_e) <= STEP_LOSS_RTOL * abs(loss_e)
    flat = {k: _flat(g) for k, g in (("port", grads_f), ("jax", grads_jax),
                                     ("f32", grads_e))}
    for a, b in (("port", "jax"), ("port", "f32"), ("jax", "f32")):
        cos = float(dtype_policy.row_cosines(flat[a], flat[b]))
        assert cos >= (STEP_MIN_COSINE if a == "port" and b == "jax"
                       else dtype_policy.TRAIN_GUARD_MIN_COSINE), (a, b, cos)
