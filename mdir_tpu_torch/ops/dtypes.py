"""Compute-dtype policy: bfloat16 on the card by default, runtime-guarded.

The port's counterpart of ``mdir_tpu/ops/dtypes.py``. Descriptor extraction
and the training step of a retrieval net run in bfloat16 on a CUDA device
unless the network's runtime says otherwise, but the claim that bfloat16
descriptors are retrieval-identical is checked at run time, not assumed:
the first chunk of every extraction (the first step of training, and again
every ``TRAIN_GUARD_REARM`` steps) also runs in float32, and when the
bfloat16 result drifts beyond a cosine bar the float32 result is what is
returned and the process stays in float32 for that module.

Selection (yaml: ``network: runtime: compute_dtype``):

* ``float32`` (or ``f32``, or no key) -- float32, no guard;
* ``bfloat16`` -- forced, no guard;
* ``auto`` -- bfloat16 with the guard on a CUDA device, float32 on the CPU.

The port reads no environment variable: the bars and the re-arm period are
the module constants below.
"""
import copy
import weakref

import torch

from ..device import check_compute_dtype

#: the extraction guard's bar on the least row cosine of a chunk
GUARD_MIN_COSINE = 0.997
#: the training guard's bar on the flattened gradient's cosine. Calibrated
#: by the JAX package on its chip (ResNet101-GeM contrastive step, 5 tuples
#: at 362^2): a bf16 trunk with a float32 head deviates from float32 by
#: gradient cosine 0.981 with the loss within 1e-4, where adjacent batches'
#: float32 gradients are at cosine ~0.67; 0.95 admits the split and still
#: rejects a sign flip, a zeroed subtree or loss drift
TRAIN_GUARD_MIN_COSINE = 0.95
#: the training guard's bar on |loss_bf16 - loss_f32| / |loss_f32|
TRAIN_GUARD_LOSS_RTOL = 0.05
#: the training guard runs again every this many steps (0: first step only)
TRAIN_GUARD_REARM = 100

#: per-process guard verdicts, keyed by (kind, id(module)): True = bfloat16
#: validated. ``record_guard_decision`` evicts an entry when its module is
#: garbage-collected, so a recycled address never inherits a verdict.
_GUARD_DECISIONS = {}


def on_accelerator(device):
    """Whether ``device`` is one ``auto`` computes bfloat16 on."""
    return torch.device(device).type == "cuda"


def resolve_compute_dtype(runtime=None, device="cuda"):
    """-> (torch dtype or None, guard_wanted) for a network's runtime dict.

    None means float32 (no cast). ``guard_wanted`` asks the caller to check
    the fast dtype against float32 before it commits to it.
    """
    requested = (runtime or {}).get("compute_dtype", "auto")
    check_compute_dtype(requested)
    if requested in (None, "float32", "f32"):
        return None, False
    if requested == "auto":
        if not on_accelerator(device):
            return None, False
        return torch.bfloat16, True
    return torch.bfloat16, False


def guard_decision(module, kind="extract"):
    """The cached verdict for ``module`` (None: not checked yet). ``kind``
    (``extract``, ``composed``, ``train``) keeps the guards of different
    programs over the same module apart."""
    return _GUARD_DECISIONS.get((kind, id(module)))


def record_guard_decision(module, ok, kind="extract"):
    key = (kind, id(module))
    fresh = key not in _GUARD_DECISIONS
    _GUARD_DECISIONS[key] = bool(ok)
    if fresh:
        weakref.finalize(module, _GUARD_DECISIONS.pop, key, None)


def row_cosines(fast, exact):
    """Cosine of each row (last axis) of ``fast`` with ``exact``, in
    float64."""
    fast, exact = (a.to(torch.float64) if torch.is_tensor(a)
                   else torch.tensor(a, dtype=torch.float64)
                   for a in (fast, exact))
    exact = exact.to(fast.device)
    denom = torch.linalg.vector_norm(fast, dim=-1) \
        * torch.linalg.vector_norm(exact, dim=-1) + 1e-12
    return (fast * exact).sum(dim=-1) / denom


def cosine_rows_ok(fast, exact, min_cosine=None):
    """Whether every row of ``fast`` is within the cosine bar of
    ``exact``."""
    bar = GUARD_MIN_COSINE if min_cosine is None else min_cosine
    return bool(row_cosines(fast, exact).min() >= bar)


def fast_copy(model, dtype):
    """A copy of ``model`` with every floating parameter and buffer in
    ``dtype`` (frozen BatchNorm statistics and GeM's p too, as the JAX
    package casts every float32 leaf), for extraction without gradients."""
    return copy.deepcopy(model).to(dtype).requires_grad_(False)


def cast_trunk(model, dtype):
    """{name: tensor} of the trunk's (``model.features``) floating
    parameters and buffers cast to ``dtype``, for ``torch.func.
    functional_call``: the casts are differentiable, so the gradients land
    on the float32 parameters, and the head keeps its float32 ones."""
    named = list(model.features.named_parameters(prefix="features")) \
        + list(model.features.named_buffers(prefix="features"))
    return {name: t.to(dtype) for name, t in named if t.is_floating_point()}
