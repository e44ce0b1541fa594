"""Whether the training epochs produced what the plain reference gives.

The reference (``reference/training.py``) follows the first three steps of
epoch 0, from the weights the benchmark drew and a fresh Adam, and of
every window epoch, from the weights and Adam's state that epoch started
with (the program's own: the steps between are followed only through
them). It runs on the tuples the program's mining picked (the picks are
the program's; the mining that made them is judged on its own, below).
Each number is the largest over the followed epochs:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as the optimizer got it (read back from
  the change of Adam's first moment in step 1), by the worst leaf: the gap
  between the program's norm of a leaf and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``delta_gap``: the change of the parameters over the three steps, by
  the worst leaf in the same measure, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (Adam
  moves those by round-off alone).

Each epoch's mining, the window's too, is judged from the weights it ran
with (the benchmark's draw for epoch 0, the program's own for later ones):

* ``mine_gap``: a sample of the mined images, drawn from the seed,
  described by the reference at one scale, against the program's mined
  descriptors: the largest absolute difference of an entry;
* ``pick_gap``: the hardest negatives picked again from the program's own
  mined descriptors (scores in float64, per query the first pool images of
  new clusters): the largest score by which a program's pick lies below
  the reference's pick at its place (0 for the same picks; ties in any
  order).
* ``nonfinite``: steps whose loss is a NaN or an infinity.

``control`` puts the reference in a lower precision in the program's
place and judges its numbers by the same limits.
"""
import sys

import numpy as np
import torch

from harness.runner import compare
from reference import training

EXCLUDE_BELOW = 1e-3


def _leaf_gap(prog, ref, keep=None):
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
             ref.items()}
    median = float(np.median(list(norms.values())))
    gaps = [abs(float(torch.linalg.vector_norm(prog[k].double()))
                - norms[k]) / max(norms[k], median, 1e-30)
            for k in ref if keep is None or k in keep]
    return max(gaps)


def _kept(first_ref):
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in first_ref.items()}
    median = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= EXCLUDE_BELOW * median}


def tuple_images(epoch, index):
    qidxs, pidxs, nidxs = epoch["picks"]
    return [qidxs[index], pidxs[index]] + list(nidxs[index])


def first_batches(inputs, epoch, count=3):
    """The images of an epoch's first ``count`` steps, tuple by tuple."""
    size = inputs["train"]["batch_size"]
    names = [s["name"] for s in inputs["traffic"]["images"]]
    pixels = inputs["pixels"]
    return [[[pixels[names[i]] for i in tuple_images(epoch, t)]
             for t in epoch["tuples"][k * size:(k + 1) * size]]
            for k in range(count)]


def followed(inputs):
    """The epochs the reference follows, each with the weights and Adam's
    state it starts from: epoch 0 from the draw and a fresh optimizer,
    each window epoch from its own start."""
    epochs = inputs["epochs"]
    return [(epochs[0], inputs["params0"], None)] + [
        (e, e["weights"], e["adam"]) for e in epochs[1:]]


def reference_steps(inputs, epoch, params0, state0, dtype=torch.float32):
    return training.steps(first_batches(inputs, epoch), params0,
                          inputs["ref"], inputs["train"], inputs["device"],
                          dtype, state0)


def step_gaps(losses, first, after, ref_losses, ref_first, ref_after,
              params0):
    """(loss_gap, grad_gap, delta_gap) of one run of three steps against
    another."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad_gap = _leaf_gap(first, ref_first)
    delta = {k: after[k] - params0[k] for k in ref_first}
    ref_delta = {k: ref_after[k] - params0[k] for k in ref_first}
    delta_gap = _leaf_gap(delta, ref_delta, _kept(ref_first))
    return loss_gap, grad_gap, delta_gap


def _mine_gap(inputs, epoch, rng, dtype=None):
    """The mining check of one epoch; with ``dtype``, the reference in it
    against the float32 reference instead of the program."""
    names = [s["name"] for s in inputs["traffic"]["images"]]
    ref = inputs["ref"]
    gap = 0.0
    with torch.no_grad():
        for indices, vecs in epoch["mined"]:
            picks = rng.choice(len(indices), min(ref["sample_mine"],
                                                 len(indices)),
                               replace=False)
            for j in picks:
                img = torch.from_numpy(np.ascontiguousarray(
                    inputs["pixels"][names[indices[j]]])).to(
                        inputs["device"])
                want = training.describe(img, ref, epoch["weights"])
                got = vecs[:, j] if dtype is None else training.describe(
                    img, ref, epoch["weights"], dtype).cpu().numpy()
                gap = max(gap, float(np.max(np.abs(
                    got - want.cpu().numpy()))))
    return gap


def _pick_gap(inputs, epoch):
    (qidx, qvecs), (pool, poolvecs) = epoch["mined"]
    clusters = inputs["traffic"]["cluster"]
    qidxs, _, nidxs = epoch["picks"]
    column = {idx: c for c, idx in enumerate(pool)}
    scores = poolvecs.astype(np.float64).T @ qvecs.astype(np.float64)
    gap = 0.0
    for q in range(len(qidxs)):
        order = np.argsort(-scores[:, q], kind="stable")
        taken, want = [clusters[qidxs[q]]], []
        for c in order:
            if len(want) == len(nidxs[q]):
                break
            if clusters[pool[c]] not in taken:
                taken.append(clusters[pool[c]])
                want.append(scores[c, q])
        for k, idx in enumerate(nidxs[q]):
            got = scores[column[idx], q] if idx in column else -np.inf
            gap = max(gap, want[k] - got) if k < len(want) else np.inf
    return float(gap)


def judge(inputs, limits):
    """The comparison; returns ``correct``, ``failed``, ``compared`` and
    ``follows``, the step numbers of each followed epoch."""
    follows = []
    for epoch, params0, state0 in followed(inputs):
        ref_losses, ref_first, ref_after = reference_steps(
            inputs, epoch, params0, state0)
        follows.append(step_gaps(epoch["losses"][:3], epoch["first"],
                                 epoch["after3"], ref_losses, ref_first,
                                 ref_after, params0))
        sys.stderr.write("[bench] delta_gap over %d of %d leaves\n"
                         % (len(_kept(ref_first)), len(ref_first)))
    numbers = dict(zip(("loss_gap", "grad_gap", "delta_gap"),
                       (max(f[i] for f in follows) for i in range(3))))
    rng = np.random.default_rng([inputs["seed"], 2])
    numbers["mine_gap"] = max(_mine_gap(inputs, e, rng)
                              for e in inputs["epochs"])
    numbers["pick_gap"] = max(_pick_gap(inputs, e) for e in inputs["epochs"])
    numbers["nonfinite"] = sum(int(not np.isfinite(v))
                               for e in inputs["epochs"] for v in e["losses"])
    return dict(compare(numbers, limits), follows=follows)


def control_numbers(inputs):
    """The control's readings of a run's inputs, by number: the reference
    with its trunk in bfloat16, put in the program's place in the followed
    epochs' first three steps and in epoch 0's mining, against the float32
    reference."""
    follows = []
    for epoch, params0, state0 in followed(inputs):
        exact, low = (reference_steps(inputs, epoch, params0, state0, dtype)
                      for dtype in (torch.float32, torch.bfloat16))
        follows.append(step_gaps(*low, *exact, params0))
    out = dict(zip(("loss_gap", "grad_gap", "delta_gap"),
                   (max(f[i] for f in follows) for i in range(3))))
    out["mine_gap"] = _mine_gap(inputs, inputs["epochs"][0],
                                np.random.default_rng([inputs["seed"], 2]),
                                torch.bfloat16)
    return out


def control(inputs):
    """The control judged by the run's limits: ``correct`` has to come out
    false."""
    return compare(control_numbers(inputs), inputs["limits"])
