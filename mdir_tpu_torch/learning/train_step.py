"""One training step of a retrieval net over a batch of tuples.

The JAX package computes a batch as one compiled program over one padded
bucket of all the batch's images (``mdir_tpu/learning/train_step.py``), and
the reference as per-image backwards that accumulate gradients before one
optimizer step ("fakebatch", ``mdir/learning/epoch_iteration.py:46-75``).
The port runs one tuple at a time: each tuple's images (query, positive,
negatives) are padded into their own bucket (sides rounded up to
``BUCKET_MULTIPLE``), run forward and backward, and their gradients
accumulate in ``.grad``; the caller then takes one optimizer step.

This is the whole-batch step, because

* the losses are sums of per-tuple terms: a tuple's columns take their query
  and positive from the same tuple, so the contrastive and triplet sums over
  the batch are the sums of the tuples' sums (a mean-reduced criterion is
  weighted by the tuple's share of the batch's elements);
* BatchNorm is frozen (running statistics, ``models/layers.py``) and the
  nets have no dropout, so one image's descriptor does not depend on the
  other images of its batch;
* the valid-extent masks make a padded image compute what it computes at its
  own size, so the bucket a tuple is padded to does not matter.

Only the order of float32 sums differs. Activation memory is bounded by one
tuple (7 images at ``neg_num`` 5), where the JAX package needs
``jax.checkpoint`` above 2^24 input elements.

Per tuple: the uint8 bucket goes through the device chain
(``ops/preprocess.py``; CLAHE with each image's cv2 tile geometry from
``clahe_bucket_aux``), is masked to the valid extents, runs the trunk with
the extents, the GeM + L2N head under autograd (its plain version), and the
criterion on D x N columns. The chain's kernels take uint8 input and need no
gradient. ``param_sharding: zero`` (ROADMAP §1.7) raises.

Compute dtype (``ops/dtypes.py``; JAX ``train_step.py:39-100,268-299``): in
bfloat16 only the trunk runs in bf16, from its float32 master parameters
cast inside the differentiated call (``torch.func.functional_call``), so
the gradients land on the float32 parameters; the head takes float32
features (``head_dtype``) and the loss stays float32. Not ``torch.autocast``:
it keeps frozen BatchNorm and some ops in float32 and casts per op, another
program than the reference's. A ``SequentialNetwork``, a module with a train
mode (Dropout) or without the head seam trains in float32. Under ``auto``
the first step, and every ``TRAIN_GUARD_REARM``-th after it, also runs in
float32: unless the bf16 gradient is finite, its loss within 5 % and its
flattened gradient at cosine >= 0.95 of float32's, the float32 result is
kept and training stays float32.
"""
import inspect

import numpy as np
import torch

from ..models.trunks import apply_valid_mask
from ..ops import dtypes as dtype_policy
from ..ops.clahe import aux_to_device, clahe_bucket_aux
from ..ops.preprocess import make_bucketed_chain

BUCKET_MULTIPLE = 32


def pad_image_batch(images, multiple=BUCKET_MULTIPLE):
    """HWC arrays -> one zero-padded (N, H, W, C) bucket and (N, 2) extents."""
    round_up = lambda v: -(-v // multiple) * multiple
    bh = round_up(max(img.shape[0] for img in images))
    bw = round_up(max(img.shape[1] for img in images))
    dtype = np.uint8 if images[0].dtype == np.uint8 else np.float32
    batch = np.zeros((len(images), bh, bw, images[0].shape[-1]), dtype)
    valid = np.zeros((len(images), 2), np.int32)
    for i, img in enumerate(images):
        batch[i, :img.shape[0], :img.shape[1]] = img
        valid[i] = img.shape[:2]
    return batch, valid


def prepare_batch(batch_images, batch_targets,
                  bucket_multiple=BUCKET_MULTIPLE):
    """A loader's tuple batch -> one (bucket, valid_hw, targets) per tuple."""
    if not (isinstance(batch_images, list) and batch_images
            and isinstance(batch_images[0], list)):
        raise NotImplementedError(
            "the port trains on tuple batches; image batches (image-to-image "
            "nets) come with ROADMAP §1.6")
    return [pad_image_batch([np.asarray(img) for img in tpl],
                            bucket_multiple)
            + (np.asarray(target, np.float32).reshape(-1),)
            for tpl, target in zip(batch_images, batch_targets)]


def _check_sharding(runtime, param_sharding):
    sharding = runtime.get("param_sharding") if param_sharding == "auto" \
        else param_sharding
    if sharding not in (None, "dp", "none"):
        raise NotImplementedError(
            "param_sharding %r needs the multi-card path (ROADMAP §1.7)"
            % (sharding,))


def _bf16_trainable(network):
    """Whether a network's step may run its trunk in a fast dtype: one
    model with the head seam and no train mode (JAX ``TrainStep``'s
    exclusions)."""
    model = getattr(network, "model", None)
    return not hasattr(network, "sequence") and model is not None \
        and hasattr(model, "features") \
        and "head_dtype" in inspect.signature(model.forward).parameters \
        and not any(isinstance(m, torch.nn.Dropout) and m.p > 0
                    for m in model.modules())


class TrainStep:
    """Loss and accumulated gradients of a tuple batch for one network.

    ``compute_dtype`` "auto" takes the network runtime's; ``guard_reports``
    lists each guard run's loss gap, gradient cosine and verdict.
    """

    def __init__(self, network, criterion, device_chain=None,
                 compute_dtype="auto", param_sharding="auto"):
        _check_sharding(network.network_params.runtime, param_sharding)
        self.network = network
        self.criterion = criterion
        self.device_chain = device_chain
        self.chain_fn = make_bucketed_chain(device_chain) \
            if device_chain is not None else None
        runtime = dict(network.network_params.runtime)
        if compute_dtype != "auto":
            runtime["compute_dtype"] = compute_dtype
        dtype, guard = dtype_policy.resolve_compute_dtype(runtime,
                                                          network.device)
        if dtype is not None and not _bf16_trainable(network):
            dtype, guard = None, False
        self.guard_pending = False
        if dtype is not None and guard:
            decision = dtype_policy.guard_decision(network.model, "train")
            if decision is False:
                dtype = None
            elif decision is None:
                self.guard_pending = True
        self.compute_dtype = dtype
        self.rearm_every = dtype_policy.TRAIN_GUARD_REARM \
            if dtype is not None and guard else 0
        self.steps = 0
        self.guard_reports = []

    def chain(self, batch, valid):
        """The device chain of one uint8 bucket (NHWC float32, unmasked);
        a float bucket normalised on the host passes through."""
        if self.chain_fn is None:
            return batch
        aux = None
        if self.device_chain.clahe_params is not None:
            clip, grid = self.device_chain.clahe_params
            aux = aux_to_device(clahe_bucket_aux(
                [tuple(int(x) for x in v) for v in valid], batch.shape[1:3],
                clip_limit=clip, grid=grid), batch.device)
        return self.chain_fn(batch, aux)

    def tuple_loss(self, batch, valid, targets, compute_dtype=None):
        """The criterion of one tuple's bucket, with its graph; with
        ``compute_dtype`` the trunk runs in it from cast master weights."""
        device = self.network.device
        batch = torch.from_numpy(batch).to(device)
        valid_t = torch.from_numpy(valid).to(device)
        x = self.chain(batch, valid)
        x = apply_valid_mask(x.permute(0, 3, 1, 2), valid_t).contiguous()
        model = self.network.model
        if compute_dtype is None:
            out = model(x, valid_t)
        else:
            out = torch.func.functional_call(
                model, dtype_policy.cast_trunk(model, compute_dtype),
                (x.to(compute_dtype), valid_t),
                {"head_dtype": torch.float32})
        out = out.to(torch.float32)
        return self.criterion(out.T, torch.from_numpy(targets).to(device))

    def _accumulate(self, buckets, compute_dtype):
        elements = sum(valid.shape[0] for _, valid, _ in buckets)
        total = 0.0
        for batch, valid, targets in buckets:
            loss = self.tuple_loss(batch, valid, targets, compute_dtype)
            if self.criterion.reduction == "mean":
                loss = loss * (valid.shape[0] / elements)
            loss.backward()
            total = total + loss.detach()
        return total

    def gradients(self, batch_images, batch_targets):
        """Accumulate the batch's gradients into the parameters' ``.grad``;
        return the batch's loss (a 0-d tensor) and its number of tuples."""
        buckets = prepare_batch(batch_images, batch_targets)
        self.steps += 1
        if self.compute_dtype is not None and self.rearm_every \
                and self.steps > 1 \
                and (self.steps - 1) % self.rearm_every == 0:
            self.guard_pending = True
        if not self.guard_pending:
            return self._accumulate(buckets, self.compute_dtype), len(buckets)
        return self._run_dtype_guard(buckets), len(buckets)

    def _run_dtype_guard(self, buckets):
        """The batch in the fast dtype and in float32, each into its own
        gradients (the ones already accumulated set aside and added back):
        the fast result is kept when its gradient is finite, its loss within
        ``TRAIN_GUARD_LOSS_RTOL`` and its flattened gradient at cosine >=
        ``TRAIN_GUARD_MIN_COSINE`` of float32's, else the float32 result,
        and the step computes float32 from here on."""
        self.guard_pending = False
        params = [p for p in self.network.model.parameters()
                  if p.requires_grad]
        before = [p.grad for p in params]
        runs = []
        for dtype in (self.compute_dtype, None):
            for p in params:
                p.grad = None
            loss = self._accumulate(buckets, dtype)
            runs.append((loss, [p.grad for p in params]))
        (loss_f, grads_f), (loss_e, grads_e) = runs

        def flat(grads):
            return torch.cat([(torch.zeros_like(p) if g is None else g)
                              .reshape(-1).to(torch.float32)
                              for p, g in zip(params, grads)])

        flat_f, flat_e = flat(grads_f), flat(grads_e)
        gap = abs(float(loss_f) - float(loss_e)) \
            / max(abs(float(loss_e)), 1e-6)
        cosine = float(dtype_policy.row_cosines(flat_f, flat_e))
        finite = bool(torch.isfinite(flat_f).all())
        ok = finite and gap <= dtype_policy.TRAIN_GUARD_LOSS_RTOL \
            and dtype_policy.cosine_rows_ok(
                flat_f[None], flat_e[None],
                dtype_policy.TRAIN_GUARD_MIN_COSINE)
        self.guard_reports.append({"step": self.steps, "loss_gap": gap,
                                   "grad_cosine": cosine, "finite": finite,
                                   "ok": ok})
        dtype_policy.record_guard_decision(self.network.model, ok, "train")
        if not ok:
            print(">> bfloat16 train guard: loss gap %.3g, gradient cosine "
                  "%.6f (finite %s) against float32; training float32 from "
                  "here on" % (gap, cosine, finite))
            self.compute_dtype = None
        loss, grads = runs[0] if ok else runs[1]
        for p, old, g in zip(params, before, grads):
            p.grad = g if old is None else (old if g is None else old + g)
        return loss
