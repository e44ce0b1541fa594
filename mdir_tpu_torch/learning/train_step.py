"""One training step of a network over a loader's batch: the gradients
the caller's optimizer steps on, and the batch's loss.

The JAX package computes a batch as one compiled program over one padded
bucket of all the batch's images (``mdir_tpu/learning/train_step.py``), and
the reference as per-image backwards that accumulate gradients before one
optimizer step ("fakebatch", ``mdir/learning/epoch_iteration.py:46-75``).
The port has two routes.

**Per tuple**, for a single net without a train mode (a ``CirNetwork``:
frozen BatchNorm, no Dropout) on a tuple batch: each tuple's images (query,
positive, negatives) are padded into their own bucket (sides rounded up to
``BUCKET_MULTIPLE``), run forward and backward, and their gradients
accumulate in ``.grad``. That is the whole-batch step, because

* the losses are sums of per-tuple terms: a tuple's columns take their query
  and positive from the same tuple, so the contrastive and triplet sums over
  the batch are the sums of the tuples' sums (a mean-reduced criterion is
  weighted by the tuple's share of the batch's elements);
* BatchNorm is frozen (running statistics, ``models/layers.py``) and the
  net has no dropout, so one image's descriptor does not depend on the
  other images of its batch;
* the valid-extent masks make a padded image compute what it computes at its
  own size, so the bucket a tuple is padded to does not matter.

Only the order of float32 sums differs. Activation memory is bounded by one
tuple (7 images at ``neg_num`` 5), where the JAX package needs
``jax.checkpoint`` above 2^24 input elements. Per tuple: the uint8 bucket
goes through the device chain (``ops/preprocess.py``; CLAHE with each
image's cv2 tile geometry from ``clahe_bucket_aux``), is masked to the
valid extents, runs the trunk with the extents, the GeM + L2N head under
autograd (its plain version), and the criterion on D x N columns.

**The whole batch as one bucket**, as the JAX package's program runs it,
for a ``SequentialNetwork`` and for any net with a train mode (live
BatchNorm or Dropout > 0: a U-Net), whose images are coupled through the
batch's statistics, and for every image batch (image-to-image training on
``(input, target)`` pairs: stacked, or padded with the targets padded
alongside). A tuple batch's flattened images are padded into one bucket;
the chain runs and then the mask, where there is a chain; then the members
in sequence, those that are not frozen in train mode and the frozen ones in
eval mode. As JAX's ``_apply_model(model, p, out, None, ...)`` does, a
composition's members get no valid extents (its embedder pools the whole
padded map); a single net gets them. The criterion takes D x N columns of a
descriptor net, NCHW images of an image net. Gradients go to the
parameters of the members that are not frozen (``torch.autograd.grad``),
so a frozen embedder's weights get none. Dropout draws from the generator
the caller gives (``generator``); live BatchNorm moves its running
statistics in the modules. ``param_sharding: zero`` (ROADMAP §1.7) raises.

Compute dtype (``ops/dtypes.py``; JAX ``train_step.py:39-100,268-299``): in
bfloat16 only the trunk runs in bf16, from its float32 master parameters
cast inside the differentiated call (``torch.func.functional_call``), so
the gradients land on the float32 parameters; the head takes float32
features (``head_dtype``) and the loss stays float32. Not ``torch.autocast``:
it keeps frozen BatchNorm and some ops in float32 and casts per op, another
program than the reference's. A ``SequentialNetwork``, a module with a train
mode (live BatchNorm, Dropout) or without the head seam trains in float32,
whatever the runtime asks. Under ``auto`` the first step, and every
``TRAIN_GUARD_REARM``-th after it, also runs in float32: unless the bf16
gradient is finite, its loss within 5 % and its flattened gradient at
cosine >= 0.95 of float32's, the float32 result is kept and training stays
float32.
"""
import inspect

import numpy as np
import torch

from ..models.layers import has_train_mode, set_dropout_generator
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


def is_tuple_batch(batch_images):
    return isinstance(batch_images, list) and bool(batch_images) \
        and isinstance(batch_images[0], list)


def _labels(targets):
    return np.concatenate([np.asarray(t, np.float32).reshape(-1)
                           for t in targets])


def prepare_batch(batch_images, batch_targets,
                  bucket_multiple=BUCKET_MULTIPLE, whole=False):
    """A loader's batch -> a list of (bucket, valid_hw, targets).

    A tuple batch gives one per tuple, or with ``whole`` one of all its
    images. An image batch gives one (JAX ``prepare_batch``): a stacked NHWC
    array as it is (``valid_hw`` None), a list of images stacked when they
    share a shape and else padded; image targets (3-d or more) stacked or
    padded alike, other targets concatenated.
    """
    if is_tuple_batch(batch_images):
        if whole:
            return [pad_image_batch(
                [np.asarray(img) for tpl in batch_images for img in tpl],
                bucket_multiple) + (_labels(batch_targets),)]
        return [pad_image_batch([np.asarray(img) for img in tpl],
                                bucket_multiple) + (_labels([target]),)
                for tpl, target in zip(batch_images, batch_targets)]
    if not isinstance(batch_images, list):
        return [(np.asarray(batch_images), None, np.asarray(batch_targets))]
    flat = [np.asarray(img) for img in batch_images]
    if len({img.shape for img in flat}) == 1:
        batch, valid = np.stack(flat), None
    else:
        batch, valid = pad_image_batch(flat, bucket_multiple)
    if isinstance(batch_targets, list) and batch_targets \
            and hasattr(batch_targets[0], "shape") \
            and np.asarray(batch_targets[0]).ndim >= 3:
        targets = [np.asarray(t) for t in batch_targets]
        targets = np.stack(targets) if len({t.shape for t in targets}) == 1 \
            else pad_image_batch(targets, bucket_multiple)[0]
    elif isinstance(batch_targets, list):
        targets = _labels(batch_targets)
    else:
        targets = np.asarray(batch_targets)
    return [(batch, valid, targets)]


def as_targets(targets, device):
    """Targets as a tensor on ``device``: NHWC image targets as NCHW."""
    targets = torch.as_tensor(np.asarray(targets), device=device)
    if targets.dim() == 4:
        targets = targets.permute(0, 3, 1, 2)
    return targets


def whole_batch(network):
    """Whether a network trains on the whole batch as one bucket: a
    composition, or a net with a train mode."""
    return hasattr(network, "sequence") or has_train_mode(network.model)


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
        and not has_train_mode(model)


class TrainStep:
    """Loss and accumulated gradients of a batch for one network.

    ``compute_dtype`` "auto" takes the network runtime's; ``guard_reports``
    lists each guard run's loss gap, gradient cosine and verdict;
    ``generator`` is the Dropout masks' ``torch.Generator``.
    """

    def __init__(self, network, criterion, device_chain=None,
                 compute_dtype="auto", param_sharding="auto",
                 generator=None):
        _check_sharding(network.network_params.runtime, param_sharding)
        self.network = network
        self.whole = whole_batch(network)
        self.members = [network.networks[name] for name in network.sequence] \
            if hasattr(network, "sequence") else [network]
        for member in self.members:
            set_dropout_generator(member.model, generator)
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
        #: the last whole-batch step's output (NCHW images of an image net),
        #: for the epoch's image samples
        self.last_output = None

    def chain(self, batch, valid):
        """The device chain of one uint8 bucket (NHWC float32, unmasked);
        a float bucket normalised on the host passes through."""
        if self.chain_fn is None:
            return batch
        aux = None
        if self.device_chain.clahe_params is not None:
            clip, grid = self.device_chain.clahe_params
            extents = [tuple(int(x) for x in v) for v in valid] \
                if valid is not None else [batch.shape[1:3]] * len(batch)
            aux = aux_to_device(clahe_bucket_aux(
                extents, batch.shape[1:3], clip_limit=clip, grid=grid),
                batch.device)
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

    def whole_loss(self, batch, valid, targets):
        """The criterion of one bucket through every member, with its graph
        (JAX's whole-batch program)."""
        device = self.network.device
        x = torch.from_numpy(batch).to(device)
        valid_t = None if valid is None \
            else torch.from_numpy(valid).to(device)
        x = self.chain(x, valid).permute(0, 3, 1, 2)
        if self.chain_fn is not None and valid is not None:
            x = apply_valid_mask(x, valid_t)
        x = x.contiguous()
        single = len(self.members) == 1
        for member in self.members:
            model = member.model
            model.train(not member.frozen)
            if "pooling" in model.meta:
                x = model(x, valid_t if single else None).to(torch.float32).T
            else:
                x = model(x)
        self.last_output = x.detach()
        return self.criterion(x, as_targets(targets, device))

    def _whole_gradients(self, bucket):
        params = [p for p in self.network.trainables() if p.requires_grad]
        loss = self.whole_loss(*bucket)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if g is not None:
                    p.grad = g if p.grad is None else p.grad + g
        return loss.detach()

    def gradients(self, batch_images, batch_targets):
        """Accumulate the batch's gradients into the parameters' ``.grad``;
        return the batch's loss (a 0-d tensor) and its number of items
        (tuples, or images)."""
        if self.whole or not is_tuple_batch(batch_images):
            bucket, = prepare_batch(batch_images, batch_targets, whole=True)
            self.steps += 1
            return self._whole_gradients(bucket), len(batch_images)
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
