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
statistics in the modules.

**From the device image cache** (the mining -> train hand-off, JAX
``epoch_iteration.py:135-150``): a tuple batch whose items hold
``CachedImageRef``s (``data/datasets.py``) is assembled on the card by
``parallel/device_cache.py::assemble``, each tuple's bucket on the per-tuple
route and the whole batch's on the whole-batch route, bit-equal to the
host-padded bucket; the routes then take the device tensor where they take
a numpy bucket otherwise.

**Over several cards** (``mesh``, ``parallel/mesh.py``; JAX
``train_step.py:106-146, 247-263, 322-337``) every rank holds the whole
batch's gradients after the step, and the update is the single-card
update. Under ``param_sharding: zero`` the gradients are left unreduced:
the ZeRO optimizer (``optim/optimizers.py::Optimizer.shard_state``)
reduce-scatters them.

* Per tuple, each rank takes its contiguous share of the batch's tuples
  (the tuple count must divide by the world size, as the JAX step asserts
  for its batch), the mean reduction's weights count the whole batch's
  images, and the loss and the gradients are summed over the ranks (one
  all-reduce).
* The whole batch is padded into one bucket at the whole batch's extents,
  as JAX pads it before putting it on its mesh, and each rank runs its
  contiguous rows of it (the flattened image count must divide by the
  world size, JAX's assertion; a rank's rows may cut a tuple), with the
  CLAHE tile geometry of its own images. Live BatchNorm takes the global
  batch's statistics (``models/layers.py::set_batchnorm_mesh``). The
  members' outputs are gathered to every rank with only its own rows
  carrying the graph (``Mesh.gather_live_rows``) and the criterion takes
  the whole batch's (D x N columns, or NCHW images against the replicated
  targets), so the loss is the whole batch's on every rank and is not
  summed, while each rank's gradient is its share: the sum over the ranks
  (one all-reduce) counts each image once. ``last_output`` is the whole
  batch's output.

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
float32. On a mesh the two runs' losses and gradients are summed over the
ranks before they are compared, so every rank judges the whole batch, as
JAX's guard does, and reaches the same verdict.
"""
import inspect

import numpy as np
import torch

from ..models.layers import (has_train_mode, set_batchnorm_mesh,
                             set_dropout_generator)
from ..models.trunks import apply_valid_mask
from ..ops import dtypes as dtype_policy
from ..ops.clahe import aux_to_device, clahe_bucket_aux
from ..ops.preprocess import make_bucketed_chain
from ..parallel.device_cache import CachedImageRef, assemble

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


def _tuple_bucket(images, multiple):
    """A tuple's (or a whole tuple batch's) images -> (bucket, extents):
    on the host, or on the card when one is cached."""
    if not any(isinstance(img, CachedImageRef) for img in images):
        return pad_image_batch([np.asarray(img) for img in images], multiple)
    return assemble(images, multiple)[:2]


def prepare_batch(batch_images, batch_targets,
                  bucket_multiple=BUCKET_MULTIPLE, whole=False):
    """A loader's batch -> a list of (bucket, valid_hw, targets).

    A tuple batch gives one per tuple, or with ``whole`` one of all its
    images; a bucket holding ``CachedImageRef``s is assembled on the card
    (a uint8 tensor there). An image batch gives one (JAX
    ``prepare_batch``): a stacked NHWC array as it is (``valid_hw`` None), a
    list of images stacked when they share a shape and else padded; image
    targets (3-d or more) stacked or padded alike, other targets
    concatenated.
    """
    if is_tuple_batch(batch_images):
        if whole:
            return [_tuple_bucket([img for tpl in batch_images for img in tpl],
                                  bucket_multiple)
                    + (_labels(batch_targets),)]
        return [_tuple_bucket(tpl, bucket_multiple)
                + (_labels([target]),)
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
    """The step's sharding mode: None (plain DP) or ``"zero"``."""
    sharding = runtime.get("param_sharding") if param_sharding == "auto" \
        else param_sharding
    if sharding not in (None, "dp", "none", "zero"):
        raise ValueError("unknown param_sharding %r (dp, none or zero)"
                         % (sharding,))
    return "zero" if sharding == "zero" else None


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
    ``generator`` is the Dropout masks' ``torch.Generator``; ``mesh`` shares
    each batch's tuples, or a whole-batch network's bucket rows, out over
    its ranks.
    """

    def __init__(self, network, criterion, device_chain=None,
                 compute_dtype="auto", param_sharding="auto",
                 generator=None, mesh=None):
        self.param_sharding = _check_sharding(network.network_params.runtime,
                                              param_sharding)
        self.network = network
        self.whole = whole_batch(network)
        self.mesh = mesh
        self.members = [network.networks[name] for name in network.sequence] \
            if hasattr(network, "sequence") else [network]
        for member in self.members:
            set_dropout_generator(member.model, generator)
            set_batchnorm_mesh(member.model, mesh)
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
        #: the last whole-batch step's output, the whole batch's on every
        #: rank (NCHW images of an image net), for the epoch's image samples
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
        batch = torch.as_tensor(batch).to(device)  # numpy, or from the cache
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

    def _accumulate(self, buckets, compute_dtype, elements):
        """Loss and ``.grad`` of the tuples' buckets; a mean-reduced loss
        weighted by each tuple's share of ``elements`` images."""
        total = 0.0
        for batch, valid, targets in buckets:
            loss = self.tuple_loss(batch, valid, targets, compute_dtype)
            if self.criterion.reduction == "mean":
                loss = loss * (valid.shape[0] / elements)
            loss.backward()
            total = total + loss.detach()
        return total

    def whole_loss(self, batch, valid, targets):
        """The criterion of the whole batch's bucket through every member,
        with its graph (JAX's whole-batch program). On a mesh this rank
        runs its rows of the bucket, and the criterion takes every rank's
        outputs with only its own carrying the graph."""
        device = self.network.device
        mesh = self.mesh if self.mesh is not None and self.mesh.collective \
            else None
        if mesh is not None:  # JAX asserts the same
            if batch.shape[0] % mesh.size:
                raise ValueError("batch size %d not divisible by %d devices"
                                 % (batch.shape[0], mesh.size))
            rows = mesh.rows(batch.shape[0])
            batch = batch[rows]
            valid = None if valid is None else valid[rows]
        x = torch.as_tensor(batch).to(device)  # numpy, or from the cache
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
            descriptors = "pooling" in model.meta
            x = model(x, valid_t if single else None).to(torch.float32) \
                if descriptors else model(x)
        if mesh is not None:
            x = mesh.gather_live_rows(x)
        if descriptors:
            x = x.T
        self.last_output = x.detach()
        return self.criterion(x, as_targets(targets, device))

    def _whole_gradients(self, bucket):
        """The bucket's loss; its gradients into ``.grad``, summed over the
        mesh's ranks unless ZeRO reduce-scatters them."""
        params = [p for p in self.network.trainables() if p.requires_grad]
        loss = self.whole_loss(*bucket)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if g is not None:
                    p.grad = g if p.grad is None else p.grad + g
        if self.mesh is not None and self.param_sharding != "zero":
            self.mesh.all_reduce([p.grad for p in params
                                  if p.grad is not None])
        return loss.detach()

    def gradients(self, batch_images, batch_targets):
        """Accumulate the batch's gradients into the parameters' ``.grad``;
        return the batch's loss (a 0-d tensor) and its number of items
        (tuples, or images). On a mesh the whole ``.grad`` is summed over
        the ranks, so it must hold this batch's alone (``zero_grad``
        first)."""
        if self.whole or not is_tuple_batch(batch_images):
            bucket, = prepare_batch(batch_images, batch_targets, whole=True)
            self.steps += 1
            return self._whole_gradients(bucket), len(batch_images)
        buckets = prepare_batch(batch_images, batch_targets)
        elements = sum(valid.shape[0] for _, valid, _ in buckets)
        mine = buckets
        if self.mesh is not None:  # JAX asserts the same
            if len(buckets) % self.mesh.size:
                raise ValueError("a batch of %d tuples does not divide "
                                 "over %d ranks" % (len(buckets),
                                                    self.mesh.size))
            mine = buckets[self.mesh.rows(len(buckets))]
        self.steps += 1
        if self.compute_dtype is not None and self.rearm_every \
                and self.steps > 1 \
                and (self.steps - 1) % self.rearm_every == 0:
            self.guard_pending = True
        if not self.guard_pending:
            loss = self._accumulate(mine, self.compute_dtype, elements)
        else:
            loss = self._run_dtype_guard(mine, elements)
        return self._reduce(loss), len(buckets)

    def _reduce(self, loss):
        """The loss, and the gradients unless ZeRO reduce-scatters them,
        summed over the mesh's ranks."""
        if self.mesh is None or not self.mesh.collective:
            return loss
        grads = [p.grad for p in self.network.model.parameters()
                 if p.grad is not None]
        loss = loss.reshape(1)
        self.mesh.all_reduce([loss] + ([] if self.param_sharding == "zero"
                                       else grads))
        return loss[0]

    def _run_dtype_guard(self, buckets, elements):
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
            loss = self._accumulate(buckets, dtype, elements)
            runs.append((loss, [p.grad for p in params]))
        (loss_f, grads_f), (loss_e, grads_e) = runs

        def flat(grads):
            return torch.cat([(torch.zeros_like(p) if g is None else g)
                              .reshape(-1).to(torch.float32)
                              for p, g in zip(params, grads)])

        flat_f, flat_e = flat(grads_f), flat(grads_e)
        sum_f, sum_e = (loss.detach().reshape(1).to(torch.float32)
                        for loss in (loss_f, loss_e))
        if self.mesh is not None:  # the whole batch's, alike on every rank
            self.mesh.all_reduce([sum_f, sum_e, flat_f, flat_e])
        gap = abs(float(sum_f) - float(sum_e)) \
            / max(abs(float(sum_e)), 1e-6)
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
