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
gradient. Training runs in float32: ``compute_dtype: bfloat16`` (ROADMAP
§1.2) and ``param_sharding: zero`` (ROADMAP §1.7) raise.
"""
import numpy as np
import torch

from ..device import check_compute_dtype
from ..models.trunks import apply_valid_mask
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


def _check_runtime(runtime, compute_dtype, param_sharding):
    check_compute_dtype(runtime.get("compute_dtype")
                        if compute_dtype == "auto" else compute_dtype)
    sharding = runtime.get("param_sharding") if param_sharding == "auto" \
        else param_sharding
    if sharding not in (None, "dp", "none"):
        raise NotImplementedError(
            "param_sharding %r needs the multi-card path (ROADMAP §1.7)"
            % (sharding,))


class TrainStep:
    """Loss and accumulated gradients of a tuple batch for one network."""

    def __init__(self, network, criterion, device_chain=None,
                 compute_dtype="auto", param_sharding="auto"):
        _check_runtime(network.network_params.runtime, compute_dtype,
                       param_sharding)
        self.network = network
        self.criterion = criterion
        self.device_chain = device_chain
        self.chain_fn = make_bucketed_chain(device_chain) \
            if device_chain is not None else None

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

    def tuple_loss(self, batch, valid, targets):
        """The criterion of one tuple's bucket, with its graph."""
        device = self.network.device
        batch = torch.from_numpy(batch).to(device)
        valid_t = torch.from_numpy(valid).to(device)
        x = self.chain(batch, valid)
        x = apply_valid_mask(x.permute(0, 3, 1, 2), valid_t).contiguous()
        out = self.network.model(x, valid_t).to(torch.float32)
        return self.criterion(out.T, torch.from_numpy(targets).to(device))

    def gradients(self, batch_images, batch_targets):
        """Accumulate the batch's gradients into the parameters' ``.grad``;
        return the batch's loss (a 0-d tensor) and its number of tuples."""
        buckets = prepare_batch(batch_images, batch_targets)
        elements = sum(valid.shape[0] for _, valid, _ in buckets)
        total = 0.0
        for batch, valid, targets in buckets:
            loss = self.tuple_loss(batch, valid, targets)
            if self.criterion.reduction == "mean":
                loss = loss * (valid.shape[0] / elements)
            loss.backward()
            total = total + loss.detach()
        return total, len(buckets)
