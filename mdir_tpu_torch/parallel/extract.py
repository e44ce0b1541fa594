"""Batched multi-scale descriptor extraction -- the eval hot path.

The port of ``mdir_tpu/parallel/extract.py``. Images are grouped into shape
buckets (sides rounded up to ``BUCKET_MULTIPLE``), zero-padded and run as
batches of up to ``MAX_BATCH``; the trunk masks each image's valid extent so
a padded image gives what it gives at its own size. Per chunk, on the device:
uint8 -> /255 -> (x - mean) / std, or the device photometric chain
(``ops/preprocess.py``: lab lattice, bucketed CLAHE with per-image cv2 tile
geometry from the host, lab -> rgb, normalize) on the full-resolution
bucket -> mask -> for each scale an exact per-image bilinear resize
(host-computed gather grids, torch ``F.interpolate(scale_factor)``
coordinates) -> masked trunk -> GeM+L2N kernel -> p-power aggregation over
scales -> L2 -> optional whitening.

A 2-net composition (a translator, then an embedder) takes its own batched
path (``ComposedExtractor``, JAX ``extract_vectors_composed``): chunks
grouped by (raw bucket, every scale's padded shape); per chunk uint8
ingress normalised once with the composition's (the head's) mean/std; per
scale one gather that does the exact scale resize and the translator's
replicate pad to its divisor at once, the translator as one batch, an
unpad gather into the 64-aligned embedder crop, the valid-extent mask (the
translator writes into the pad), the masked embedder with the GeM+L2N
kernel, then ``** msp``; the scales are summed on the host in float64,
followed by ``^(1/msp)``, L2 and Lw. A network that neither batched path
takes runs the exact per-image path: each image through the host
transform and the network's own wrappers.

Compute dtype (``ops/dtypes.py``, the network's ``runtime: compute_dtype``;
a composition's from its embedder): in bfloat16 the trunks run from a bf16
copy of each model, the input cast at the conv boundary, after the float32
resize and mask (a bf16 input to the float32-weighted gather would come out
float32 again), and the descriptors come back float32. Under ``auto`` the
first chunk also runs in float32: below the cosine bar its float32 result
is what the extractor keeps, and the run (and every later one of that
model, per process) computes float32. The exact per-image path is float32.

Everything runs synchronously on the calling thread: chunks are copied to the
device and launched in order on the current stream, and ``finish`` copies
the descriptors back. Nothing here starts a thread or a process.
"""
import collections
import math

import numpy as np
import torch

from ..device import check_compute_dtype
from ..learning.wrappers import (CirMultiscaleAggregation, CirtorchWhiten,
                                 FakeBatch, ReflectPadMakeDivisible)
from ..models.trunks import apply_valid_mask
from ..ops import dtypes as dtype_policy
from ..ops import preprocess
from ..ops.clahe import aux_to_device, clahe_bucket_aux
from ..ops.resize import gather_crop, gather_resize, torch_resize_grid
from ..ops.whitening import whitenapply_rows

BUCKET_MULTIPLE = 64
MAX_BATCH = 16


def _round_up(v, m):
    return -(-v // m) * m


def _analyze_wrappers(network):
    """The network's eval wrappers [cirwhiten?] [cirmultiscale?] [fakebatch?]
    as (scales, whiten), the parameters the batched paths compute with; None
    when a wrapper has no batched form."""
    scales = [1]
    whiten = None
    for wrapper in network.wrappers["eval"].wrappers:
        if isinstance(wrapper, CirtorchWhiten):
            whiten = wrapper
        elif isinstance(wrapper, CirMultiscaleAggregation):
            scales = wrapper.scales
        elif not isinstance(wrapper, FakeBatch):
            return None
    return scales, whiten


def _scaled(side, scale):
    """torch's floor size of ``side`` at ``scale``."""
    return side if scale == 1 else int(math.floor(side * scale))


def _plain_normalize_chain(transform):
    """(mean, std) when ``transform`` is exactly pil2np|totensor|normalize:
    the host output is then uint8 pixels normalised per channel, so the
    pixels can travel as uint8 and be normalised on the device."""
    from ..data import transforms as T

    ts = getattr(transform, "transforms", None)
    if not ts or not isinstance(ts[-1], T.Normalize):
        return None
    if not all(isinstance(t, (T.Pil2Numpy, T.ToTensor)) for t in ts[:-1]):
        return None
    norm = ts[-1]
    if not norm.params["strict_shape"]:
        return None
    return norm.params["mean"], norm.params["std"]


@torch.no_grad()
def fused_forward(model, scales, batch, valid_hw, grids, msp, P=None, m=None,
                  mean=None, std=None, chain_fn=None, clahe_aux=None,
                  compute_dtype=None):
    """One chunk's descriptors: (B, H, W, C) bucket -> (B, D) float32.

    batch is uint8 (normalised here with ``mean``/``std``, or run through
    ``chain_fn(batch, clahe_aux)``, the device chain) or float32 (already
    normalised on the host); valid_hw (B, 2) int32; grids[s] is None for
    scale 1, else (y0, y1, wy, x0, x1, wx, out_valid) of that scale.
    ``compute_dtype`` casts each scale's input to the model's dtype.
    """
    if chain_fn is not None:
        # the whole chain at full resolution in NHWC, then one permute
        x = chain_fn(batch, clahe_aux).permute(0, 3, 1, 2)
        x = apply_valid_mask(x, valid_hw)
    else:
        x = batch.permute(0, 3, 1, 2)
    if mean is not None:
        x = x.to(torch.float32) / 255.0
        x = (x - mean[None, :, None, None]) / std[None, :, None, None]
        x = apply_valid_mask(x, valid_hw)  # padding is zero after normalize
    x = x.contiguous()

    acc = None
    for scale, grid in zip(scales, grids):
        if grid is None:
            xs, v = x, valid_hw
        else:
            v = grid[-1]
            xs = apply_valid_mask(gather_resize(x, *grid[:-1]), v)
        if compute_dtype is not None:  # at the conv boundary
            xs = xs.to(compute_dtype)
        powed = model(xs, v).to(torch.float32) ** msp
        acc = powed if acc is None else acc + powed
    v = (acc / len(scales)) ** (1.0 / msp)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    return v if P is None else whitenapply_rows(v, m, P)


class StreamingExtractor:
    """Bucketed multi-scale extraction of images added one at a time.

    Each ``add`` buffers an HWC array in its shape bucket; a full bucket
    (``max_batch`` images) runs at once, and ``finish`` runs the rest and
    returns the (D, N) descriptor matrix. The model's device is where the
    work runs. With ``normalize_mean_std`` the arrays are uint8 pixels and
    the normalisation runs on the device; with ``device_chain`` (an
    ``ops.preprocess.DeviceChain``) they are uint8 RGB and the whole
    photometric chain runs on the device, with each chunk's CLAHE tile
    geometry computed here from the images' true shapes; otherwise they are
    float32 arrays normalised on the host.

    ``compute_dtype`` (a torch dtype, or None for float32) runs the chunks
    from a copy of the model in that dtype; ``dtype_guard`` checks the
    first chunk against float32 (``guard_report`` holds its least row
    cosine and verdict) unless the model's verdict is cached.
    """

    def __init__(self, model, scales=(1,), msp=1.0, whiten=None,
                 normalize_mean_std=None, bucket_multiple=BUCKET_MULTIPLE,
                 max_batch=MAX_BATCH, device_chain=None, compute_dtype=None,
                 dtype_guard=False):
        self.model = model
        self.device = model.device
        self.scales = list(scales)
        self.msp = msp
        self.bucket_multiple = bucket_multiple
        self.max_batch = max_batch
        self.P = self.m = None
        if whiten is not None:
            self.P = whiten.P[:whiten.dimensions, :].to(self.device)
            self.m = whiten.m.to(self.device)
        self.mean = self.std = None
        self.host_dtype = np.float32
        if normalize_mean_std is not None:
            self.mean, self.std = (
                torch.tensor(v, dtype=torch.float32, device=self.device)
                for v in normalize_mean_std)
            self.host_dtype = np.uint8
        self.device_chain = device_chain
        self.chain_fn = None
        if device_chain is not None:
            if normalize_mean_std is not None:
                raise ValueError("a device chain normalizes itself")
            self.chain_fn = preprocess.make_bucketed_chain(device_chain)
            self.host_dtype = np.uint8
        self.guard_pending = False
        self.guard_report = None
        if compute_dtype is not None and dtype_guard:
            decision = dtype_policy.guard_decision(model)
            if decision is False:
                compute_dtype = None
            elif decision is None:
                self.guard_pending = True
        self.compute_dtype = compute_dtype
        self.fast_model = model if compute_dtype is None \
            else dtype_policy.fast_copy(model, compute_dtype)
        self.buffers = collections.defaultdict(list)  # bucket -> [(i, arr)]
        self.saw_full = set()  # buckets that ran a full-size chunk
        self.results = []  # (indices, device descriptors)
        self.chunks = 0  # chunks run, each one forward per scale

    def _bucket(self, arr):
        return (_round_up(arr.shape[0], self.bucket_multiple),
                _round_up(arr.shape[1], self.bucket_multiple))

    def add(self, index, arr):
        arr = np.asarray(arr)
        if arr.dtype != self.host_dtype:
            raise ValueError("expected %s pixels, got %s"
                             % (np.dtype(self.host_dtype).name, arr.dtype))
        bucket = self._bucket(arr)
        self.buffers[bucket].append((index, arr))
        if len(self.buffers[bucket]) == self.max_batch:
            self._submit(bucket)

    def _grids(self, shapes, bsz, bucket):
        """Per scale: None for 1, else per-image gather grids on the device."""
        grids = []
        for scale in self.scales:
            if scale == 1:
                grids.append(None)
                continue
            oh_b = _round_up(max(int(math.floor(bucket[0] * scale)), 1),
                             self.bucket_multiple)
            ow_b = _round_up(max(int(math.floor(bucket[1] * scale)), 1),
                             self.bucket_multiple)
            y0, y1 = (np.zeros((bsz, oh_b), np.int64) for _ in range(2))
            x0, x1 = (np.zeros((bsz, ow_b), np.int64) for _ in range(2))
            wy = np.zeros((bsz, oh_b), np.float32)
            wx = np.zeros((bsz, ow_b), np.float32)
            out_valid = np.zeros((bsz, 2), np.int32)
            for bi, (ih, iw) in enumerate(shapes):
                oh = int(math.floor(ih * scale))
                ow = int(math.floor(iw * scale))
                y0[bi, :oh], y1[bi, :oh], wy[bi, :oh] = \
                    torch_resize_grid(ih, oh, scale)
                x0[bi, :ow], x1[bi, :ow], wx[bi, :ow] = \
                    torch_resize_grid(iw, ow, scale)
                out_valid[bi] = (oh, ow)
            grids.append(tuple(torch.from_numpy(a).to(self.device)
                               for a in (y0, y1, wy, x0, x1, wx, out_valid)))
        return grids

    def _submit(self, bucket):
        items = self.buffers.pop(bucket)
        # a bucket that ran (or will run) full keeps its full batch size
        if bucket in self.saw_full or len(items) == self.max_batch:
            bsz = self.max_batch
            self.saw_full.add(bucket)
        else:
            bsz = len(items)
        shapes = [arr.shape[:2] for _, arr in items]
        channels = items[0][1].shape[-1]
        valid = np.ones((bsz, 2), np.int32)
        batch = np.zeros((bsz,) + bucket + (channels,), self.host_dtype)
        for bi, (_, arr) in enumerate(items):
            valid[bi] = arr.shape[:2]
            batch[bi, :arr.shape[0], :arr.shape[1]] = arr
        clahe_aux = None
        if self.device_chain is not None \
                and self.device_chain.clahe_params is not None:
            # cv2's tile geometry per image; a filler slot takes the bucket
            clip, grid = self.device_chain.clahe_params
            clahe_aux = aux_to_device(clahe_bucket_aux(
                list(shapes) + [bucket] * (bsz - len(items)), bucket,
                clip_limit=clip, grid=grid), self.device)
        args = (torch.from_numpy(batch).to(self.device),
                torch.from_numpy(valid).to(self.device),
                self._grids(shapes, bsz, bucket), self.msp, self.P, self.m,
                self.mean, self.std, self.chain_fn, clahe_aux)
        vecs = fused_forward(self.fast_model, self.scales, *args,
                             compute_dtype=self.compute_dtype)
        if self.guard_pending:
            vecs = self._run_dtype_guard(vecs, args, len(items))
        self.chunks += 1
        self.results.append(([i for i, _ in items], vecs))

    def _run_dtype_guard(self, fast, args, n):
        """The first chunk's float32 cross-check (JAX ``_run_dtype_guard``):
        the same chunk through the float32 model; if the fast rows drift
        below the cosine bar, the float32 chunk is returned and this run
        (and, through the cached verdict, every later one of the model)
        computes float32."""
        self.guard_pending = False
        exact = fused_forward(self.model, self.scales, *args)
        ok = dtype_policy.cosine_rows_ok(fast[:n], exact[:n])
        self.guard_report = _guard_report(fast[:n], exact[:n], ok,
                                          "extraction")
        dtype_policy.record_guard_decision(self.model, ok)
        if ok:
            return fast
        self.compute_dtype = None
        self.fast_model = self.model
        return exact

    def finish(self, n):
        """Run the partial buckets; return the (D, N) descriptors (numpy)."""
        for bucket in list(self.buffers.keys()):
            self._submit(bucket)
        if not self.results:
            raise ValueError("no images were added")
        dim = self.results[0][1].shape[1]
        out = np.zeros((n, dim), np.float32)
        for indices, vecs in self.results:
            host = vecs.cpu().numpy()
            for bi, i in enumerate(indices):
                out[i] = host[bi]
        self.results = []
        return out.T


def _guard_report(fast, exact, ok, kind):
    """The guard's least row cosine and verdict; a rejection is printed."""
    least = float(dtype_policy.row_cosines(fast, exact).min())
    if not ok:
        print(">> %s bfloat16 guard: least row cosine %.6f against float32 "
              "(bar %g); computing float32 from here on"
              % (kind, least, dtype_policy.GUARD_MIN_COSINE))
    return {"min_cosine": least, "ok": ok}


def extract_vectors_batched(model, arrays, scales=(1,), msp=1.0, whiten=None,
                            bucket_multiple=BUCKET_MULTIPLE,
                            max_batch=MAX_BATCH, normalize_mean_std=None):
    """Multi-scale descriptors of HWC arrays (a list, or any iterable,
    consumed as it goes). Returns (D, N).

    What the per-image wrapper loop computes: per scale s each image is
    resized bilinearly (exact torch grid), pooled with its valid extent,
    aggregated as (mean over scales of v^msp)^(1/msp), L2-normalised, then
    optionally whitened (P (x - m), L2). Runs where the model's weights are.
    """
    extractor = StreamingExtractor(
        model, scales=scales, msp=msp, whiten=whiten,
        normalize_mean_std=normalize_mean_std,
        bucket_multiple=bucket_multiple, max_batch=max_batch)
    n = 0
    for n, arr in enumerate(arrays, 1):
        extractor.add(n - 1, arr)
    return extractor.finish(n)


def _has_photometric_step(transform):
    """Whether ``transform`` has a step that only the device chain runs."""
    from ..data import transforms as T

    return any(isinstance(t, (T.ApplyClahe, T.AddClaheFromRgb,
                              T.ToColorspace))
               for t in getattr(transform, "transforms", None) or ())


def network_extractor(network, transform, batch_size=MAX_BATCH):
    """A StreamingExtractor for ``network``'s eval wrappers and ``transform``.

    With a plain pil2np|totensor|normalize transform of 3 channels the
    extractor takes uint8 pixels and normalises on the device; with a
    photometric chain (CLAHE, tospace) it takes uint8 RGB and runs the
    chain on the device (``ops.preprocess.chain_from_transform``), and a
    chain that does not lower raises; otherwise it takes float32 arrays
    that ``transform`` produced on the host. The compute dtype and its guard
    come from the network's runtime (``ops.dtypes.resolve_compute_dtype``).
    """
    analyzed = _analyze_wrappers(network)
    if analyzed is None:
        raise ValueError("the eval wrappers of %s have no batched extraction"
                         % type(network).__name__)
    scales, whiten = analyzed
    model = network.model
    compute_dtype, dtype_guard = dtype_policy.resolve_compute_dtype(
        network.network_params.runtime, model.device)
    mean_std = _plain_normalize_chain(transform)
    if mean_std is not None and len(mean_std[0]) != 3:
        mean_std = None
    chain = None
    if mean_std is None and _has_photometric_step(transform):
        chain = preprocess.chain_from_transform(transform)
        if chain is None:
            raise NotImplementedError(
                "transform %r has no device chain, and the port runs CLAHE "
                "and colorspace steps only there (%s)"
                % (transform, preprocess.NOT_PORTED))
    return StreamingExtractor(
        model, scales=scales,
        msp=CirMultiscaleAggregation.msp(model, len(scales)), whiten=whiten,
        max_batch=batch_size, normalize_mean_std=mean_std,
        device_chain=chain, compute_dtype=compute_dtype,
        dtype_guard=dtype_guard)


def _plain_ingress(transform):
    """(mean, std) when ``transform`` lets 3-channel uint8 pixels travel and
    be normalised on the device; None for a host transform. A photometric
    step raises: it runs only as the device chain, which a composition does
    not take."""
    mean_std = _plain_normalize_chain(transform)
    if mean_std is not None and len(mean_std[0]) == 3:
        return mean_std
    if _has_photometric_step(transform):
        raise NotImplementedError(
            "transform %r has no host path in the port (%s)"
            % (transform, preprocess.NOT_PORTED))
    return None


def composed_pack_grids(rh, rw, scale, divisor, ph, pw):
    """One image's packed rows for a composed chunk: ``(ypack (ph, 4),
    xpack (pw, 4), (sh, sw))``, per axis ``[idx0, idx1, weight,
    unpad-shift]`` as float32: the exact scale-resize grid (torch floor
    sizes) composed with the translator's replicate pad to ``divisor``
    (floor at top/left), and the shift that moves the translated image back
    to the origin (JAX ``composed_pack_grids``)."""
    sh, sw = _scaled(rh, scale), _scaled(rw, scale)
    top = (_round_up(sh, divisor) - sh) // 2
    left = (_round_up(sw, divisor) - sw) // 2
    if scale == 1:
        gy0, gy1, gwy = np.arange(sh), np.arange(sh), np.zeros(sh)
        gx0, gx1, gwx = np.arange(sw), np.arange(sw), np.zeros(sw)
    else:
        gy0, gy1, gwy = torch_resize_grid(rh, sh, scale)
        gx0, gx1, gwx = torch_resize_grid(rw, sw, scale)
    ypack = np.zeros((ph, 4), np.float32)
    xpack = np.zeros((pw, 4), np.float32)
    sy = np.clip(np.arange(ph) - top, 0, sh - 1)
    sx = np.clip(np.arange(pw) - left, 0, sw - 1)
    ypack[:, 0], ypack[:, 1], ypack[:, 2] = gy0[sy], gy1[sy], gwy[sy]
    xpack[:, 0], xpack[:, 1], xpack[:, 2] = gx0[sx], gx1[sx], gwx[sx]
    ypack[:, 3] = np.clip(np.arange(ph) + top, 0, ph - 1)
    xpack[:, 3] = np.clip(np.arange(pw) + left, 0, pw - 1)
    return ypack, xpack, (sh, sw)


def composed_crop_hws(raw_bucket, pads, scales,
                      granularity=BUCKET_MULTIPLE):
    """Per scale, the embedder's crop of a composed chunk: the raw bucket's
    scaled extent rounded up to ``granularity`` and clipped to the
    translator's pad. The masked embedder makes any covering crop exact."""
    out = []
    for scale, (ph, pw) in zip(scales, pads):
        sh, sw = (_scaled(side, scale) for side in raw_bucket)
        out.append((min(ph, _round_up(max(sh, 1), granularity)),
                    min(pw, _round_up(max(sw, 1), granularity))))
    return tuple(out)


@torch.no_grad()
def composed_forward(translate, embed, batch, packs, crop_hws, msp,
                     mean=None, std=None, compute_dtype=None):
    """One composed chunk: (B, H, W, C) raw bucket -> (S, B, D) per-scale
    descriptors ** msp, float32.

    batch is uint8 (normalised here with ``mean``/``std``) or float32
    (normalised on the host); packs[s] is (valid (B, 2), ypack (B, PH, 4),
    xpack (B, PW, 4)) of scale s on the device; translate maps (B, C, PH,
    PW) images to images, embed (images, valid) to (B, D) descriptors.
    ``compute_dtype`` casts the translator's padded input after the
    float32 gather (JAX: a float32 input against a bf16 transposed-conv
    kernel fails) and the embedder's masked crop.
    """
    x = batch.permute(0, 3, 1, 2)
    if mean is not None:
        x = x.to(torch.float32) / 255.0
        x = (x - mean[None, :, None, None]) / std[None, :, None, None]
    x = x.contiguous()
    out = []
    for (valid, ypack, xpack), (ch, cw) in zip(packs, crop_hws):
        ys, xs = ypack.to(torch.int64), xpack.to(torch.int64)
        padded = gather_resize(x, ys[..., 0], ys[..., 1], ypack[..., 2],
                               xs[..., 0], xs[..., 1], xpack[..., 2])
        if compute_dtype is not None:
            padded = padded.to(compute_dtype)
        translated = gather_crop(translate(padded), ys[:, :ch, 3],
                                 xs[:, :cw, 3])
        crop = apply_valid_mask(translated, valid)
        if compute_dtype is not None:
            crop = crop.to(compute_dtype)
        vecs = embed(crop, valid)
        out.append(vecs.to(torch.float32) ** msp)
    return torch.stack(out)


class ComposedExtractor:
    """Bucketed multi-scale extraction through a 2-net composition of
    images added one at a time (JAX ``extract_vectors_composed``).

    The translator's pad divisor comes from its eval wrapper
    (``reflectpad_divisible``), the scales and whitening from the
    composition's. ``translate`` and ``embed`` are the two models' forward
    calls. With ``normalize_mean_std`` the arrays are uint8 pixels and the
    normalisation runs on the device, otherwise they are float32 arrays
    normalised on the host. The compute dtype comes from the embedder's
    runtime; in bfloat16 both models run from bf16 copies, and under
    ``auto`` the first chunk's (S, B, D) rows are held against float32
    under the guard kind ``composed`` (JAX ``extract.py:1240-1268``).
    """

    def __init__(self, network, normalize_mean_std=None,
                 bucket_multiple=BUCKET_MULTIPLE, max_batch=MAX_BATCH):
        if not _composable(network):
            raise ValueError("%s has no composed batched extraction"
                             % type(network).__name__)
        head, tail = (network.networks[name] for name in network.sequence)
        pad = head.wrappers["eval"].wrappers
        self.divisor = pad[0].divisible_by if pad else 1
        self.scales, self.whiten = _analyze_wrappers(network)
        self.msp = CirMultiscaleAggregation.msp(tail.model, len(self.scales))
        compute_dtype, dtype_guard = dtype_policy.resolve_compute_dtype(
            tail.network_params.runtime, tail.model.device)
        self.guard_pending = False
        self.guard_report = None
        if compute_dtype is not None and dtype_guard:
            decision = dtype_policy.guard_decision(tail.model, "composed")
            if decision is False:
                compute_dtype = None
            elif decision is None:
                self.guard_pending = True
        self.compute_dtype = compute_dtype
        self.models = (head.model, tail.model)  # float32
        self.translate, self.embed = self.models if compute_dtype is None \
            else (dtype_policy.fast_copy(m, compute_dtype)
                  for m in self.models)
        self.device = tail.model.device
        self.dim = tail.meta["out_channels"]
        self.bucket_multiple = bucket_multiple
        self.max_batch = max_batch
        self.mean = self.std = None
        self.host_dtype = np.float32
        if normalize_mean_std is not None:
            self.mean, self.std = (
                torch.tensor(v, dtype=torch.float32, device=self.device)
                for v in normalize_mean_std)
            self.host_dtype = np.uint8
        self.buffers = collections.defaultdict(list)  # key -> [(i, arr)]
        self.results = []  # (indices, (S, B, D) device descriptors ** msp)
        self.chunks = 0

    def _key(self, arr):
        """(raw bucket, every scale's translator pad) of an image."""
        rh, rw = arr.shape[:2]
        pads = tuple(tuple(_round_up(_scaled(side, s), self.divisor)
                           for side in (rh, rw)) for s in self.scales)
        return (_round_up(rh, self.bucket_multiple),
                _round_up(rw, self.bucket_multiple)), pads

    def add(self, index, arr):
        arr = np.asarray(arr)
        if arr.dtype != self.host_dtype:
            raise ValueError("expected %s pixels, got %s"
                             % (np.dtype(self.host_dtype).name, arr.dtype))
        key = self._key(arr)
        self.buffers[key].append((index, arr))
        if len(self.buffers[key]) == self.max_batch:
            self._submit(key)

    def _submit(self, key):
        items = self.buffers.pop(key)
        raw_bucket, pads = key
        bsz = len(items)
        batch = np.zeros((bsz,) + raw_bucket + (items[0][1].shape[-1],),
                         self.host_dtype)
        for bi, (_, arr) in enumerate(items):
            batch[bi, :arr.shape[0], :arr.shape[1]] = arr
        packs = []
        for scale, (ph, pw) in zip(self.scales, pads):
            valid = np.ones((bsz, 2), np.int32)
            ypack = np.zeros((bsz, ph, 4), np.float32)
            xpack = np.zeros((bsz, pw, 4), np.float32)
            for bi, (_, arr) in enumerate(items):
                ypack[bi], xpack[bi], valid[bi] = composed_pack_grids(
                    arr.shape[0], arr.shape[1], scale, self.divisor, ph, pw)
            packs.append(tuple(torch.from_numpy(a).to(self.device)
                               for a in (valid, ypack, xpack)))
        args = (torch.from_numpy(batch).to(self.device), packs,
                composed_crop_hws(raw_bucket, pads, self.scales), self.msp,
                self.mean, self.std)
        vecs = composed_forward(self.translate, self.embed, *args,
                                compute_dtype=self.compute_dtype)
        if self.guard_pending:
            # the first chunk against float32: the stacked (S, B, D) rows
            # compare along their last axis
            self.guard_pending = False
            exact = composed_forward(*self.models, *args)
            ok = dtype_policy.cosine_rows_ok(vecs, exact)
            self.guard_report = _guard_report(vecs, exact, ok, "composed")
            dtype_policy.record_guard_decision(self.models[1], ok,
                                               "composed")
            if not ok:
                self.compute_dtype = None
                self.translate, self.embed = self.models
                vecs = exact
        self.chunks += 1
        self.results.append(([i for i, _ in items], vecs))

    def finish(self, n):
        """Run the partial chunks; return the (D, N) descriptors (numpy):
        the scales summed in float64, ``^(1/msp)``, L2, then Lw on the
        device."""
        for key in list(self.buffers.keys()):
            self._submit(key)
        if not self.results:
            raise ValueError("no images were added")
        acc = np.zeros((n, self.dim), np.float64)
        for indices, vecs in self.results:
            host = vecs.to(torch.float64).cpu().numpy()
            for bi, i in enumerate(indices):
                acc[i] += host[:, bi].sum(axis=0)
        self.results = []
        acc = (acc / len(self.scales)) ** (1.0 / self.msp)
        acc = acc / np.linalg.norm(acc, axis=1, keepdims=True)
        out = acc.T.astype(np.float32)
        if self.whiten is not None:
            out = self.whiten.postprocess(
                torch.from_numpy(out).to(self.device), None, None)
            out = out.cpu().numpy()
        return out


def _composable(network):
    """Whether a network takes the composed batched path: two networks, a
    translator with no eval wrapper or one pad to a divisor, an embedder
    with a global pool, and wrappers the batched path computes (JAX
    ``_composable_sequential``)."""
    if not hasattr(network, "sequence") or len(network.sequence) != 2 \
            or _analyze_wrappers(network) is None:
        return False
    head, tail = (network.networks[name] for name in network.sequence)
    if hasattr(head, "sequence"):
        return False
    pad = head.wrappers["eval"].wrappers
    if pad and not (len(pad) == 1
                    and isinstance(pad[0], ReflectPadMakeDivisible)):
        return False
    meta = tail.model.meta
    return meta.get("pooling") in ("gem", "mac", "spoc") \
        and not meta["regional"]


def _decoded(images, image_size, bbxs, transform, uint8, loader=None):
    """The images as arrays: uint8 pixels, or the host transform's output.
    ``images`` is a list of paths, decoded by ``loader`` (by default
    ``data.images.pil_loader``), or of decoded (H, W, 3) uint8 arrays,
    taken as they are (no crop, no resize)."""
    from ..data.images import ImagesFromList, pil_loader

    if len(images) and isinstance(images[0], np.ndarray):
        return iter(images) if uint8 else (transform(a) for a in images)
    dataset = ImagesFromList(images, imsize=image_size, bbxs=bbxs,
                             transform=None if uint8 else transform,
                             loader=loader or pil_loader)
    return (dataset.uint8(i) if uint8 else dataset[i]
            for i in range(len(dataset)))


def extract_vectors_composed(network, images, image_size, transform,
                             bbxs=None, max_batch=MAX_BATCH, loader=None):
    """(D, N) descriptors of images (paths, or uint8 HWC arrays) through a
    2-net composition's batched path."""
    mean_std = _plain_ingress(transform)
    extractor = ComposedExtractor(network, normalize_mean_std=mean_std,
                                  max_batch=max_batch)
    for i, arr in enumerate(_decoded(images, image_size, bbxs, transform,
                                     mean_std is not None, loader)):
        extractor.add(i, arr)
    return extractor.finish(len(images))


def extract_vectors_per_image(network, images, image_size, transform,
                              bbxs=None, loader=None):
    """(D, N) descriptors by the exact per-image path (JAX
    ``extract.py:980-988``): each image through the host transform, then
    ``network(image)`` with the network's own wrappers."""
    tail = network.networks[network.sequence[-1]] \
        if hasattr(network, "sequence") else network
    check_compute_dtype(tail.network_params.runtime.get("compute_dtype"))
    out = np.zeros((network.meta["out_channels"], len(images)), np.float32)
    for i, arr in enumerate(_decoded(images, image_size, bbxs, transform,
                                     False, loader)):
        out[:, i] = network(arr).reshape(-1).cpu().numpy()
    return out


def extract_vectors_network(network, images, image_size, transform,
                            bbxs=None, batch_size=MAX_BATCH, loader=None):
    """(D, N) descriptors of image files (or uint8 HWC arrays) through
    ``network``.

    A 2-net composition takes the composed batched path, a retrieval net
    with the whiten/multiscale wrappers the single-net batched path, and any
    other network the exact per-image path. Files are decoded here by
    ``loader`` (by default PIL), cropped to their bounding box and shrunk
    to ``image_size`` on their longer side.
    """
    network.eval()
    if _composable(network):
        return extract_vectors_composed(network, images, image_size,
                                        transform, bbxs=bbxs,
                                        max_batch=batch_size, loader=loader)
    if hasattr(network, "sequence") or _analyze_wrappers(network) is None \
            or "pooling" not in network.model.meta:
        return extract_vectors_per_image(network, images, image_size,
                                         transform, bbxs=bbxs, loader=loader)
    extractor = network_extractor(network, transform, batch_size)
    uint8 = extractor.host_dtype == np.uint8
    for i, arr in enumerate(_decoded(images, image_size, bbxs, transform,
                                     uint8, loader)):
        extractor.add(i, arr)
    return extractor.finish(len(images))
