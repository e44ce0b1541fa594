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

Everything runs synchronously on the calling thread: chunks are copied to the
device and launched in order on the current stream, and ``finish`` copies
the descriptors back. Nothing here starts a thread or a process.
"""
import collections
import math

import numpy as np
import torch

from ..learning.wrappers import (CirMultiscaleAggregation, CirtorchWhiten,
                                 FakeBatch)
from ..models.trunks import apply_valid_mask
from ..ops import preprocess
from ..ops.clahe import aux_to_device, clahe_bucket_aux
from ..ops.resize import gather_resize, torch_resize_grid
from ..ops.whitening import whitenapply_rows

BUCKET_MULTIPLE = 64
MAX_BATCH = 16


def _round_up(v, m):
    return -(-v // m) * m


def _analyze_wrappers(network):
    """The network's eval wrappers [cirwhiten?] [cirmultiscale?] [fakebatch?]
    as (scales, whiten), the parameters the batched path computes with."""
    scales = [1]
    whiten = None
    for wrapper in network.wrappers["eval"].wrappers:
        if isinstance(wrapper, CirtorchWhiten):
            whiten = wrapper
        elif isinstance(wrapper, CirMultiscaleAggregation):
            scales = wrapper.scales
        elif not isinstance(wrapper, FakeBatch):
            raise ValueError("wrapper %r has no batched extraction"
                             % type(wrapper).__name__)
    return scales, whiten


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
                  mean=None, std=None, chain_fn=None, clahe_aux=None):
    """One chunk's descriptors: (B, H, W, C) bucket -> (B, D).

    batch is uint8 (normalised here with ``mean``/``std``, or run through
    ``chain_fn(batch, clahe_aux)``, the device chain) or float32 (already
    normalised on the host); valid_hw (B, 2) int32; grids[s] is None for
    scale 1, else (y0, y1, wy, x0, x1, wx, out_valid) of that scale.
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
    """

    def __init__(self, model, scales=(1,), msp=1.0, whiten=None,
                 normalize_mean_std=None, bucket_multiple=BUCKET_MULTIPLE,
                 max_batch=MAX_BATCH, device_chain=None):
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
        vecs = fused_forward(
            self.model, self.scales, torch.from_numpy(batch).to(self.device),
            torch.from_numpy(valid).to(self.device),
            self._grids(shapes, bsz, bucket), self.msp, self.P, self.m,
            self.mean, self.std, self.chain_fn, clahe_aux)
        self.chunks += 1
        self.results.append(([i for i, _ in items], vecs))

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


def extract_vectors_batched(model, arrays, scales=(1,), msp=1.0, whiten=None,
                            bucket_multiple=BUCKET_MULTIPLE,
                            max_batch=MAX_BATCH, normalize_mean_std=None):
    """Multi-scale descriptors of a list of HWC arrays. Returns (D, N).

    What the per-image wrapper loop computes: per scale s each image is
    resized bilinearly (exact torch grid), pooled with its valid extent,
    aggregated as (mean over scales of v^msp)^(1/msp), L2-normalised, then
    optionally whitened (P (x - m), L2). Runs where the model's weights are.
    """
    extractor = StreamingExtractor(
        model, scales=scales, msp=msp, whiten=whiten,
        normalize_mean_std=normalize_mean_std,
        bucket_multiple=bucket_multiple, max_batch=max_batch)
    for i, arr in enumerate(arrays):
        extractor.add(i, arr)
    return extractor.finish(len(arrays))


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
    that ``transform`` produced on the host.
    """
    scales, whiten = _analyze_wrappers(network)
    model = network.model
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
        device_chain=chain)


def extract_vectors_network(network, images, image_size, transform,
                            bbxs=None, batch_size=MAX_BATCH):
    """(D, N) descriptors of image files through ``network``'s batched path.

    Images are decoded here (PIL), cropped to their bounding box and shrunk
    to ``image_size`` on their longer side.
    """
    from ..data.images import ImagesFromList

    network.eval()
    extractor = network_extractor(network, transform, batch_size)
    uint8 = extractor.host_dtype == np.uint8
    dataset = ImagesFromList(images, imsize=image_size, bbxs=bbxs,
                             transform=None if uint8 else transform)
    for i in range(len(dataset)):
        extractor.add(i, dataset.uint8(i) if uint8 else dataset[i])
    return extractor.finish(len(images))
