"""Batched image -> image inference for the infer stage's rgb output --
``mdir_tpu/parallel/translate.py`` on the port.

Each image is padded as ``ReflectPadMakeDivisible`` pads it (edge pixels
replicated, centred, to the network's divisor: ``divisible_padding``, JAX
``_centered_pad``), and images are grouped by padded shape. A group that
reaches ``MAX_BATCH`` runs as one batched forward of the model; ``finish``
runs the partial groups. In eval mode a conv does
not couple the images of a batch, so each result is what the per-image
path computes, up to the convolution algorithm cuDNN picks for the batch
size. With ``mean_std`` (a plain pil2np | totensor | normalize chain) the
pixels travel as uint8 and are normalised on the device in the host
transform's order of operations (/255, - mean, / std).

As in the JAX package, ``depth`` batches stay in flight: a batch's
upload, forward and float32 download are queued on the card's stream
(through pinned host memory, without blocking), and the oldest batch is
drained only once a newer one is queued, so the host's padding and its
conversion of finished images overlap the card's forwards. Results are
cropped back to each image's shape and handed, in launch order, as float32
(1, H, W, C) arrays to ``sink(index, input, output)``; the saver converts
them to uint8 on the host (``host_u8_image`` is that conversion). The JAX
package can convert on its device and download uint8 behind a run-wide
guard; the port downloads float32, so it needs no guard. Everything runs on
the calling thread.
"""
import collections

import numpy as np
import torch

from ..learning.wrappers import ReflectPadMakeDivisible, divisible_padding
from ..tools.imgtools import _tensor_to_image

MAX_BATCH = 4  # images of one padded shape per forward (JAX's default)


def host_u8_image(out_f32, mean_np, std_np):
    """The host denormalise -> uint8 conversion of an HWC float32 output:
    the saver's (``tools.imgtools``) for a plain RGB chain."""
    return _tensor_to_image(out_f32, (mean_np, std_np), "")


def _translator_divisor(network):
    """The pad divisor when the network's eval wrappers are batchable, else
    None: no wrapper (divisor 1), or exactly one ReflectPadMakeDivisible
    (two stacked pads are not one pad to their product). A composition is
    not a translator here."""
    compose = getattr(network, "wrappers", None)
    if compose is None or hasattr(network, "sequence"):
        return None
    wrappers = compose["eval"].wrappers
    if not wrappers:
        return 1
    if len(wrappers) == 1 and isinstance(wrappers[0], ReflectPadMakeDivisible):
        return wrappers[0].divisible_by
    return None


class StreamingTranslator:
    """Batch same-padded-shape images through one forward per group.

    ``add(index, array)`` takes HWC inputs: uint8 with ``mean_std``
    (normalised on the device), else float32 (transformed on the host).
    Results go to ``sink(index, input_1hwc, output_1hwc)`` once ``depth``
    newer batches are queued; ``finish()`` runs the rest and drains every
    batch. ``batches`` counts the forwards.
    """

    def __init__(self, network, sink, mean_std=None, depth=2):
        self.divisor = _translator_divisor(network)
        if self.divisor is None:
            raise ValueError("the network's eval wrappers are not batchable")
        self.model = network.model
        self.device = network.device
        self.sink = sink
        self.mean_std = mean_std
        if mean_std is not None:
            self._mean, self._std = (
                torch.tensor(v, dtype=torch.float32, device=self.device)
                for v in mean_std)
            self._mean_np, self._std_np = (np.asarray(v, np.float32)
                                           for v in mean_std)
        self.depth = depth
        self.groups = {}  # padded shape -> [(index, raw, padding)]
        self.inflight = collections.deque()  # (host output, done, group)
        self.batches = 0

    def add(self, index, array):
        array = np.asarray(array)
        if array.ndim == 4:
            array = array[0]
        padding = divisible_padding(array.shape[:2], self.divisor)
        padded_shape = (array.shape[0] + padding[2] + padding[3],
                        array.shape[1] + padding[0] + padding[1])
        group = self.groups.setdefault(padded_shape, [])
        group.append((index, array, padding))
        if len(group) >= MAX_BATCH:
            self._launch(self.groups.pop(padded_shape))

    @torch.no_grad()
    def _launch(self, group):
        batch = torch.from_numpy(np.stack([
            np.pad(arr, ((pad[2], pad[3]), (pad[0], pad[1]), (0, 0)),
                   mode="edge")
            for _, arr, pad in group]))
        on_card = self.device.type == "cuda"
        if on_card:
            batch = batch.pin_memory()
        x = batch.to(self.device, non_blocking=True)
        if self.mean_std is not None:
            x = (x.float() / 255.0 - self._mean) / self._std
        out = self.model(x.permute(0, 3, 1, 2).contiguous())
        out = out.permute(0, 2, 3, 1).contiguous()
        done = None
        if on_card:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            out = host
        self.batches += 1
        self.inflight.append((out, done, group))
        while len(self.inflight) > self.depth:
            self._drain_one()

    def _drain_one(self):
        out, done, group = self.inflight.popleft()
        if done is not None:
            done.synchronize()
        for row, (index, arr, pad) in zip(out.numpy(), group):
            cropped = row[pad[2]:row.shape[0] - pad[3],
                          pad[0]:row.shape[1] - pad[1]]
            if self.mean_std is not None:
                arr = (arr.astype(np.float32) / 255.0
                       - self._mean_np) / self._std_np
            self.sink(index, arr[None], cropped[None])

    def finish(self):
        for shape in list(self.groups):
            self._launch(self.groups.pop(shape))
        while self.inflight:
            self._drain_one()
