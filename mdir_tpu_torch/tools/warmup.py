"""Warm an extraction up before it is timed (``mdir_tpu/tools/warmup.py``).

The JAX package compiles one program per shape bucket and batch; the port
compiles nothing per shape, but a first chunk on the card pays for cuDNN's
algorithm search of each new conv shape, the allocator's growth and the
kernels' first build and load. ``warmup_extraction`` runs one full chunk of
blank images per given shape through a ``StreamingExtractor`` built as the
timed run builds it, so a timed pass starts warm::

    from mdir_tpu_torch.tools.warmup import bucket_shapes, warmup_extraction

    warmup_extraction(model, shapes=bucket_shapes(shapes),
                      scales=(1, 2 ** -0.5, 0.5), mean_std=(mean, std))
"""
import numpy as np


def bucket_shapes(shapes, bucket_multiple=64):
    """The distinct shape buckets (sides rounded up) of image shapes."""
    round_up = lambda v: -(-v // bucket_multiple) * bucket_multiple
    return sorted({(round_up(h), round_up(w)) for h, w in shapes})


def warmup_extraction(model, shapes, scales=(1,), max_batch=None,
                      mean_std=None, compute_dtype=None, msp=3.0,
                      device_chain=None):
    """Run one full chunk (``max_batch`` blank images) per shape; returns
    the shapes run. The images are uint8 RGB when the extractor normalises
    or runs ``device_chain`` on the device, else float32 of the model's
    input channels."""
    from ..parallel.extract import MAX_BATCH, StreamingExtractor

    max_batch = max_batch or MAX_BATCH
    extractor = StreamingExtractor(
        model, scales=scales, msp=msp, normalize_mean_std=mean_std,
        device_chain=device_chain, compute_dtype=compute_dtype,
        max_batch=max_batch)
    channels = 3 if extractor.host_dtype == np.uint8 \
        else model.meta.get("in_channels", 3)
    index = 0
    warmed = []
    for h, w in sorted(set(shapes)):
        for _ in range(max_batch):
            extractor.add(index, np.zeros((h, w, channels),
                                          extractor.host_dtype))
            index += 1
        warmed.append((h, w))
    extractor.finish(index)
    return warmed
