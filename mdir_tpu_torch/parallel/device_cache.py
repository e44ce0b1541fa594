"""Device-resident uint8 image cache and the mining -> train hand-off (the
port of ``mdir_tpu/parallel/device_cache.py``).

Hard-negative mining re-extracts a fixed pool of images every epoch, and
validation the same database: the descriptors change with the network, the
pixels do not. The cache keeps each image's padded uint8 payload (the
extractor's bucket-padded host array, any channel count) on the card, keyed
by ``"<path>@<image_size>"``, so that a hit skips the load, the resize and
the host-to-device copy. A hit is the same bytes a fresh copy would bring,
so a chunk assembled from the cache is bit-identical to a host-padded one.

The budget is in bytes (``budget_mb`` * 1e6; scenario key
``device_cache_mb``, 0 is off), eviction strict LRU; hits, misses and
evictions count as in the JAX package (``get`` counts, ``peek`` and
``matches`` do not). There is one cache per process and card
(``shared_cache``): every consumer (the training tuples' mining, each
validation score) that asks for one gets the same object, whose budget is
the largest any of them asked for, so the card holds one budget and not
one per consumer.

``assemble`` is the hand-off: a training batch whose items mix pixels and
``CachedImageRef``s becomes one zero-padded bucket on the card, bit-equal
to ``learning/train_step.py::pad_image_batch`` of the pixels. A ref holds
its entry's tensor, so the hand-off needs no cache and an eviction after
the item was made cannot lose its pixels. PyTorch compiles nothing per
shape, so the number of distinct bucket shapes it assembles costs no
compile (the JAX package jits one program per entry and bucket shape, and
bounds them).

Everything runs on the calling thread, so the cache holds no lock.
"""
import collections

import numpy as np
import torch


def _round_up(v, m):
    return -(-int(v) // m) * m


class CachedImageRef:
    """A training item that lies in the cache: its key, valid extent
    ``(h, w)`` and entry (the padded device tensor) in place of its pixels
    (``TuplesDataset.__getitem__`` on the device-chain route); ``assemble``
    reads it."""

    __slots__ = ("key", "hw", "entry")

    def __init__(self, key, hw, entry):
        self.key = key
        self.hw = tuple(int(v) for v in hw)
        self.entry = entry

    def pixels(self):
        """The image: the entry cropped to its extent."""
        return self.entry[:self.hw[0], :self.hw[1]]


class DeviceImageCache:
    """Byte-budgeted LRU of uint8 images on ``device``, each entry padded
    to its bucket by whoever puts it (the extractor, at its multiple)."""

    def __init__(self, budget_mb, device):
        self.budget_bytes = int(budget_mb * 1e6)
        self.device = torch.device(device)
        self._entries = collections.OrderedDict()  # key -> (tensor, hw, bytes)
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def contains(self, key):
        return key in self._entries

    def shape(self, key):
        """``(h, w)``, the valid extent of a cached entry."""
        return self._entries[key][1]

    def matches(self, key, bucket_multiple):
        """Whether the entry exists and was padded at ``bucket_multiple``."""
        entry = self._entries.get(key)
        if entry is None:
            return False
        tensor, (h, w), _ = entry
        return tuple(tensor.shape[:2]) == (_round_up(h, bucket_multiple),
                                           _round_up(w, bucket_multiple))

    def peek(self, key):
        """The entry's tensor, leaving the LRU order and the counts alone."""
        return self._entries[key][0]

    def get(self, key):
        """``(tensor, (h, w))``, or None; a hit moves to the LRU's end."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry[0], entry[1]

    def put(self, key, padded, valid_hw):
        """Copy a bucket-padded uint8 host array to the device as ``key``'s
        entry, evicting the least recently used entries (never the new one)
        while the bytes exceed the budget; returns the device tensor."""
        if padded.dtype != np.uint8:
            raise ValueError("the cache holds uint8 pixels, not %s"
                             % padded.dtype)
        tensor = torch.from_numpy(np.ascontiguousarray(padded)).to(
            self.device)
        if key in self._entries:
            self._bytes -= self._entries.pop(key)[2]
        self._entries[key] = (tensor, tuple(valid_hw), padded.nbytes)
        self._bytes += padded.nbytes
        while self._bytes > self.budget_bytes and len(self._entries) > 1:
            _, (_, _, nbytes) = self._entries.popitem(last=False)
            self._bytes -= nbytes
            self.evictions += 1
        return tensor

    def stats(self):
        return {"entries": len(self._entries), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    def clear(self):
        self._entries.clear()
        self._bytes = 0


def assemble(items, bucket_multiple=32):
    """A training batch's images (uint8 (H, W, C) arrays and
    ``CachedImageRef``s, at least one) -> ``(bucket (N, BH, BW, C) uint8
    on the refs' device, extents (N, 2) int32, miss_bytes)``.

    The bucket is one ``torch.zeros`` on the device, sides the largest
    extent rounded up to ``bucket_multiple``; a ref copies its entry's valid
    extent into its row (the entry is the zero-padded payload, so the row is
    what host padding gives), an array is padded to the bucket on the host
    and copied (``miss_bytes`` counts those bytes). Read-only: no cache's
    counts or LRU order move, and an array enters no cache."""
    refs = [item for item in items if isinstance(item, CachedImageRef)]
    if not refs:
        raise ValueError("assemble takes a batch with cached images")
    extents = [item.hw if isinstance(item, CachedImageRef)
               else item.shape[:2] for item in items]
    bh = _round_up(max(h for h, _ in extents), bucket_multiple)
    bw = _round_up(max(w for _, w in extents), bucket_multiple)
    channels = {item.shape[-1] if not isinstance(item, CachedImageRef)
                else item.entry.shape[-1] for item in items}
    if len(channels) != 1:  # the chain changed between the phases?
        raise ValueError("a batch of %s channels" % sorted(channels))
    device = refs[0].entry.device
    bucket = torch.zeros((len(items), bh, bw) + tuple(channels),
                         dtype=torch.uint8, device=device)
    miss_bytes = 0
    for i, (item, (h, w)) in enumerate(zip(items, extents)):
        if isinstance(item, CachedImageRef):
            bucket[i, :h, :w] = item.pixels()
            continue
        if item.dtype != np.uint8:
            raise ValueError("a batch beside cached images takes uint8 "
                             "pixels, not %s" % item.dtype)
        padded = np.zeros((bh, bw, item.shape[-1]), np.uint8)
        padded[:h, :w] = item
        miss_bytes += padded.nbytes
        bucket[i] = torch.from_numpy(padded).to(device)
    return bucket, np.asarray(extents, np.int32), miss_bytes


_SHARED = {}  # torch.device -> the process's DeviceImageCache on it


def _device_key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shared_cache(device, budget_mb):
    """The process's one cache on ``device``, or None when ``budget_mb`` is
    0 (off). Every caller gets the same object; its budget grows to the
    largest ``budget_mb`` asked for and never shrinks."""
    if not budget_mb or budget_mb <= 0:
        return None
    key = _device_key(device)
    cache = _SHARED.get(key)
    if cache is None:
        cache = _SHARED[key] = DeviceImageCache(budget_mb, key)
    cache.budget_bytes = max(cache.budget_bytes, int(budget_mb * 1e6))
    return cache
