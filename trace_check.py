#!/usr/bin/env python3
"""A ``torch.profiler`` trace of the port's lab CLAHE eval pass, and the
device image cache's mining, on one NVIDIA card.

    python3 trace_check.py

Builds the port's kernels through ``mdir_tpu_torch._build`` (every source
at once), then, each part inside a ``tools.profiling.timed`` line:

  1. one pass of ``chip_smoke.py``'s phase 7 path (its 40 images at image
     size 1024, the VGG16-GeM, ``apply_clahe:4:lab:8``, scales 1, 2^-1/2
     and 1/2, Lw, float32) after an untimed warm-up, inside
     ``tools.profiling.trace``: the trace is written under
     ``build/mdir_tpu_torch/trace/``, and the ten CUDA operations with the
     most device time in its ``key_averages()`` and the port's four
     kernels are printed beside the sum of all device time and the pass's
     wall time;
  2. phase 9's database (60 images at 1024) mined with that net for three
     epochs with ``device_cache_mb`` 512 and three without, the two runs
     taking turns from the same seeds (the cached run first in even
     epochs, second in odd ones), after an untimed warm-up: per
     epoch, images/s, the cache's hits and misses of the epoch and the
     pixel bytes copied to the card. The two runs must pick the same
     negatives from bit-equal descriptors, and the cached run must hit
     from its second epoch;
  3. a ``device_memory_profile`` snapshot, its size printed.

Exits non-zero when a part fails or finds no device time. Prints the
card's name and power limit last. Needs a card.
"""
import contextlib
import io
import os
import pickle
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

CACHE_MB = 512
EPOCHS = 3
TOP_OPS = 10
# the port's kernels on the traced path, by their CUDA names
PORT_KERNELS = ("gem_l2n_kernel", "lab_n_kernel", "tile_luts_kernel",
                "interp_kernel")


def _device_ms(row):
    """A profiler row's own device time in ms."""
    return row.self_device_time_total / 1e3


def _device_rows(prof):
    """The rows of the card's own events (kernels, copies, fills), most
    device time first: a host operator's row repeats its kernels' time."""
    rows = [row for row in prof.key_averages()
            if row.device_type == torch.autograd.DeviceType.CUDA
            and _device_ms(row) > 0]
    return sorted(rows, key=lambda row: -_device_ms(row))


def trace_pass(device, network, transform, db, queries, trace_dir):
    """Part 1: the traced pass. Returns its descriptors."""
    from chip_smoke import check
    from mdir_tpu_torch.parallel.extract import network_extractor
    from mdir_tpu_torch.tools.profiling import timed, trace

    def one_pass():
        out = []
        for images in (db, queries):
            extractor = network_extractor(network, transform)
            check(extractor.device_chain is not None,
                  "the lab CLAHE device chain")
            for i, img in enumerate(images):
                extractor.add(i, img)
            out.append(extractor.finish(len(images)))
        return out

    n_images = len(db) + len(queries)
    with timed("warm-up pass, %d images" % n_images, device=device):
        one_pass()
    with timed("pass without the profiler", device=device):
        one_pass()
    with timed("traced pass and the trace's export", device=device), \
            trace(trace_dir, device=device) as prof:
        t = time.perf_counter()
        out = one_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(_device_ms(row) for row in rows)
    check(busy_ms > 0, "the profiler saw device time")
    for v in out:
        check(np.isfinite(v).all(), "finite descriptors of the traced pass")
    print("trace %s (%.1f MB): device busy %.1f ms in kernels and copies, "
          "the pass %.1f ms wall under the profiler (%.1f images/s)"
          % (prof.trace_path, os.path.getsize(prof.trace_path) / 1e6,
             busy_ms, wall_ms, n_images / wall_ms * 1e3), flush=True)
    port = [row for row in rows
            if any(name in row.key for name in PORT_KERNELS)]
    check(len(port) >= len(PORT_KERNELS), ("the port's kernels traced",
                                           [row.key for row in port]))
    for title, shown in (("the %d costliest" % TOP_OPS, rows[:TOP_OPS]),
                         ("the port's kernels", port)):
        print(" %s:" % title, flush=True)
        for row in shown:
            print("  %9.3f ms %5.1f%% %6d calls  %s"
                  % (_device_ms(row), 100 * _device_ms(row) / busy_ms,
                     row.count, row.key[:110]), flush=True)
    return out


def mining(device, network, transform, trace_dir):
    """Part 2: cached and uncached mining of phase 9's database."""
    from chip_smoke import (IMAGE_SIZE, SEED, TRAIN_NEG_NUM, TRAIN_PAIRS,
                            TRAIN_POOL_SIZE, TRAIN_QUERY_SIZE, check,
                            smoke_loader, train_images)
    from mdir_tpu_torch.data.datasets import TuplesDataset
    from mdir_tpu_torch.parallel.extract import StreamingExtractor
    from mdir_tpu_torch.tools.profiling import timed

    names = sorted(train_images())
    db_pkl = os.path.join(trace_dir, "db.pkl")
    with open(db_pkl, "wb") as handle:
        pickle.dump({"train": {
            "cids": ["/smoke/%s" % name for name in names],
            "cluster": [i // 2 for i in range(len(names))],
            "qidxs": [2 * k for k in range(TRAIN_PAIRS)],
            "pidxs": [2 * k + 1 for k in range(TRAIN_PAIRS)]}}, handle)

    def dataset(cache_mb):
        return TuplesDataset(
            "retrieval-SfM-smoke", "train", imsize=IMAGE_SIZE,
            nnum=TRAIN_NEG_NUM, qsize=TRAIN_QUERY_SIZE,
            poolsize=TRAIN_POOL_SIZE, transform=transform,
            loader=smoke_loader, dataset_pkl=db_pkl, device_cache_mb=cache_mb)

    uploaded = []
    finish = StreamingExtractor.finish

    def counted_finish(extractor, n):
        out = finish(extractor, n)
        uploaded.append(extractor.uploaded_bytes)
        return out

    def mine(ds, seed):
        """(seconds, pixel bytes copied) of one epoch's mining."""
        uploaded.clear()
        np.random.seed(seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                mock.patch.object(StreamingExtractor, "finish",
                                  counted_finish):
            ds.create_epoch_tuples(network)
        torch.cuda.synchronize()
        return time.perf_counter() - t, sum(uploaded)

    n_mined = TRAIN_QUERY_SIZE + TRAIN_POOL_SIZE
    with timed("mining warm-up", device=device):
        mine(dataset(0), SEED + 100)
    cached, plain = dataset(CACHE_MB), dataset(0)
    before = {"hits": 0}
    for epoch in range(EPOCHS):
        readings = []
        runs = (("cached", cached), ("uncached", plain))
        for name, ds in runs if epoch % 2 == 0 else runs[::-1]:
            with timed("mining epoch %d %s" % (epoch, name), device=device):
                seconds, nbytes = mine(ds, SEED + epoch)
            readings.append((name, seconds, nbytes))
        stats = cached.device_cache.stats()
        hits = stats["hits"] - before["hits"]
        before = stats
        # a miss is an image loaded and put in the cache (the cache's own
        # ``misses`` count the training tuples' lookups only)
        for name, seconds, nbytes in readings:
            print("epoch %d %-8s %d images %.3f s %.2f images/s; %s%.1f MB "
                  "copied to the card"
                  % (epoch, name, n_mined, seconds, n_mined / seconds,
                     "hits %d, misses %d; " % (hits, n_mined - hits)
                     if name == "cached" else "", nbytes / 1e6), flush=True)
        check(cached.nidxs == plain.nidxs, ("the same negatives", epoch))
        for key in ("qvecs", "poolvecs"):
            check(np.array_equal(cached.mined[key], plain.mined[key]),
                  ("bit-equal mining descriptors", epoch, key))
        check(hits > 0 if epoch else True, ("cache hits", epoch, stats))
    print("cache after %d epochs: %s" % (EPOCHS, cached.device_cache.stats()),
          flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("trace_check: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import (CLAHE_DIM, CLAHE_MODEL, CLAHE_TRANSFORM,
                            FLOAT32_RUNTIME, SCALES, SEED, check, make_images)
    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.device import resolve_device
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.tools.profiling import device_memory_profile, timed

    device = resolve_device("cuda")
    trace_dir = os.path.join(_build.BUILD_ROOT, "trace")
    os.makedirs(trace_dir, exist_ok=True)
    with timed("build", device=device):
        _build.build(_build.sources())
    rng = np.random.RandomState(SEED)
    db, queries, _ = make_images(rng)
    whiten_path = os.path.join(trace_dir, "whiten_vgg16.pkl")
    with open(whiten_path, "wb") as handle:
        pickle.dump({"P": np.eye(CLAHE_DIM)
                     + 0.01 * rng.randn(CLAHE_DIM, CLAHE_DIM),
                     "m": 0.01 * rng.randn(CLAHE_DIM, 1)}, handle)
    model = initialize_model(CLAHE_MODEL, device=device, seed=SEED)
    transform = initialize_transforms(CLAHE_TRANSFORM,
                                      (model.meta["mean"], model.meta["std"]))
    network = CirNetwork(model, CirNetwork.NetworkParams(
        model=dict(CLAHE_MODEL), runtime={
            "wrappers": {"train": None, "eval": {
                "0_cirwhiten": {"whitening": whiten_path,
                                "dimensions": None},
                "1_cirmultiscale": {"scales": SCALES}}},
            **FLOAT32_RUNTIME}), frozen=True)
    trace_pass(device, network, transform, db, queries, trace_dir)
    # mining runs the scenario's training net: single scale, no Lw
    miner = CirNetwork(model, CirNetwork.NetworkParams(
        model=dict(CLAHE_MODEL), runtime={
            "wrappers": {"train": None, "eval": ""}, **FLOAT32_RUNTIME}),
        frozen=True)
    mining(device, miner, transform, trace_dir)
    with timed("device memory profile", device=device):
        path = device_memory_profile(
            os.path.join(trace_dir, "memory_snapshot.pickle"), device=device)
    size = os.path.getsize(path)
    check(size > 0, "a device memory snapshot")
    print("device memory snapshot %s: %.2f MB (peak allocated %.2f GB)"
          % (path, size / 1e6, torch.cuda.max_memory_allocated() / 1e9))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip())


if __name__ == "__main__":
    main()
