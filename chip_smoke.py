#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mdir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # no arguments, no environment variables

Phases, one line each with its wall time:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every CUDA source of the port into
     build/mdir_tpu_torch/ (seconds, registers, shared memory);
  3. kernel: the GeM+L2N kernel against its plain PyTorch version on the
     card, at the extraction shapes, ragged valid extents included;
  4. main path: the validate path of a ResNet101-GeM (2048-d, random weights
     from a seed, p = 3, Lw whitening, scales 1, 2^-1/2, 1/2, image size
     1024) on 32 database and 8 query uint8 images made from a seed:
     CirNetwork + wrappers -> StreamingExtractor (uint8 ingress) ->
     rank_database -> compute_map. The JPEG decode of the validate stage is
     left out (it needs PIL; the CPU tests drive it). The descriptors must
     be finite and of unit norm, the kernel must have launched once per
     (chunk x scale) forward, and the same run with the plain pool on the
     card must agree within 1e-4 with the same top-10 ranks; a small input
     must agree with the CPU run of the same network;
  5. the kernel at the main path's own shapes, and its time against its
     plain version and its bound.
Then one JSON line of kernels, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failure raises (non-zero exit, no last
line). Without a card, or without the port beside it, it fails at once.
"""
import sys

sys.dont_write_bytecode = True  # write nothing outside build/mdir_tpu_torch

import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from unittest import mock  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
IMAGE_SIZE = 1024
SCALES = [1, 2 ** -0.5, 0.5]
KERNEL_SHAPES = [(16, 2048, 32, 24), (16, 2048, 23, 17), (3, 2048, 7, 9)]
RTOL, ATOL = 1e-5, 1e-6  # kernel against its plain version
DESC_ATOL = 1e-4  # descriptors, kernel pool against plain pool
TIMED_LAUNCHES = 100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
F32_FLOP_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
MODEL = {"architecture": "cirnet", "cir_architecture": "resnet101",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
# database shapes (rows, cols): 16 in the (1024, 768) bucket make one full
# chunk of 16; queries are smaller crops
DB_SHAPES = [(1024, 768)] * 12 + [(1000, 750)] * 4 + [(768, 1024)] * 8 \
    + [(683, 1024)] * 8
QUERY_SHAPES = [(900, 700)] * 4 + [(600, 800)] * 4
TEMPLATES = 8

T0 = time.perf_counter()


def say(phase, text):
    print("[%6.1fs] %-6s %s" % (time.perf_counter() - T0, phase, text),
          flush=True)


def check(ok, what):
    """Fail the run (asserts vanish under python -O; this does not)."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: %s" % (what,))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches=TIMED_LAUNCHES, warmup=5):
    """Mean device time of ``fn`` over ``launches`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def gem_bound_ms(shape, valid):
    """Least time of masked GeM+L2N on these inputs, and what bounds it:
    every valid cell read once and N*C floats written (plus extents and p),
    against ~3 float operations per valid cell (clamp, pow, add)."""
    n, c = shape[:2]
    h, w = shape[2:]
    cells = int(sum(min(max(int(vh), 0), h) * min(max(int(vw), 0), w)
                    for vh, vw in valid.tolist()))
    nbytes = 4 * (cells * c + n * c + 2 * n + 1)
    ops = 3 * cells * c
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def ragged_valid(gen, n, h, w, device):
    valid = torch.stack([torch.randint(1, h + 1, (n,), generator=gen),
                         torch.randint(1, w + 1, (n,), generator=gen)], 1)
    valid[0] = torch.tensor([h, w])
    valid[-1] = torch.tensor([1, 1])
    return valid.to(torch.int32).to(device)


def kernel_against_plain(pooling_kernel, gem_l2n_plain, x, valid, p):
    with torch.no_grad():
        out = pooling_kernel.gem_l2n(x, valid, p)
        ref = gem_l2n_plain(x, valid, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    return float((out - ref).abs().max())


def make_images(rng):
    """Smooth colour fields (one per template) cropped at mixed aspect
    ratios with noise: the images of one template are each other's
    positives."""
    import torch.nn.functional as F

    fields = F.interpolate(
        torch.from_numpy(rng.rand(TEMPLATES, 3, 6, 8).astype(np.float32)),
        size=(IMAGE_SIZE + 64, IMAGE_SIZE + 64), mode="bilinear",
        align_corners=False).numpy().transpose(0, 2, 3, 1)

    def crop(t, shape):
        h, w = shape
        y, x = rng.randint(0, fields.shape[1] - h), \
            rng.randint(0, fields.shape[2] - w)
        img = fields[t, y:y + h, x:x + w] * 255 + rng.randn(h, w, 3) * 8
        return np.clip(img, 0, 255).astype(np.uint8)

    db_templates = [i % TEMPLATES for i in range(len(DB_SHAPES))]
    db = [crop(t, s) for t, s in zip(db_templates, DB_SHAPES)]
    q_templates = [i % TEMPLATES for i in range(len(QUERY_SHAPES))]
    queries = [crop(t, s) for t, s in zip(q_templates, QUERY_SHAPES)]
    gnd = [{"ok": [i for i, d in enumerate(db_templates) if d == t],
            "junk": []} for t in q_templates]
    return db, queries, gnd


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; it runs on a card only")
    # the port is imported only now: a copy of this file alone fails here
    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.device import resolve_device
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.ops import pooling_kernel
    from mdir_tpu_torch.ops.pooling import gem_l2n_plain
    from mdir_tpu_torch.ops.ranking import compute_map, rank_database
    from mdir_tpu_torch.parallel.extract import network_extractor

    device = resolve_device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say("device", "%s | torch %s, CUDA %s" % (smi, torch.__version__,
                                              torch.version.cuda))

    # 2. build
    t = time.perf_counter()
    built = _build.build(_build.sources())
    for name, library in built.items():
        say("build", "%s: %.1f s (nvcc %.1f s)" % (
            name, time.perf_counter() - t, library.seconds))
        kernel = "?"
        for line in library.ptxas.splitlines():
            entry = re.search(r"entry function '_Z(\d+)", line)
            if entry:
                kernel = line[entry.end():entry.end() + int(entry.group(1))]
            elif "Used" in line:
                say("build", "  %s: %s" % (kernel,
                                           line.split(":", 1)[1].strip()))

    # 3. kernel against plain at the extraction shapes
    gen = torch.Generator().manual_seed(SEED)
    p = torch.tensor([3.0], device=device)
    max_err = 0.0
    for shape in KERNEL_SHAPES:
        x = torch.rand(shape, generator=gen).to(device)
        valid = ragged_valid(gen, shape[0], shape[2], shape[3], device)
        err = kernel_against_plain(pooling_kernel, gem_l2n_plain, x, valid, p)
        max_err = max(max_err, err)
        say("kernel", "gem_l2n %s ragged: max |kernel - plain| %.2e"
            % (shape, err))

    # 4. the main path
    rng = np.random.RandomState(SEED)
    db, queries, gnd = make_images(rng)
    whiten_dir = os.path.join(_build.BUILD_ROOT, "smoke")
    os.makedirs(whiten_dir, exist_ok=True)
    whiten_path = os.path.join(whiten_dir, "whiten_seed%d.pkl" % SEED)
    dim = 2048
    with open(whiten_path + ".tmp", "wb") as handle:
        pickle.dump({"P": np.eye(dim) + 0.01 * rng.randn(dim, dim),
                     "m": 0.01 * rng.randn(dim, 1)}, handle)
    os.replace(whiten_path + ".tmp", whiten_path)
    model = initialize_model(MODEL, device=device, seed=SEED)
    network = CirNetwork(model, CirNetwork.NetworkParams(
        model=dict(MODEL),
        runtime={"wrappers": {"train": None, "eval": {
            "0_cirwhiten": {"whitening": whiten_path, "dimensions": None},
            "1_cirmultiscale": {"scales": SCALES}}}}), frozen=True)
    transform = initialize_transforms("pil2np | totensor | normalize",
                                      (model.meta["mean"], model.meta["std"]))

    def run_path():
        """Database and query descriptors, ranks; returns also the chunks."""
        out, chunks = [], 0
        for images in (db, queries):
            extractor = network_extractor(network, transform)
            check(extractor.host_dtype == np.uint8, "uint8 ingress")
            for i, img in enumerate(images):
                extractor.add(i, img)
            out.append(extractor.finish(len(images)))
            chunks += extractor.chunks
        vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for v in out)
        ranks = rank_database(vecs, qvecs).cpu().numpy()
        return out[0], out[1], ranks, chunks

    run_path()  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shapes_seen = []
    launch = pooling_kernel.gem_l2n

    def recording(x, valid_hw, p, eps=1e-6):
        shapes_seen.append((tuple(x.shape), valid_hw.clone()))
        return launch(x, valid_hw, p, eps=eps)

    pooling_kernel.reset_launches()
    t = time.perf_counter()
    with mock.patch.object(pooling_kernel, "gem_l2n", recording):
        vecs, qvecs, ranks, chunks = run_path()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = pooling_kernel.launches
    n_images = len(db) + len(queries)
    peak = torch.cuda.max_memory_allocated()
    say("main", "ResNet101-GeM 2048-d, scales %s, Lw: %d images in %d "
        "chunks, %.2f s, %.1f images/s, peak %.2f GB"
        % ([round(s, 4) for s in SCALES], n_images, chunks, seconds,
           n_images / seconds, peak / 1e9))
    for v in (vecs, qvecs):
        check(np.isfinite(v).all(), "finite descriptors")
        norms = np.linalg.norm(v, axis=0)
        check(np.abs(norms - 1).max() < 1e-4, ("unit norms", norms))
    check(launches == chunks * len(SCALES) > 0,
          ("launches == chunks x scales", launches, chunks))
    mean_ap, _, pr, _ = compute_map(ranks, gnd, kappas=(1, 5, 10))
    say("main", "gem_l2n launches %d = %d chunks x %d scales; mAP %.4f, "
        "mP@1/5/10 %s" % (launches, chunks, len(SCALES), mean_ap,
                          np.round(pr, 4).tolist()))

    with mock.patch.object(pooling_kernel, "gem_l2n", gem_l2n_plain):
        pvecs, pqvecs, pranks, _ = run_path()
    desc_err = max(np.abs(vecs - pvecs).max(), np.abs(qvecs - pqvecs).max())
    check(desc_err <= DESC_ATOL, ("descriptors vs plain pool", desc_err))
    check((ranks[:10] == pranks[:10]).all(), "top-10 ranks vs plain pool")
    say("main", "plain pool on the card: max |desc diff| %.2e, top-10 ranks "
        "equal" % desc_err)

    small = [db[0][:256, :192], queries[4][:192, :256]]
    cpu_model = initialize_model(MODEL, device="cpu", seed=SEED)
    cpu_net = CirNetwork(cpu_model, CirNetwork.NetworkParams(
        model=dict(MODEL), runtime=dict(network.network_params.runtime)),
        frozen=True)
    small_vecs = []
    for net in (network, cpu_net):
        extractor = network_extractor(net, transform)
        for i, img in enumerate(small):
            extractor.add(i, img)
        small_vecs.append(extractor.finish(len(small)))
    cross_err = np.abs(small_vecs[0] - small_vecs[1]).max()
    check(cross_err <= DESC_ATOL, ("card vs CPU", cross_err))
    say("main", "small input, card against CPU: max |desc diff| %.2e"
        % cross_err)

    # 5. the kernel at the main path's shapes; time against plain and bound
    distinct = {}
    for shape, valid in shapes_seen:
        distinct.setdefault((shape, tuple(map(tuple, valid.tolist()))),
                            valid)
    for (shape, _), valid in distinct.items():
        x = torch.rand(shape, generator=gen).to(device)
        max_err = max(max_err, kernel_against_plain(
            pooling_kernel, gem_l2n_plain, x, valid, p))
    shape, valid = max(shapes_seen, key=lambda sv: int(np.prod(sv[0])))
    x = torch.rand(shape, generator=gen).to(device)
    with torch.no_grad():
        ms = cuda_ms(lambda: pooling_kernel.gem_l2n(x, valid, p))
        plain_ms = cuda_ms(lambda: gem_l2n_plain(x, valid, p))
    bound_ms, bound_by = gem_bound_ms(shape, valid.cpu())
    say("time", "gem_l2n at %s (main path's largest): kernel %.4f ms, plain "
        "%.4f ms, bound %.4f ms (%s); %d main-path shapes checked, max "
        "err %.2e" % (shape, ms, plain_ms, bound_ms, bound_by, len(distinct),
                      max_err))

    print(json.dumps({"kernels": [{
        "name": "gem_l2n", "route": "cuda",
        "source": "mdir_tpu_torch/csrc/gem_l2n.cu",
        "replaces": "mdir_tpu/ops/pooling_pallas.py:59",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
