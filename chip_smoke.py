#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mdir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # no arguments, no environment variables

Phases, one line each with its wall time:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every CUDA source of the port into
     build/mdir_tpu_torch/ (seconds, registers, shared memory);
  3. kernel: the GeM+L2N kernel against its plain PyTorch version on the
     card, at the extraction shapes, ragged valid extents included, at
     p = 1, 2.5, 3 and 4.7 (the kernel multiplies out p = 1 and 3 and
     takes one exp2 of a split log2 for any other), and its bfloat16- and
     float16-input instantiations against the float32 pool of the same
     cells at 16-bit maps whose widths load 8, 4, 2 and 1 cells, also as
     views 4 bytes past a 16-byte boundary; and the GeM head under autograd
     on the card
     (its plain version: the kernel is eval-only) against the CPU's
     gradients;
  Phases 4 to 10 pin ``compute_dtype: float32`` (``auto`` would run
  bfloat16 on the card), so their gates and numbers stay comparable with
  the earlier records; phase 11 runs bfloat16 and float16.
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
  5. the kernel at the main path's own shapes and the four p, and its time
     against its plain version and its bound (and its share of the bound)
     at the path's largest input at the path's p = 3 and at p = 2.5, and at
     its largest input of fewer than SMALL_BATCH images (the small-batch
     launch);
  6. the lab CLAHE chain's kernels (lab_n, clahe_tile_luts, clahe_interp)
     against their plain versions on the card, bit-equal: lab_n on all
     256^3 RGB triples, the CLAHE kernels on ragged buckets (non-divisible,
     divisible, tiny and filler extents; grids 8 and 4; clips 2, 4, 40),
     on a constant image, on a bucket whose width is not a multiple of 4
     and on values and LUTs 4 bytes past a 16-byte boundary (the kernels'
     one-pixel loads), and the single-image clahe_u8 and the L-only
     lab_l_u8 on the same kernels;
  7. the CLAHE main path, the paper's "CLAHE N/D" eval: a VGG16-GeM
     (512-d, random weights from a seed, p = 3, Lw whitening, scales 1,
     2^-1/2, 1/2, image size 1024) with the transform
     pil2np | apply_clahe:4:lab:8 | totensor | normalize on the same 40
     images. Each CLAHE kernel must launch once per chunk and gem_l2n once
     per chunk x scale; the run with the plain lab and CLAHE versions must
     give a bit-equal chain output per chunk, descriptors within 1e-4 and
     the same top-10 ranks; a small input must agree with the CPU;
  8. the three kernels at the main path's own chunks, bit-equal to plain,
     and their times against their plain versions and bounds (and their
     shares of the bounds); and, as in phase 5, the GeM+L2N kernel at
     every input the CLAHE path gave it (VGG16's 512 channels) and the
     four p, and its times there;
  9. the train stage of the same VGG16-GeM lab CLAHE model as the JAX
     package trains the paper's CLAHE N/D net (contrastive loss, margin
     0.7; adam, lr 1e-6, pool p at 10x; gamma exp(-0.01); 5 tuples of
     1 + 1 + 5 images a step, image size 1024) on an in-memory
     retrieval-SfM-style database (60 images: 30 clusters of two crops of
     one colour field, 20 query/positive pairs; query size 10, pool 50):
     2 epochs of mining and steps with checkpoints, then resumed to 3.
     Checks: the train step's chain bit-equal to the plain versions on
     every tuple bucket; mining with the kernels and the plain versions
     within 1e-4, with the same negatives in both epochs (the smallest
     score gap the picks relied on is printed: seeded weights put it far
     under 1e-4, so the tolerance alone does not imply the same
     negatives); one step on the card against the CPU
     at a longer side of 256 (loss within 1e-4, every gradient at cosine
     >= 0.9999); the
     epoch-2 checkpoint reloading bit for bit and the resumed epoch's loss
     finite; every loss finite and positive. Each kernel must launch on
     the path (gem_l2n in mining only: the step pools under autograd).
     Then two steps (adam) from the epoch-2 weights on the dataset's two
     batches under ``compute_dtype: auto`` (a bf16 trunk, its guard on the
     first step; a rejection must return the float32 step) beside the same
     steps in float32: the guard's loss gap and gradient cosine, s/step,
     peak memory;
 10. the composition path, the paper's "U-Net jointly N/D" eval
     (examples/iccv19/eval_composition.yml): a P2pUNet night->day
     translator at full width (nested_levels 7, 64 to 512 channels,
     reflectpad_divisible:256, mean/std 0.5, random weights from a seed)
     before the VGG16-GeM (p = 3, Lw 512 x 512 from the seed, scales 1,
     2^-1/2, 1/2, image size 1024) as a SequentialNetwork, through the
     composed batched extractor on the same 40 images. gem_l2n must launch
     once per chunk x scale; the run with the plain pool must agree within
     1e-4 with the same top-10 ranks; the batched extractor must equal the
     per-image SequentialNetwork path on three images of different shapes
     in one chunk, one padded at every scale (rtol 1e-4, atol 1e-5); one
     U-Net forward at 256 x 256 must match the CPU's within 1e-4 relative.
     It prints images/s, peak memory and the translator's share of the
     pass (CUDA events), and holds gem_l2n at every input the path gave it;
 11. the three eval paths of phases 4, 7 and 10 on the same images, first
     with ``compute_dtype: bfloat16`` (unguarded: images/s, peak memory,
     each chunk's least row cosine and the top-10 ranks against the path's
     float32 run; gem_l2n's bf16 instantiation must launch once per chunk x
     scale), then with ``auto``: the guard must run once, on the first
     chunk, and a rejection must give descriptors within 1e-4 of float32;
     then the VGG16 lab CLAHE path with ``compute_dtype: float16`` (forced,
     unguarded: the float16 instantiation must launch once per chunk x
     scale; its least row cosine against float32 is printed, not gated,
     as the JAX package sets no bar for float16). Both 16-bit kernels are
     held within 1e-5 relative of their plain versions at every input the
     bf16 runs gave the pool (and the float16 kernel at the float16 run's),
     each also as an offset view, and timed at each path's largest input
     and its 8-image launch at p = 3 and 2.5 against the bound;
 12. the descriptor-dump and Lw-learning path, in float32, on a whiten set
     of 64 in-memory images (8 clusters of 8 crops of one colour field,
     fed through the dataset's ``loader`` hook) and one name without an
     image: the infer stage's embedding output with the VGG16-GeM lab
     CLAHE net (scales 1, 2^-1/2, 1/2, image size 1024) from a checkpoint,
     its rows bit-equal to ``extract_vectors_network`` on the same arrays,
     a NaN row at the missing name, gem_l2n launched once per chunk x
     scale and each CLAHE kernel once per chunk (three timed runs, images/s
     without the network load, which is timed apart); Lw learned on all
     448 ordered within-cluster pairs (seconds, failed_times, cond(P); 64
     images span at most 63 of the 512 directions, so the Lw applied is
     P's leading real rows), applied by the whiten stage and, as a pkl,
     through ``cirwhiten`` on phase 7's path, both within a statistical
     rounding bound of host float64 whitening derived from P's
     conditioning, with equal top-10 ranks, and the stage's apply with
     TF32 matmuls must fail that bound; the phase-4 ResNet101-GeM saved as an
     official cirtorch file, converted by ``convert_contained_net`` and
     loaded, bit-equal to its source on the 40 images, and
     ``learn_whitening``'s extraction on the 64 arrays (gem_l2n once per
     chunk x scale) with ``whitenlearn`` over it (both timed); the infer
     stage's translation of the 64 images by phase 10's P2pUNet through
     ``StreamingTranslator``, three timed passes with two batches in
     flight and three with none, of the input shapes and within one level
     of the per-image path (images/s, the forwards' device time and share
     of the pass, share of differing values, the phase's peak memory).
Then one JSON line of kernels (gem_l2n, gem_l2n_bf16 timed at the bf16
paths' maps, gem_l2n_f16 at the float16 path's, with its times at the bf16
maps as off-path readings; each redesigned kernel tagged with the PR of
its redesign; launches on the training and composition paths, mining and
train step apart; and on phase 12's runs, ``dump_path_launches``), the
nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failure raises (non-zero exit, no last
line). Without a card, or without the port beside it, it fails at once.
"""
import sys

sys.dont_write_bytecode = True  # write nothing outside build/mdir_tpu_torch

import copy  # noqa: E402
import functools  # noqa: E402
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
# the 16-bit-input kernels (bfloat16 and float16): the ResNet and VGG16
# maps, widths that load 8, 4, 2 and 1 cells, the small-batch launch
BF16_KERNEL_SHAPES = [(16, 2048, 32, 24), (16, 2048, 32, 20),
                      (16, 2048, 18, 22), (16, 2048, 23, 17),
                      (16, 512, 64, 48), (8, 512, 48, 64), (3, 2048, 7, 9)]
# phases 4-10 pin float32, so their gates and numbers stay those of the
# earlier records; phase 11 runs bfloat16 and auto
FLOAT32_RUNTIME = {"compute_dtype": "float32"}
P_VALUES = (1.0, 2.5, 3.0, 4.7)  # GeM exponents the kernel is held at
PATH_P, OTHER_P = 3.0, 2.5  # the path's p (timed) and a non-integer p
# the kernels' "redesigned" tag in the kernels line: where the records
# (PERF.md §6) hold their earlier times
REDESIGNED = {"gem_l2n": "PR 6, PR 11", "gem_l2n_bf16": "PR 11",
              "lab_n": "PR 6", "clahe_tile_luts": "PR 7",
              "clahe_interp": "PR 7"}
HALF_TYPES = (torch.bfloat16, torch.float16)
RTOL, ATOL = 1e-5, 1e-6  # kernel against its plain version
DESC_ATOL = 1e-4  # descriptors, kernel pool against plain pool
TIMED_LAUNCHES = 100
SMALL_BATCH = 12  # a chunk of fewer images: the 8-image launch is timed too
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
CLAHE_MODEL = dict(MODEL, cir_architecture="vgg16")
# training phase: the in-memory retrieval-SfM-style database (clusters of 2
# crops of one colour field, the first TRAIN_PAIRS clusters as query and
# positive) and cirtorch's train.py batch (5 tuples of 1 + 1 + 5 images)
TRAIN_IMAGES = {}  # name -> (H, W, 3) uint8, served by smoke_loader
TRAIN_CLUSTERS, TRAIN_PAIRS = 30, 20
TRAIN_SHAPES = [(1024, 768), (768, 1024), (1000, 750), (683, 1024),
                (900, 700), (600, 800)]
TRAIN_QUERY_SIZE, TRAIN_POOL_SIZE, TRAIN_NEG_NUM, TRAIN_BATCH = 10, 50, 5, 5
TRAIN_EPOCHS = 2  # then resumed to one more
TRAIN_CHECK_SIDE = 256  # longer side of the card-against-CPU step
LOSS_RTOL, GRAD_MIN_COSINE = 1e-4, 0.9999  # that step's tolerances
CLAHE_DIM = 512
CLAHE_TRANSFORM = "pil2np | apply_clahe:4:lab:8 | totensor | normalize"
LAB_SWEEP_SIDE = 4096  # one (1, 4096, 4096, 3) image holds all 256^3 RGB
# ragged extents in one (1024, 1024) bucket: non-divisible, divisible,
# tiny, and a filler slot of the bucket's own shape
CLAHE_CHECK_SHAPES = [(1000, 750), (683, 1024), (1024, 768), (512, 512),
                      (1, 1), (7, 9), (1024, 1024)]
CLAHE_CHECK_CASES = [(2.0, 8), (4.0, 8), (40.0, 8), (4.0, 4), (40.0, 4)]
# a bucket whose width is not a multiple of 4, at a grid that divides it
NARROW_BUCKET, NARROW_GRID = (1020, 1026), 6
NARROW_SHAPES = [(1020, 1026), (1000, 1021), (683, 1026), (7, 9), (1, 1)]
# integer or float operations per pixel, counted from the kernels' sources:
# lab_n 24 multiply-adds of the blend + 6 weight products + 6 for the
# rounding; clahe_interp 8 for the two axes' coordinates, 11 for the blend,
# 3 for rint and the clamp; clahe_tile_luts one count per padded pixel plus
# about 10 per bin of each tile
# phase 10: the U-Net jointly N/D composition (the translator's pad divisor
# is 2^8: nested_levels 7 runs 8 stride-2 stages)
UNET_MODEL = {"architecture": "p2p_unet", "in_channels": 3,
              "out_channels": 3, "nested_levels": 7}
UNET_DIVISOR = 256
UNET_DATA = {"mean_std": [[0.5] * 3, [0.5] * 3],
             "transforms": "pil2np | totensor | normalize"}
# three shapes of one chunk key; (1000, 750) needs a pad at every scale
UNET_CHECK_SHAPES = [(1024, 768), (1000, 750), (990, 740)]
UNET_CHECK_SIDE = 256  # the card-against-CPU U-Net forward
UNET_RTOL, UNET_ATOL = 1e-4, 1e-5  # batched against per-image
# phase 12: the descriptor dump and Lw learning (8 clusters of 8 crops,
# one name without an image, all 448 ordered within-cluster pairs)
WHITEN_IMAGES = {}  # name -> (H, W, 3) uint8, served by dump_loader
WHITEN_CLUSTERS, WHITEN_CROPS = 8, 8
WHITEN_MISSING, WHITEN_MISSING_AT = "absent", 5
DUMP_REPEATS = 3  # timed infer and translation passes, after a warm one
F32_EPS = 2.0 ** -24  # float32 unit roundoff
TF32_EPS = 2.0 ** -11  # TF32's (10 stored mantissa bits)
ROUNDING_LAMBDA = 1.0  # the statistical rounding bound's lambda
LAB_OPS_PER_PIXEL = 60
INTERP_OPS_PER_PIXEL = 22
LUT_OPS_PER_BIN = 10

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
    """Mean device time of ``fn`` over ``launches`` calls (CUDA events).

    A spin kernel holds the stream while the host queues the timed calls,
    so the host's time between launches does not count: a small kernel
    reads its own time, not its wrapper's."""
    fn()  # the first call may load a library or plan a convolution
    t = time.perf_counter()
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t) / max(warmup - 1, 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * launches * spin_cycles_per_s()))
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


@functools.lru_cache(maxsize=1)
def spin_cycles_per_s():
    """Cycles per second of ``torch.cuda._sleep``'s spin."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return 1e10 / start.elapsed_time(end)


def gem_bound_ms(shape, valid, itemsize=4):
    """Least time of masked GeM+L2N on these inputs, and what bounds it:
    every valid cell read once (``itemsize`` bytes) and N*C floats written
    (plus extents and p), against ~3 float operations per valid cell
    (clamp, pow, add)."""
    n, c = shape[:2]
    h, w = shape[2:]
    cells = int(sum(min(max(int(vh), 0), h) * min(max(int(vw), 0), w)
                    for vh, vw in valid.tolist()))
    nbytes = itemsize * cells * c + 4 * (n * c + 2 * n + 1)
    ops = 3 * cells * c
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def ragged_valid(gen, n, h, w, device):
    valid = torch.stack([torch.randint(1, h + 1, (n,), generator=gen),
                         torch.randint(1, w + 1, (n,), generator=gen)], 1)
    valid[0] = torch.tensor([h, w])
    valid[-1] = torch.tensor([1, 1])
    return valid.to(torch.int32).to(device)


def kernel_against_plain(pooling_kernel, gem_l2n_plain, x, valid):
    """The largest |kernel - plain| over P_VALUES; fails outside the
    tolerance. The plain version of a bf16 input is the float32 pool of its
    exactly widened cells."""
    err = 0.0
    for value in P_VALUES:
        p = torch.tensor([value], device=x.device)
        with torch.no_grad():
            out = pooling_kernel.gem_l2n(x, valid, p)
            ref = gem_l2n_plain(x.float(), valid, p)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        err = max(err, float((out - ref).abs().max()))
    return err


def recording_pool(launch, sink, dtypes=None):
    """``launch`` (the pool's wrapper) that also records each input's shape
    and valid extents in ``sink``, and its dtype in ``dtypes``."""
    def fn(x, valid_hw, p, eps=1e-6):
        sink.append((tuple(x.shape), valid_hw.clone()))
        if dtypes is not None:
            dtypes.append(x.dtype)
        return launch(x, valid_hw, p, eps=eps)
    return fn


def gem_path_phase(tag, pooling_kernel, gem_l2n_plain, inputs, gen, device,
                   dtype=torch.float32):
    """The kernel at every distinct (shape, valid extents) input a main path
    gave it, on random values of ``dtype``, at P_VALUES against plain (a
    16-bit map also as a view 4 bytes past a 16-byte boundary); then its
    time at the path's largest input and at its largest input of fewer
    than SMALL_BATCH images, its small-batch launch (each at
    PATH_P and OTHER_P, against plain and the bound)."""
    distinct = {}
    for shape, valid in inputs:
        distinct.setdefault((shape, tuple(map(tuple, valid.tolist()))),
                            valid)
    err = 0.0
    for (shape, _), valid in distinct.items():
        x = torch.rand(shape, generator=gen).to(device, dtype)
        err = max(err, kernel_against_plain(pooling_kernel, gem_l2n_plain,
                                            x, valid))
        if dtype in HALF_TYPES:
            err = max(err, kernel_against_plain(
                pooling_kernel, gem_l2n_plain, offset_copy(x), valid))
    p, other_p = (torch.tensor([v], device=device)
                  for v in (PATH_P, OTHER_P))

    def timed(shape, valid, p_values):
        x = torch.rand(shape, generator=gen).to(device, dtype)
        with torch.no_grad():
            times = [cuda_ms(lambda: pooling_kernel.gem_l2n(x, valid, q))
                     for q in p_values]
            plain_ms = cuda_ms(lambda: gem_l2n_plain(x.float(), valid, p))
        bound_ms, bound_by = gem_bound_ms(shape, valid.cpu(),
                                          x.element_size())
        return {"shape": list(shape), "ms": times[0], "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_share": bound_ms / times[0]}, times[1:]

    def size(shape_valid):
        return int(np.prod(shape_valid[0]))

    largest, (other_ms,) = timed(*max(inputs, key=size), (p, other_p))
    largest["ms_p%g" % OTHER_P] = other_ms
    say("time", "gem_l2n, %s path, %s: %d inputs of shapes %s x %d p "
        "against plain, max err %.2e; at its largest %s: %.4f ms (%.0f%% of "
        "bound) at p = %g, %.4f ms (%.0f%%) at p = %g; plain %.4f ms, bound "
        "%.4f ms (%s)"
        % (tag, str(dtype)[6:], len(distinct),
           sorted({shape for shape, _ in distinct}),
           len(P_VALUES), err, tuple(largest["shape"]),
           largest["ms"], 100 * largest["bound_share"], PATH_P, other_ms,
           100 * largest["bound_ms"] / other_ms, OTHER_P,
           largest["plain_ms"], largest["bound_ms"], largest["bound_by"]))
    small_inputs = [sv for sv in inputs
                    if sv[0][0] < SMALL_BATCH]
    small = None
    if small_inputs:
        small, (small_other,) = timed(*max(small_inputs, key=size),
                                      (p, other_p))
        small["ms_p%g" % OTHER_P] = small_other
        say("time", "gem_l2n, %s path, %s, small-batch launch at %s: %.4f "
            "ms (%.0f%% of bound %.4f ms) at p = %g, %.4f ms (%.0f%%) at p = "
            "%g"
            % (tag, str(dtype)[6:], tuple(small["shape"]), small["ms"],
               100 * small["bound_share"], small["bound_ms"], PATH_P,
               small_other, 100 * small["bound_ms"] / small_other, OTHER_P))
    return {"max_abs_err": err, "timed": largest, "small_batch": small}


def head_gradients_phase(device, gen):
    """The GeM head under autograd on the card (its plain version: the
    kernel is eval-only) against the same head on the CPU."""
    from mdir_tpu_torch.models.retrievalnet import GeMPoolL2N

    x = torch.rand((3, 64, 7, 9), generator=gen)
    valid = torch.tensor([[7, 9], [3, 4], [1, 1]], dtype=torch.int32)
    weights = torch.randn((3, 64), generator=gen)
    grads = []
    for where in (device, torch.device("cpu")):
        head = GeMPoolL2N(p_init=OTHER_P).to(where)
        xs = x.to(where).requires_grad_()
        out = head(xs, valid.to(where))
        (out * weights.to(where)).sum().backward()
        grads.append((xs.grad.cpu(), head.p.grad.cpu()))
    for card, cpu in zip(*grads):
        torch.testing.assert_close(card, cpu, rtol=RTOL, atol=ATOL)
    say("kernel", "GeM head under autograd on the card (plain version): "
        "d/dx and d/dp equal to the CPU's within rtol %g" % RTOL)


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


def lab_bound_ms(shape):
    """Least time of lab_n on a (B, H, W, 3) uint8 input: 3 bytes read and
    12 written per pixel plus the tables, against LAB_OPS_PER_PIXEL 32-bit
    operations per pixel at the card's float32 rate."""
    pixels = int(np.prod(shape[:-1]))
    nbytes = pixels * (3 + 12) + 2 * 256 * 4 + 33 ** 3 * 3 * 2
    ops = pixels * LAB_OPS_PER_PIXEL
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def aux_extents(aux):
    """(h, w) per image of a clahe aux: the reflect maps cover 0..size-1."""
    return list(zip((aux["row_src"].amax(1) + 1).tolist(),
                    (aux["col_src"].amax(1) + 1).tolist()))


def tile_luts_bound_ms(vals, aux, grid):
    """Least time of the tile-LUT build: each image's pixels read once
    (int32), the reflect maps and per-image scalars read, the (B, T, 256)
    float LUTs written; one count per pixel of cv2's padded extent and
    LUT_OPS_PER_BIN per bin of each tile."""
    b, bh, bw = vals.shape
    tiles = grid[0] * grid[1]
    pixels = sum(h * w for h, w in aux_extents(aux))
    padded = int((aux["th"] * aux["tw"]).sum()) * tiles
    nbytes = 4 * (pixels + b * (bh + grid[0] + bw + grid[1]) + 4 * b
                  + b * tiles * 256)
    ops = padded + b * tiles * 256 * LUT_OPS_PER_BIN
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def interp_bound_ms(vals, grid):
    """Least time of the interpolation: every bucket pixel read (int32) and
    written (float32), the LUTs and two scalars per image read, against
    INTERP_OPS_PER_PIXEL float operations per pixel."""
    b, bh, bw = vals.shape
    pixels = b * bh * bw
    nbytes = 4 * (2 * pixels + b * grid[0] * grid[1] * 256 + 2 * b)
    ops = pixels * INTERP_OPS_PER_PIXEL
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def check_equal(out, ref, what):
    """Fail unless a kernel's output is bit-equal to its plain version's."""
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          (what, tuple(out.shape), tuple(ref.shape), out.dtype, ref.dtype))
    check(torch.equal(out, ref),
          (what, "not bit-equal", float((out.double() - ref.double())
                                        .abs().max())))


def clahe_against_plain(clahe, vals, aux, grid, what):
    """Both CLAHE kernels against their plain versions on one bucket."""
    luts = clahe.clahe_tile_luts(vals, aux, grid)
    plain_luts = clahe.tile_luts_bucketed_plain(vals, aux, grid)
    check_equal(luts, plain_luts, ("clahe_tile_luts",) + what)
    out = clahe.clahe_interp(vals, plain_luts, aux, grid)
    check_equal(out, clahe.clahe_interp_bucketed_plain(
        vals, plain_luts, aux, grid), ("clahe_interp",) + what)


def offset_copy(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
    cells = 4 // t.element_size()
    flat = torch.empty(t.numel() + cells, dtype=t.dtype, device=t.device)
    shifted = flat[cells:].view(t.shape)
    shifted.copy_(t)
    check(shifted.is_contiguous() and shifted.data_ptr() % 16 == 4,
          "offset view")
    return shifted


def plain_clahe_kernels(clahe, lab_trilinear):
    """Context: the chain runs the plain lab and CLAHE versions."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(lab_trilinear, "lab_n",
                                          lab_trilinear.lab_n_plain))
    stack.enter_context(mock.patch.object(
        clahe, "clahe_tile_luts", clahe.tile_luts_bucketed_plain))
    stack.enter_context(mock.patch.object(
        clahe, "clahe_interp", clahe.clahe_interp_bucketed_plain))
    return stack


def clahe_kernel_phase(device, clahe, lab_trilinear):
    """Phase 6: the three kernels and the two off-path wrappers against
    their plain versions on the card."""
    side = LAB_SWEEP_SIDE
    v = torch.arange(256, device=device, dtype=torch.int32)
    sweep = torch.stack(torch.meshgrid(v, v, v, indexing="ij"), -1)
    sweep = sweep.reshape(1, side, -1, 3).to(torch.uint8).contiguous()
    check_equal(lab_trilinear.lab_n(sweep), lab_trilinear.lab_n_plain(sweep),
                ("lab_n", "256^3 sweep"))
    say("kernel", "lab_n on all 256^3 RGB triples %s: bit-equal to plain"
        % (tuple(sweep.shape),))
    del sweep

    rng = np.random.RandomState(SEED)
    bh = max(h for h, _ in CLAHE_CHECK_SHAPES)
    bw = max(w for _, w in CLAHE_CHECK_SHAPES)
    vals = np.zeros((len(CLAHE_CHECK_SHAPES), bh, bw), np.int32)
    for i, (h, w) in enumerate(CLAHE_CHECK_SHAPES):
        vals[i, :h, :w] = rng.randint(0, 256, (h, w))
    vals = torch.from_numpy(vals).to(device)
    for clip, g in CLAHE_CHECK_CASES:
        grid = (g, g)
        aux = clahe.aux_to_device(clahe.clahe_bucket_aux(
            CLAHE_CHECK_SHAPES, (bh, bw), clip, grid), device)
        clahe_against_plain(clahe, vals, aux, grid, (clip, grid))
    say("kernel", "clahe_tile_luts, clahe_interp on a (%d, %d, %d) bucket "
        "of extents %s, (clip, grid) %s: bit-equal to plain"
        % (len(CLAHE_CHECK_SHAPES), bh, bw, CLAHE_CHECK_SHAPES,
           CLAHE_CHECK_CASES))

    grid = (8, 8)
    aux = clahe.aux_to_device(clahe.clahe_bucket_aux(
        CLAHE_CHECK_SHAPES, (bh, bw), 4.0, grid), device)
    clahe_against_plain(clahe, torch.full_like(vals, 77), aux, grid,
                        ("constant",))
    shifted = offset_copy(vals)
    luts = clahe.tile_luts_bucketed_plain(vals, aux, grid)
    check_equal(clahe.clahe_tile_luts(shifted, aux, grid), luts,
                ("clahe_tile_luts", "offset view"))
    check_equal(clahe.clahe_interp(shifted, offset_copy(luts), aux, grid),
                clahe.clahe_interp_bucketed_plain(vals, luts, aux, grid),
                ("clahe_interp", "offset view"))
    narrow = np.zeros((len(NARROW_SHAPES),) + NARROW_BUCKET, np.int32)
    for i, (h, w) in enumerate(NARROW_SHAPES):
        narrow[i, :h, :w] = rng.randint(0, 256, (h, w))
    grid = (NARROW_GRID, NARROW_GRID)
    aux = clahe.aux_to_device(clahe.clahe_bucket_aux(
        NARROW_SHAPES, NARROW_BUCKET, 4.0, grid), device)
    clahe_against_plain(clahe, torch.from_numpy(narrow).to(device), aux,
                        grid, ("narrow",))
    say("kernel", "clahe_tile_luts, clahe_interp on a constant bucket, on "
        "values and LUTs 4 bytes off a 16-byte boundary, and on a %s bucket "
        "of extents %s at grid %d: bit-equal to plain"
        % ((len(NARROW_SHAPES),) + NARROW_BUCKET, NARROW_SHAPES,
           NARROW_GRID))

    src = torch.from_numpy(rng.randint(0, 256, (683, 1000)).astype(
        np.uint8)).to(device)
    rgb = torch.from_numpy(rng.randint(0, 256, (4, 600, 800, 3)).astype(
        np.uint8)).to(device)
    out = clahe.clahe_u8(src, 4.0, (8, 8))
    l_u8 = lab_trilinear.lab_l_u8(rgb)
    with plain_clahe_kernels(clahe, lab_trilinear):
        check_equal(out, clahe.clahe_u8(src, 4.0, (8, 8)), ("clahe_u8",))
        check_equal(l_u8, lab_trilinear.lab_l_u8(rgb), ("lab_l_u8",))
    say("kernel", "clahe_u8 (one image, static grid) and lab_l_u8 on the "
        "same kernels: bit-equal to plain")


def clahe_path_phase(device, db, queries, gnd, rng):
    """Phase 7: the VGG16-GeM lab CLAHE eval path. Returns what phase 8
    and the kernels line need."""
    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.ops import clahe, lab_trilinear, pooling_kernel
    from mdir_tpu_torch.ops.preprocess import chain_from_transform
    from mdir_tpu_torch.ops.ranking import compute_map, rank_database
    from mdir_tpu_torch.parallel.extract import network_extractor

    whiten_path = os.path.join(_build.BUILD_ROOT, "smoke",
                               "whiten_vgg16_seed%d.pkl" % SEED)
    with open(whiten_path + ".tmp", "wb") as handle:
        pickle.dump({"P": np.eye(CLAHE_DIM)
                     + 0.01 * rng.randn(CLAHE_DIM, CLAHE_DIM),
                     "m": 0.01 * rng.randn(CLAHE_DIM, 1)}, handle)
    os.replace(whiten_path + ".tmp", whiten_path)
    runtime = {"wrappers": {"train": None, "eval": {
        "0_cirwhiten": {"whitening": whiten_path, "dimensions": None},
        "1_cirmultiscale": {"scales": SCALES}}}, **FLOAT32_RUNTIME}
    model = initialize_model(CLAHE_MODEL, device=device, seed=SEED)
    network = CirNetwork(model, CirNetwork.NetworkParams(
        model=dict(CLAHE_MODEL), runtime=runtime), frozen=True)
    transform = initialize_transforms(CLAHE_TRANSFORM,
                                      (model.meta["mean"], model.meta["std"]))
    gem_in = []

    def run_path(net, images_sets, wrap_chain=None):
        """Descriptors, ranks and chunks of the path through ``net``."""
        out, chunks = [], 0
        for images in images_sets:
            extractor = network_extractor(net, transform)
            check(extractor.device_chain is not None
                  and extractor.host_dtype == np.uint8,
                  "CLAHE device chain with uint8 ingress")
            if wrap_chain is not None:
                extractor.chain_fn = wrap_chain(extractor.chain_fn)
            for i, img in enumerate(images):
                extractor.add(i, img)
            out.append(extractor.finish(len(images)))
            chunks += extractor.chunks
        return out, chunks

    def ranks_of(out):
        vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for v in out)
        return rank_database(vecs, qvecs).cpu().numpy()

    def recording(sink, inputs=None):
        def wrap(chain_fn):
            def fn(batch, aux):
                if inputs is not None:
                    inputs.append((batch.clone(), {k: v.clone()
                                                   for k, v in aux.items()}))
                result = chain_fn(batch, aux)
                sink.append(result.cpu())
                return result
            return fn
        return wrap

    # warm-up (cuDNN plans, allocator) that also records each chunk's
    # chain input and output, and the pool's inputs
    chain_out, chain_in = [], []
    with mock.patch.object(pooling_kernel, "gem_l2n",
                           recording_pool(pooling_kernel.gem_l2n, gem_in)):
        run_path(network, (db, queries), recording(chain_out, chain_in))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []

    def timing(chain_fn):
        def fn(batch, aux):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = chain_fn(batch, aux)
            end.record()
            events.append((start, end))
            return result
        return fn

    pooling_kernel.reset_launches()
    lab_trilinear.reset_launches()
    clahe.reset_launches()
    t = time.perf_counter()
    out, chunks = run_path(network, (db, queries), timing)
    ranks = ranks_of(out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {"gem_l2n": pooling_kernel.launches,
                "lab_n": lab_trilinear.launches, **clahe.launches}
    peak = torch.cuda.max_memory_allocated()
    chain_ms = sum(a.elapsed_time(b) for a, b in events)
    n_images = len(db) + len(queries)
    say("clahe", "VGG16-GeM %d-d, %s, scales %s, Lw: %d images in %d "
        "chunks, %.2f s, %.1f images/s, peak %.2f GB; chain %.1f ms "
        "(%.1f%% of the pass)"
        % (CLAHE_DIM, CLAHE_TRANSFORM, [round(x, 4) for x in SCALES],
           n_images, chunks, seconds, n_images / seconds, peak / 1e9,
           chain_ms, 100 * chain_ms / (1e3 * seconds)))
    for v in out:
        check(v.shape[0] == CLAHE_DIM and np.isfinite(v).all(),
              "finite descriptors of the CLAHE path")
        norms = np.linalg.norm(v, axis=0)
        check(np.abs(norms - 1).max() < 1e-4, ("unit norms", norms))
    for name in ("lab_n", "clahe_tile_luts", "clahe_interp"):
        check(launches[name] == chunks > 0,
              ("%s launches == chunks" % name, launches[name], chunks))
    check(launches["gem_l2n"] == chunks * len(SCALES),
          ("gem_l2n launches == chunks x scales", launches, chunks))
    mean_ap, _, pr, _ = compute_map(ranks, gnd, kappas=(1, 5, 10))
    say("clahe", "launches %s for %d chunks; mAP %.4f, mP@1/5/10 %s"
        % (launches, chunks, mean_ap, np.round(pr, 4).tolist()))

    plain_out = []
    with plain_clahe_kernels(clahe, lab_trilinear):
        pout, _ = run_path(network, (db, queries), recording(plain_out))
    check(len(plain_out) == len(chain_out) == chunks, "chunks recorded")
    for i, (a, b) in enumerate(zip(chain_out, plain_out)):
        check(torch.equal(a, b), ("chain output of chunk %d vs plain" % i,
                                  float((a - b).abs().max())))
    desc_err = max(np.abs(a - b).max() for a, b in zip(out, pout))
    check(desc_err <= DESC_ATOL, ("descriptors vs plain chain", desc_err))
    check((ranks[:10] == ranks_of(pout)[:10]).all(),
          "top-10 ranks vs plain chain")
    say("clahe", "plain lab + CLAHE on the card: chain output bit-equal in "
        "all %d chunks, max |desc diff| %.2e, top-10 ranks equal"
        % (chunks, desc_err))

    small = [db[0][:256, :192], queries[4][:192, :256]]
    cpu_net = CirNetwork(initialize_model(CLAHE_MODEL, device="cpu",
                                          seed=SEED),
                         CirNetwork.NetworkParams(
                             model=dict(CLAHE_MODEL), runtime=runtime),
                         frozen=True)
    card, cpu = (run_path(net, (small,))[0][0] for net in (network, cpu_net))
    cross_err = np.abs(card - cpu).max()
    check(cross_err <= DESC_ATOL, ("CLAHE path, card vs CPU", cross_err))
    say("clahe", "small input, card against CPU: max |desc diff| %.2e"
        % cross_err)
    return {"launches": launches, "inputs": chain_in, "gem_inputs": gem_in,
            "grid": chain_from_transform(transform).clahe_params[1],
            "whiten_path": whiten_path, "network": network,
            "transform": transform, "out": out, "ranks": ranks,
            "images_per_s": n_images / seconds, "peak": peak}


def clahe_timing_phase(clahe, lab_trilinear, inputs, grid):
    """Phase 8: the kernels at every chunk of the main path against plain,
    and their times at the largest chunk. Returns the kernels' entries."""
    for batch, aux in inputs:
        check_equal(lab_trilinear.lab_n(batch),
                    lab_trilinear.lab_n_plain(batch), ("lab_n", batch.shape))
        l_u8 = lab_trilinear.lab_l_u8(batch)
        clahe_against_plain(clahe, l_u8, aux, grid, (tuple(batch.shape),))
    batch, aux = max(inputs, key=lambda ba: ba[0].numel())
    l_u8 = lab_trilinear.lab_l_u8(batch)
    luts = clahe.clahe_tile_luts(l_u8, aux, grid)
    timed = {
        "lab_n": (lambda: lab_trilinear.lab_n(batch),
                  lambda: lab_trilinear.lab_n_plain(batch),
                  lab_bound_ms(tuple(batch.shape))),
        "clahe_tile_luts": (
            lambda: clahe.clahe_tile_luts(l_u8, aux, grid),
            lambda: clahe.tile_luts_bucketed_plain(l_u8, aux, grid),
            tile_luts_bound_ms(l_u8, aux, grid)),
        "clahe_interp": (
            lambda: clahe.clahe_interp(l_u8, luts, aux, grid),
            lambda: clahe.clahe_interp_bucketed_plain(l_u8, luts, aux, grid),
            interp_bound_ms(l_u8, grid)),
    }
    entries = {}
    for name, (kernel, plain, (bound_ms, bound_by)) in timed.items():
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, launches=10, warmup=2)
        entries[name] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bound_share": bound_ms / ms}
        say("time", "%s at %s (main path's largest chunk): kernel %.4f ms "
            "(%.0f%% of bound), plain %.4f ms, bound %.4f ms (%s)"
            % (name, tuple(batch.shape), ms, 100 * bound_ms / ms, plain_ms,
               bound_ms, bound_by))
    say("time", "lab_n, clahe_tile_luts, clahe_interp bit-equal to plain at "
        "all %d main-path chunks" % len(inputs))
    return entries


def smoke_loader(path):
    """The training phase's dataset loader: its in-memory uint8 images."""
    return TRAIN_IMAGES[os.path.basename(path)]


def make_train_images(rng, clusters=TRAIN_CLUSTERS, crops=2,
                      images=TRAIN_IMAGES):
    """``clusters`` smooth colour fields, ``crops`` crops of each at mixed
    aspect ratios (longer side <= IMAGE_SIZE, so nothing is resized) with
    noise, into ``images`` as im00, im01, ... (cluster-major)."""
    import torch.nn.functional as F

    side = IMAGE_SIZE + 256
    for c in range(clusters):
        field = F.interpolate(
            torch.from_numpy(rng.rand(1, 3, 6, 8).astype(np.float32)),
            size=(side, side), mode="bilinear",
            align_corners=False)[0].numpy().transpose(1, 2, 0)
        for k in range(crops):
            h, w = TRAIN_SHAPES[(crops * c + k) % len(TRAIN_SHAPES)]
            y, x = rng.randint(0, side - h), rng.randint(0, side - w)
            img = field[y:y + h, x:x + w] * 255 + rng.randn(h, w, 3) * 8
            images["im%02d" % (crops * c + k)] = np.clip(
                img, 0, 255).astype(np.uint8)


def train_scenario(directory, db_pkl, epochs):
    """The paper's CLAHE N/D model as the JAX package trains it (cirtorch's
    train.py defaults, example_params.yml's loss and optimizer), on the
    in-memory database."""
    return {
        "network": {
            "type": "CirNetwork", "path": None, "model": dict(CLAHE_MODEL),
            "initialize": {"weights": "default", "seed": SEED},
            "runtime": {"wrappers": {"train": "cirfaketuplebatch",
                                     "eval": ""},
                        "data": {"transforms": CLAHE_TRANSFORM},
                        **FLOAT32_RUNTIME}},
        "learning": {
            "type": "TrainValLearning",
            "checkpoints": {"directory": directory, "store_every": 0,
                            "checkpoint_every": 1},
            "training": {
                "type": "EpochTraining", "epochs": epochs,
                "deterministic": True, "seed": SEED,
                "criterion": {"loss": "contrastive", "margin": 0.7,
                              "eps": 1e-6},
                "optimizer": {"algorithm": "adam", "lr": 1e-6,
                              "weight_decay": 1e-6},
                "scheduler": {"algorithm": "gamma", "gamma": "exp(-0.01)"},
                "epoch_iteration": {
                    "type": "SupervisedEpoch", "data": "train",
                    "criterion": "default", "batch_average": False,
                    "fakebatch": True}},
            "validation": False},
        "output": {"learning": {"progress": {"print_each": 0}}},
        "data": {"train": {
            "transforms": CLAHE_TRANSFORM,
            "dataset": {"name": "CirTuples",
                        "dataset": "retrieval-SfM-smoke", "split": "train",
                        "image_size": IMAGE_SIZE, "neg_num": TRAIN_NEG_NUM,
                        "dataset_pkl": db_pkl, "image_dir": None,
                        "query_size": TRAIN_QUERY_SIZE,
                        "pool_size": TRAIN_POOL_SIZE, "loader": smoke_loader},
            "loader": {"batch_size": TRAIN_BATCH}}},
    }


def kernel_counts(clahe, lab_trilinear, pooling_kernel):
    return {"gem_l2n": pooling_kernel.launches,
            "lab_n": lab_trilinear.launches, **clahe.launches}


def train_phase(device, clahe, lab_trilinear, pooling_kernel):
    """Phase 9: the train stage of the VGG16-GeM lab CLAHE model, its five
    checks, and its launch counts (mining and train step apart)."""
    import contextlib
    import io
    import shutil

    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.datasets import TuplesDataset, selection_gap
    from mdir_tpu_torch.learning.checkpoints import (Checkpoints,
                                                     load_checkpoint_any)
    from mdir_tpu_torch.learning.epoch_iteration import SupervisedEpoch
    from mdir_tpu_torch.learning.network import initialize_network
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.ops.clahe import aux_to_device, clahe_bucket_aux
    from mdir_tpu_torch.ops.pooling import gem_l2n_plain
    from mdir_tpu_torch.ops.preprocess import make_bucketed_chain
    from mdir_tpu_torch.stages.train import train

    root = os.path.join(_build.BUILD_ROOT, "smoke", "train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    make_train_images(np.random.RandomState(SEED))
    db_pkl = os.path.join(root, "db.pkl")
    names = sorted(TRAIN_IMAGES)
    with open(db_pkl, "wb") as handle:
        pickle.dump({"train": {
            "cids": ["/smoke/%s" % name for name in names],
            "cluster": [i // 2 for i in range(len(names))],
            "qidxs": [2 * k for k in range(TRAIN_PAIRS)],
            "pidxs": [2 * k + 1 for k in range(TRAIN_PAIRS)]}}, handle)
    exp = os.path.join(root, "exp")

    minings, steps, chain_inputs, gem_in, saved = [], [], [], [], {}
    counts = functools.partial(kernel_counts, clahe, lab_trilinear,
                               pooling_kernel)
    mine, step, chain, save = (TuplesDataset.create_epoch_tuples,
                               SupervisedEpoch._optimization_step,
                               TrainStep.chain, Checkpoints.save_epoch)

    def timed_mine(dataset, network):
        record = {"dataset": dataset, "rng": np.random.get_state(),
                  "weights": {k: v.clone() for k, v
                              in network.model.state_dict().items()},
                  "before": counts()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = mine(dataset, network)
        torch.cuda.synchronize()
        record.update(seconds=time.perf_counter() - t, after=counts(),
                      mined=dict(dataset.mined),
                      nidxs=[list(n) for n in dataset.nidxs])
        minings.append(record)
        return stats

    def timed_step(epoch, network, optimizer, images, targets):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = step(epoch, network, optimizer, images, targets)
        torch.cuda.synchronize()
        steps.append((epoch.epoch, time.perf_counter() - t, len(images)))
        return losses

    def recorded_chain(train_step, batch, valid):
        chain_inputs.append((batch.clone(), np.array(valid)))
        return chain(train_step, batch, valid)

    def recorded_save(store, networks_state, *args, **kwargs):
        saved[args[1]] = networks_state
        return save(store, networks_state, *args, **kwargs)

    patches = contextlib.ExitStack()
    for owner, name, fn in (
            (TuplesDataset, "create_epoch_tuples", timed_mine),
            (SupervisedEpoch, "_optimization_step", timed_step),
            (TrainStep, "chain", recorded_chain),
            (Checkpoints, "save_epoch", recorded_save),
            (pooling_kernel, "gem_l2n", recording_pool(
                pooling_kernel.gem_l2n, gem_in))):
        patches.enter_context(mock.patch.object(owner, name, fn))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pooling_kernel.reset_launches()
    lab_trilinear.reset_launches()
    clahe.reset_launches()
    t = time.perf_counter()
    with patches, contextlib.redirect_stdout(io.StringIO()):
        meta, = train(train_scenario(exp, db_pkl, TRAIN_EPOCHS), (),
                      device=device)
    seconds = time.perf_counter() - t
    total = counts()
    peak = torch.cuda.max_memory_allocated()
    mining = {name: sum(m["after"][name] - m["before"][name]
                        for m in minings) for name in total}
    launches = {name: {"mining": mining[name],
                       "train_step": total[name] - mining[name]}
                for name in total}
    losses = meta["metrics"]["train/learning/loss:total_avg.4"]
    n_mined = TRAIN_QUERY_SIZE + TRAIN_POOL_SIZE
    for epoch, record in enumerate(minings):
        step_s = [s for e, s, _ in steps if e == epoch]
        tuples = sum(n for e, _, n in steps if e == epoch)
        say("train", "epoch %d: mining %d images in %d chunks %.2f s "
            "(%.1f images/s); %d steps %.3f s/step (%.1f tuples/s); loss "
            "%.6f" % (epoch, n_mined, record["after"]["gem_l2n"]
                      - record["before"]["gem_l2n"], record["seconds"],
                      n_mined / record["seconds"], len(step_s),
                      np.mean(step_s), tuples / sum(step_s), losses[epoch]))
    epochs_dir = os.path.join(exp, "epochs")
    ckpt_mb = sum(os.path.getsize(os.path.join(epochs_dir, name))
                  for name in os.listdir(epochs_dir)
                  if not os.path.islink(os.path.join(epochs_dir, name))) / 1e6
    say("train", "VGG16-GeM %s, contrastive, adam: %d epochs in %.2f s "
        "(checkpoints included: %.0f MB kept), peak %.2f GB; launches %s"
        % (CLAHE_TRANSFORM, TRAIN_EPOCHS, seconds, ckpt_mb, peak / 1e9,
           launches))
    # 5. every epoch's loss
    check(len(losses) == TRAIN_EPOCHS
          and all(np.isfinite(x) and x > 0 for x in losses),
          ("finite positive losses", losses))
    for name, n in launches.items():
        check(n["mining"] > 0 and (name == "gem_l2n" or n["train_step"] > 0),
              ("train path launched %s" % name, n))
    check(launches["gem_l2n"]["train_step"] == 0,
          "the step's GeM runs under autograd (plain)")

    # 1. the step's chain on every tuple bucket against the plain kernels
    dataset = minings[-1]["dataset"]
    chain_fn = make_bucketed_chain(dataset.device_chain)
    clip, grid = dataset.device_chain.clahe_params
    for batch, valid in chain_inputs:
        aux = aux_to_device(clahe_bucket_aux(
            [tuple(int(x) for x in v) for v in valid], batch.shape[1:3],
            clip, grid), device)
        out = chain_fn(batch, aux)
        with plain_clahe_kernels(clahe, lab_trilinear):
            ref = chain_fn(batch, aux)
        check_equal(out, ref, ("train-step chain", tuple(batch.shape)))
        check_equal(lab_trilinear.lab_n(batch),
                    lab_trilinear.lab_n_plain(batch), ("lab_n", "train"))
        clahe_against_plain(clahe, lab_trilinear.lab_l_u8(batch), aux, grid,
                            ("train", tuple(batch.shape)))
    say("train", "train-step chain and its three kernels bit-equal to plain "
        "on all %d tuple buckets %s"
        % (len(chain_inputs),
           sorted({tuple(b.shape) for b, _ in chain_inputs})))
    gem_err = gem_train_inputs(pooling_kernel, gem_l2n_plain, gem_in, device)

    # 2. mining with the kernels against the plain versions, per epoch:
    # descriptors within DESC_ATOL and the same negatives in every epoch.
    # Seeded weights collapse the descriptors (every query-pool score near
    # 1; the span is printed), so the smallest score gap the picks relied
    # on is printed beside the descriptor tolerance: under it, the same
    # negatives are not implied by the tolerance (an open item until
    # published weights are in the repository)
    net = initialize_network(None, device, dict(saved[TRAIN_EPOCHS - 1]))
    desc_err = score_err = 0.0
    gaps = []
    for epoch, record in enumerate(minings):
        net.model.load_state_dict(record["weights"])
        np.random.set_state(record["rng"])
        with plain_clahe_kernels(clahe, lab_trilinear), \
                mock.patch.object(pooling_kernel, "gem_l2n", gem_l2n_plain), \
                contextlib.redirect_stdout(io.StringIO()):
            mine(record["dataset"], net)
        plain, mined = record["dataset"].mined, record["mined"]
        for key in ("qvecs", "poolvecs"):
            desc_err = max(desc_err, float(np.abs(
                plain[key] - mined[key]).max()))
        score_err = max(score_err, float(np.abs(
            plain["scores"] - mined["scores"]).max()))
        gaps.append(selection_gap(**mined))
        differing = [q for q, nidxs in enumerate(record["dataset"].nidxs)
                     if nidxs != record["nidxs"][q]]
        check(not differing, ("mined negatives, kernels against plain",
                              epoch, differing))
    scores = np.concatenate([r["mined"]["scores"].ravel() for r in minings])
    say("train", "mining, kernels against plain: max |desc diff| %.2e, max "
        "|score diff| %.2e; the same negatives for all %d queries in %d "
        "epochs; query-pool scores span [%.4f, %.4f]; smallest score gap "
        "the picks relied on %s (descriptor tolerance %g%s)"
        % (desc_err, score_err, TRAIN_QUERY_SIZE, len(minings),
           scores.min(), scores.max(), ["%.2e" % g for g in gaps],
           DESC_ATOL, "; under it, the same negatives are not implied by "
           "the tolerance" if min(gaps) < DESC_ATOL else ""))
    check(desc_err <= DESC_ATOL, ("mining descriptors vs plain", desc_err))

    # 4. the epoch-2 checkpoint reloads bit for bit; resume to 3 epochs
    last = load_checkpoint_any(os.path.join(
        exp, "epochs", "net_epoch_%02d.ckpt" % TRAIN_EPOCHS))
    live = saved[TRAIN_EPOCHS - 1]["net"]["model_state"]
    reloaded = initialize_network(None, device, {"net": last}).state_dict()
    for name, value in live.items():
        check(torch.equal(last["model_state"][name], value)
              and torch.equal(reloaded["net"]["model_state"][name], value),
              ("checkpoint reload", name))
    minings.clear()
    with mock.patch.object(TuplesDataset, "create_epoch_tuples",
                           timed_mine), \
            contextlib.redirect_stdout(io.StringIO()):
        resumed, = train(train_scenario(exp, db_pkl, TRAIN_EPOCHS + 1), (),
                         device=device)
    resumed = resumed["metrics"]["train/learning/loss:total_avg.4"]
    check(len(minings) == 1 and resumed[:TRAIN_EPOCHS] == losses
          and np.isfinite(resumed[-1]) and resumed[-1] > 0,
          ("resumed epoch", len(minings), resumed, losses))
    say("train", "epoch-%d checkpoint reloads bit-equal (%d tensors); "
        "resumed, epoch %d's loss %.6f" % (TRAIN_EPOCHS, len(live),
                                           TRAIN_EPOCHS, resumed[-1]))

    # 3. one step on the card against the CPU at a reduced size
    card_cpu_step(device, dataset, saved[TRAIN_EPOCHS - 1])
    # 6. two steps under auto (bf16 trunk, the guard) beside float32
    bf16 = bf16_train_steps(device, dataset, saved[TRAIN_EPOCHS - 1])
    shutil.rmtree(root, ignore_errors=True)
    TRAIN_IMAGES.clear()
    return {"launches": launches, "gem_err": gem_err, "bf16": bf16}


def conv_flops(model, x):
    """``model(x)`` and the operations of its convolutions on x, from their
    shapes: 2 per multiply-add, every tap of a transposed conv counted."""
    total = []

    def hook(module, inputs, output):
        taps = module.kernel_size[0] * module.kernel_size[1]
        if isinstance(module, torch.nn.ConvTranspose2d):
            total.append(2 * inputs[0].numel() * module.out_channels * taps)
        else:
            total.append(2 * output.numel() * module.in_channels * taps)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        return model(x), sum(total)
    finally:
        for handle in handles:
            handle.remove()


def composition_network(device, whiten_path):
    """The U-Net jointly N/D composition: P2pUNet -> VGG16-GeM, frozen."""
    from mdir_tpu_torch.learning.network import (CirNetwork,
                                                 SequentialNetwork,
                                                 SingleNetwork)
    from mdir_tpu_torch.models import initialize_model

    translator = SingleNetwork(
        initialize_model(UNET_MODEL, device=device, seed=SEED),
        SingleNetwork.NetworkParams(model=dict(UNET_MODEL), runtime={
            "wrappers": "reflectpad_divisible:%d" % UNET_DIVISOR,
            "data": dict(UNET_DATA)}))
    embedder = CirNetwork(
        initialize_model(CLAHE_MODEL, device=device, seed=SEED),
        CirNetwork.NetworkParams(model=dict(CLAHE_MODEL), runtime={
            "wrappers": {"train": None, "eval": {
                "0_cirwhiten": {"whitening": whiten_path,
                                "dimensions": None},
                "1_cirmultiscale": {"scales": SCALES}}}, **FLOAT32_RUNTIME}))
    return SequentialNetwork({"translate": translator, "embed": embedder},
                             ["translate", "embed"], frozen=True)


def composition_phase(device, db, queries, gnd, whiten_path, pooling_kernel,
                      gem_l2n_plain):
    """Phase 10: the U-Net jointly N/D composition through the composed
    extractor, its checks, and what the kernels line needs."""
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.ops.ranking import compute_map, rank_database
    from mdir_tpu_torch.parallel.extract import (ComposedExtractor,
                                                 _plain_ingress)

    network = composition_network(device, whiten_path)
    data = network.network_params.runtime["data"]
    mean_std = _plain_ingress(initialize_transforms(data["transforms"],
                                                    data["mean_std"]))
    check(list(mean_std) == UNET_DATA["mean_std"], ("the head's mean/std",
                                              mean_std))

    def run_path(images_sets, wrap_translate=None):
        out, chunks = [], 0
        for images in images_sets:
            extractor = ComposedExtractor(network, mean_std)
            check(extractor.divisor == UNET_DIVISOR
                  and extractor.host_dtype == np.uint8
                  and extractor.msp == PATH_P,
                  ("composed extractor", extractor.divisor, extractor.msp))
            if wrap_translate is not None:
                extractor.translate = wrap_translate(extractor.translate)
            for i, img in enumerate(images):
                extractor.add(i, img)
            out.append(extractor.finish(len(images)))
            chunks += extractor.chunks
        return out, chunks

    def ranks_of(out):
        vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for v in out)
        return rank_database(vecs, qvecs).cpu().numpy()

    gem_in = []
    with mock.patch.object(pooling_kernel, "gem_l2n",
                           recording_pool(pooling_kernel.gem_l2n, gem_in)):
        run_path((db, queries))  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, padded = [], []

    def timing(translate):
        def fn(x):
            padded.append(x.shape[0] * x.shape[2] * x.shape[3])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = translate(x)
            end.record()
            events.append((start, end))
            return y
        return fn

    pooling_kernel.reset_launches()
    t = time.perf_counter()
    out, chunks = run_path((db, queries), timing)
    ranks = ranks_of(out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = pooling_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    translate_ms = sum(a.elapsed_time(b) for a, b in events)
    n_images = len(db) + len(queries)
    say("unet", "P2pUNet (nested %d, reflectpad_divisible:%d) -> VGG16-GeM "
        "%d-d, scales %s, Lw: %d images in %d chunks, %.2f s, %.1f "
        "images/s, peak %.2f GB; translator %.1f ms (%.1f%% of the pass)"
        % (UNET_MODEL["nested_levels"], UNET_DIVISOR, CLAHE_DIM,
           [round(x, 4) for x in SCALES], n_images,
           chunks, seconds, n_images / seconds, peak / 1e9, translate_ms,
           100 * translate_ms / (1e3 * seconds)))
    for v in out:
        check(v.shape[0] == CLAHE_DIM and np.isfinite(v).all(),
              "finite descriptors of the composition path")
        norms = np.linalg.norm(v, axis=0)
        check(np.abs(norms - 1).max() < 1e-4, ("unit norms", norms))
    check(launches == chunks * len(SCALES) > 0,
          ("gem_l2n launches == chunks x scales", launches, chunks))
    mean_ap, _, pr, _ = compute_map(ranks, gnd, kappas=(1, 5, 10))
    say("unet", "gem_l2n launches %d = %d chunks x %d scales; mAP %.4f, "
        "mP@1/5/10 %s" % (launches, chunks, len(SCALES), mean_ap,
                          np.round(pr, 4).tolist()))

    with mock.patch.object(pooling_kernel, "gem_l2n", gem_l2n_plain):
        pout, _ = run_path((db, queries))
    desc_err = max(np.abs(a - b).max() for a, b in zip(out, pout))
    check(desc_err <= DESC_ATOL, ("descriptors vs plain pool", desc_err))
    check((ranks[:10] == ranks_of(pout)[:10]).all(),
          "top-10 ranks vs plain pool")
    say("unet", "plain pool on the card: max |desc diff| %.2e, top-10 ranks "
        "equal" % desc_err)

    # the batched extractor against the per-image SequentialNetwork path
    images = [np.ascontiguousarray(db[0][:h, :w])
              for h, w in UNET_CHECK_SHAPES]
    (batched,), chunks = run_path((images,))
    check(chunks == 1, ("the check's images make one chunk", chunks))
    mean, std = (np.asarray(v, np.float32) for v in mean_std)
    per_image = np.stack([
        network((img.astype(np.float32) / 255.0 - mean) / std).cpu().numpy()
        for img in images], axis=1)
    diff = np.abs(batched - per_image)
    check((diff <= UNET_ATOL + UNET_RTOL * np.abs(per_image)).all(),
          ("batched vs per-image", float(diff.max())))
    say("unet", "batched against per-image on %s (one chunk): max |diff| "
        "%.2e, within rtol %g, atol %g"
        % (UNET_CHECK_SHAPES, diff.max(), UNET_RTOL, UNET_ATOL))

    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand((1, 3, UNET_CHECK_SIDE, UNET_CHECK_SIDE),
                   generator=gen) * 2 - 1
    cpu_unet = initialize_model(UNET_MODEL, device="cpu", seed=SEED)
    with torch.no_grad():
        card = network["translate"].model(x.to(device)).cpu()
        cpu, flops = conv_flops(cpu_unet, x)
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    check(rel <= DESC_ATOL, ("U-Net card vs CPU", rel))
    say("unet", "U-Net forward at %d x %d, card against CPU: max |diff| / "
        "max |CPU| %.2e" % (UNET_CHECK_SIDE, UNET_CHECK_SIDE, rel))
    # the translator's work scales with its padded input's area
    work = flops / UNET_CHECK_SIDE ** 2 * sum(padded)
    say("unet", "translator: %.1f GFLOP a (1024, 768) input, %.2f TFLOP "
        "over the pass's %.1f Mpx of padded input, %.1f TFLOP/s (float32, "
        "TF32 off)" % (flops / UNET_CHECK_SIDE ** 2 * 1024 * 768 / 1e9,
                       work / 1e12, sum(padded) / 1e6,
                       work / translate_ms / 1e9))
    return {"launches": launches, "gem_inputs": gem_in, "network": network,
            "mean_std": mean_std, "out": out, "ranks": ranks,
            "images_per_s": n_images / seconds, "peak": peak}


def gem_train_inputs(pooling_kernel, gem_l2n_plain, inputs, device):
    """The pool kernel at every (shape, extents) mining gave it, against
    plain on random values."""
    gen = torch.Generator().manual_seed(SEED)
    distinct = {}
    for shape, valid in inputs:
        distinct.setdefault((shape, tuple(map(tuple, valid.tolist()))),
                            valid)
    err = 0.0
    for (shape, _), valid in distinct.items():
        x = torch.rand(shape, generator=gen).to(device)
        err = max(err, kernel_against_plain(pooling_kernel, gem_l2n_plain,
                                            x, valid))
    say("train", "gem_l2n at the %d mining inputs %s against plain: max err "
        "%.2e" % (len(distinct), sorted({s for s, _ in distinct}), err))
    return err


def card_cpu_step(device, dataset, state):
    """One batch's step from the same weights on the card and on the CPU,
    every image cut to a longer side of TRAIN_CHECK_SIDE."""
    from mdir_tpu_torch.learning.network import initialize_network
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.optim.criteria import initialize_criterion

    def cut(img):
        scale = TRAIN_CHECK_SIDE / max(img.shape[:2])
        return img[:max(1, int(img.shape[0] * scale)),
                   :max(1, int(img.shape[1] * scale))]

    items = [dataset[i] for i in range(TRAIN_BATCH)]
    images = [[cut(img) for img in tpl] for tpl, _ in items]
    targets = [target for _, target in items]
    results = []
    for where in (device, torch.device("cpu")):
        net = initialize_network(None, where, state).train()
        step = TrainStep(net, initialize_criterion(
            {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}),
            device_chain=dataset.device_chain)
        loss, _ = step.gradients(images, targets)
        results.append((float(loss), {name: p.grad.detach().cpu().double()
                                      for name, p
                                      in net.model.named_parameters()}))
    (card_loss, card), (cpu_loss, cpu) = results
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    cosines = {name: float((card[name] * cpu[name]).sum()
                           / (card[name].norm() * cpu[name].norm()))
               for name in cpu}
    worst = min(cosines, key=cosines.get)
    say("train", "one step at longer side %d (%d tuples), card against CPU: "
        "loss %.6f vs %.6f (rel %.2e), least gradient cosine %.7f (%s)"
        % (TRAIN_CHECK_SIDE, len(images), card_loss, cpu_loss, rel,
           cosines[worst], worst))
    check(rel <= LOSS_RTOL, ("card step loss vs CPU", card_loss, cpu_loss))
    check(cosines[worst] >= GRAD_MIN_COSINE,
          ("card step gradient vs CPU", worst, cosines[worst]))


def with_compute_dtype(network, mode):
    """``network`` over the same models with runtime ``compute_dtype``
    ``mode``: a composition's goes to its embedder, as yaml routes it."""
    from mdir_tpu_torch.learning.network import SequentialNetwork

    if isinstance(network, SequentialNetwork):
        members = dict(network.networks)
        tail = network.sequence[-1]
        members[tail] = with_compute_dtype(members[tail], mode)
        return SequentialNetwork(members, list(network.sequence),
                                 frozen=True)
    spec = network.network_params
    return type(network)(network.model, type(spec)(
        model=spec.model, runtime=dict(spec.runtime, compute_dtype=mode)),
        frozen=True)


class ChunkRows(list):
    """An extractor's ``results`` that also keeps each chunk's indices."""

    def __init__(self, sink):
        super().__init__()
        self.sink = sink

    def append(self, item):
        self.sink.append(list(item[0]))
        super().append(item)


def half_path_phase(tag, make_extractor, image_sets, f32, pooling_kernel,
                    device, mode="bfloat16"):
    """Phase 11 on one eval path: with ``compute_dtype`` ``mode``, bfloat16
    or float16 (a warm-up that records the pool's inputs, then a timed run:
    images/s, peak memory, each chunk's least row cosine and the top-10
    ranks against the float32 run ``f32`` of the path's phase; the kernel's
    instantiation for the mode must launch once per chunk x scale), then,
    for bfloat16, with ``auto``: the guard must run once, on the first
    chunk, and a rejection must ship float32 descriptors."""
    from mdir_tpu_torch.ops import dtypes as dtype_policy
    from mdir_tpu_torch.ops.ranking import rank_database

    def run(mode):
        outs, chunks, reports = [], [], []
        for k, images in enumerate(image_sets):
            extractor = make_extractor(mode)
            rows = []
            extractor.results = ChunkRows(rows)
            for i, img in enumerate(images):
                extractor.add(i, img)
            outs.append(extractor.finish(len(images)))
            chunks += [(k, r) for r in rows]
            reports.append(extractor.guard_report)
        ranks = rank_database(*(torch.from_numpy(
            np.ascontiguousarray(v)).to(device) for v in outs)).cpu().numpy()
        return outs, chunks, reports, ranks

    dtype = getattr(torch, mode)
    label = {"bfloat16": "bf16", "float16": "fp16"}[mode]
    gem_in, dtypes = [], []
    with mock.patch.object(pooling_kernel, "gem_l2n", recording_pool(
            pooling_kernel.gem_l2n, gem_in, dtypes)):
        run(mode)  # warm-up: 16-bit cuDNN plans, allocator
    check(set(dtypes) == {dtype}, ("%s pool inputs" % mode, set(dtypes)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pooling_kernel.reset_launches()
    t = time.perf_counter()
    outs, chunks, reports, ranks = run(mode)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = pooling_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    n_images = sum(len(images) for images in image_sets)
    check(all(r is None for r in reports), "explicit %s is unguarded" % mode)
    for v in outs:
        check(v.dtype == np.float32 and np.isfinite(v).all(),
              "finite float32 descriptors")
        norms = np.linalg.norm(v, axis=0)
        check(np.abs(norms - 1).max() < 1e-4, ("unit norms", norms))
    check(launches == len(chunks) * len(SCALES) > 0,
          ("%s gem_l2n launches == chunks x scales" % mode, launches,
           chunks))
    cosines = [float(dtype_policy.row_cosines(
        outs[k][:, idx].T, f32["out"][k][:, idx].T).min())
        for k, idx in chunks]
    agree = float((ranks[:10] == f32["ranks"][:10]).mean())
    say(label, "%s, %s: %d images in %d chunks, %.2f s, %.1f images/s "
        "(float32 %.1f), peak %.2f GB (float32 %.2f); least row cosine per "
        "chunk against float32 %s; top-10 ranks equal to float32's at %.1f%% "
        "of places; gem_l2n launches %d"
        % (tag, mode, n_images, len(chunks), seconds, n_images / seconds,
           f32["images_per_s"], peak / 1e9, f32["peak"] / 1e9,
           ["%.6f" % c for c in cosines], 100 * agree, launches))
    run_stats = {"gem_inputs": gem_in, "launches": launches,
                 "images_per_s": n_images / seconds, "peak": peak,
                 "min_cosine": min(cosines), "top10_agree": agree}
    if mode != "bfloat16":  # auto's fast dtype is bfloat16
        return run_stats

    outs_auto, _, reports, _ = run("auto")
    guard = reports[0]
    check(guard is not None and all(r is None for r in reports[1:]),
          ("auto: the guard runs once, on the first chunk", reports))
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs_auto,
                                                         f32["out"]))
    if not guard["ok"]:
        check(err <= DESC_ATOL, ("guard rejected: float32 shipped", err))
    say("bf16", "%s, auto: the guard on the first chunk %s (least row "
        "cosine %.6f, bar %g); max |desc - float32| %.2e"
        % (tag, "accepted bfloat16" if guard["ok"]
           else "rejected it: float32 from there on", guard["min_cosine"],
           dtype_policy.GUARD_MIN_COSINE, err))
    return dict(run_stats, guard=guard)


def bf16_train_steps(device, dataset, state):
    """Phase 9's bf16 steps: from the epoch-2 weights, two steps (adam) on
    the dataset's two batches with ``compute_dtype: auto`` (a bf16 trunk,
    the guard on the first step) beside the same two steps in float32."""
    from mdir_tpu_torch.learning.network import initialize_network
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.ops import dtypes as dtype_policy
    from mdir_tpu_torch.optim.criteria import initialize_criterion

    batches = []
    for b in range(2):
        items = [dataset[i] for i in range(b * TRAIN_BATCH,
                                           (b + 1) * TRAIN_BATCH)]
        batches.append(([tpl for tpl, _ in items], [t for _, t in items]))
    runs = {}
    for mode in ("float32", "auto"):
        net = initialize_network(None, device, state,
                                 {"compute_dtype": mode}).train()
        step = TrainStep(net, initialize_criterion(
            {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}),
            device_chain=dataset.device_chain)
        optimizer = torch.optim.Adam(net.model.parameters(), lr=1e-6)
        times, peaks, losses = [], [], []
        for images, targets in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            optimizer.zero_grad()
            loss, _ = step.gradients(images, targets)
            optimizer.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            peaks.append(torch.cuda.max_memory_allocated())
            losses.append(float(loss))
        runs[mode] = (step, times, peaks, losses)
        check(all(np.isfinite(x) and x > 0 for x in losses),
              ("finite positive losses", mode, losses))
        del net, step, optimizer
    step, times, peaks, losses = runs["auto"]
    _, f32_times, f32_peaks, f32_losses = runs["float32"]
    check(len(step.guard_reports) == 1 and step.guard_reports[0]["step"] == 1,
          ("the train guard runs on the first step", step.guard_reports))
    guard = step.guard_reports[0]
    if not guard["ok"]:
        check(abs(losses[0] - f32_losses[0]) <= LOSS_RTOL * f32_losses[0],
              ("train guard rejected: the float32 step", losses, f32_losses))
    say("train", "auto: the guard on step 1 %s (loss gap %.2e, gradient "
        "cosine %.6f, bars %g and %g); steps %.3f s (guarded) and %.3f s, "
        "peak %.2f and %.2f GB; float32 %.3f and %.3f s, peak %.2f and %.2f "
        "GB; losses %s, float32 %s"
        % ("accepted bfloat16" if guard["ok"] else "rejected it",
           guard["loss_gap"], guard["grad_cosine"],
           dtype_policy.TRAIN_GUARD_LOSS_RTOL,
           dtype_policy.TRAIN_GUARD_MIN_COSINE, times[0], times[1],
           peaks[0] / 1e9, peaks[1] / 1e9, f32_times[0], f32_times[1],
           f32_peaks[0] / 1e9, f32_peaks[1] / 1e9,
           ["%.6f" % x for x in losses], ["%.6f" % x for x in f32_losses]))
    return {"guard": guard, "s_per_step": times[1],
            "f32_s_per_step": f32_times[1], "peak": peaks[1],
            "f32_peak": f32_peaks[1]}


def dump_loader(path):
    """Phase 12's dataset loader: its in-memory uint8 images; for a name it
    has no image of, the OSError that ``pil_loader`` returns for a file
    that is not there."""
    name = os.path.basename(path)
    if name not in WHITEN_IMAGES:
        return FileNotFoundError(2, "No such file or directory", path)
    return WHITEN_IMAGES[name]


def expected_chunks(shapes):
    """The chunks the batched extractor runs for images of ``shapes``: one
    per MAX_BATCH images of a shape bucket, and one for each remainder."""
    import collections

    from mdir_tpu_torch.parallel import extract

    buckets = collections.Counter(
        (extract._round_up(h, extract.BUCKET_MULTIPLE),
         extract._round_up(w, extract.BUCKET_MULTIPLE)) for h, w in shapes)
    return sum(-(-n // extract.MAX_BATCH) for n in buckets.values())


def host_whiten(X, lw):
    """float64 ``whitenapply`` of D x N columns on the host."""
    y = lw["P"] @ (np.asarray(X, np.float64) - lw["m"])
    return y / (np.linalg.norm(y, axis=0, keepdims=True) + 1e-6)


def whiten_tolerance(X, lw, unit=F32_EPS, worst=False):
    """The error a whitening of the columns of X rounded at ``unit`` may
    have, from its conditioning. Each output is a dot product of length D
    over P and x - m, so |fl(y_i) - y_i| <= gamma (|P| |x - m|)_i, the
    rounding of P, m and x included. Higham's worst case has gamma =
    (D + 2) u (``worst``). With independent roundings the error grows as
    sqrt(D + 2) u (Higham and Mary's probabilistic bound, gamma = lambda
    sqrt(D + 2) u); the gate takes lambda = 1, the error's typical scale
    rather than a guarantee, since a bound that is one (lambda = 8) is
    loose enough to pass TF32 matmuls here. Normalising y to unit length
    at most doubles the relative error, so a column may be off by
    2 gamma || |P| |x - m| || / ||y||, which the cancellation in P (x - m)
    makes large when P is ill conditioned. The sums of |P| |x - m| and the
    column norm overstate one element's error again, about 100x here."""
    Xc = np.asarray(X, np.float64) - lw["m"]
    terms = lw["P"].shape[1] + 2
    gamma = (terms if worst else ROUNDING_LAMBDA * np.sqrt(terms)) * unit
    cancel = np.linalg.norm(np.abs(lw["P"]) @ np.abs(Xc), axis=0) \
        / np.linalg.norm(lw["P"] @ Xc, axis=0)
    return float(2 * gamma * cancel.max())


def host_ranks(db, queries):
    """Top-10 database indices per query from float64 scores."""
    scores = np.asarray(db, np.float64).T @ np.asarray(queries, np.float64)
    return np.argsort(-scores, axis=0, kind="stable")[:10]


def dump_phase(device, db, queries, path, composed, resnet, clahe,
               lab_trilinear, pooling_kernel):
    """Phase 12: the descriptor-dump and Lw-learning path -- the infer
    stage's embedding output, the whiten stages and the learned Lw through
    ``cirwhiten``, ``cirtorch_format``, and the infer stage's translation.
    Returns each kernel's launches on the path's runs."""
    import shutil

    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.learning import load_network
    from mdir_tpu_torch.learning.checkpoints import save_state
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.ops.ranking import rank_database
    from mdir_tpu_torch.ops.whitening import whitenapply_rows, whitenlearn
    from mdir_tpu_torch.parallel.extract import (extract_vectors_network,
                                                 network_extractor)
    from mdir_tpu_torch.parallel.translate import (StreamingTranslator,
                                                   host_u8_image)
    from mdir_tpu_torch.stages import cirtorch_format, infer, whiten

    root = os.path.join(_build.BUILD_ROOT, "smoke", "dump")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    counts = functools.partial(kernel_counts, clahe, lab_trilinear,
                               pooling_kernel)

    def reset():
        pooling_kernel.reset_launches()
        lab_trilinear.reset_launches()
        clahe.reset_launches()

    make_train_images(np.random.RandomState(SEED + 12), WHITEN_CLUSTERS,
                      WHITEN_CROPS, WHITEN_IMAGES)
    names = sorted(WHITEN_IMAGES)
    arrays = [WHITEN_IMAGES[name] for name in names]
    shapes = [a.shape[:2] for a in arrays]
    listed = list(names)
    listed.insert(WHITEN_MISSING_AT, WHITEN_MISSING)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # 1. the infer stage, embedding output, of the VGG16-GeM lab CLAHE net
    vgg = path["network"].model
    mean_std = [vgg.meta["mean"], vgg.meta["std"]]
    ckpt = os.path.join(root, "vgg16_clahe.ckpt")
    save_state(CirNetwork(vgg, CirNetwork.NetworkParams(
        model=dict(CLAHE_MODEL), runtime={
            "wrappers": {"train": None, "eval": {
                "1_cirmultiscale": {"scales": SCALES}}},
            "data": {"mean_std": mean_std, "transforms": CLAHE_TRANSFORM},
            **FLOAT32_RUNTIME})).state_dict()["net"], ckpt)
    params = {
        "network": {"path": ckpt, "runtime": None},
        "output": {"inference": {"name": "embedding"}, "debug": False},
        "data": {"test": {"dataset": {
            "name": "CirImageList", "image_dir": "", "image_size": IMAGE_SIZE,
            "ignore_errors": True, "loader": dump_loader}}}}
    loads = []  # seconds of each run's load_network, timed apart

    def timed_load(*args, **kwargs):
        t = time.perf_counter()
        net = load_network(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t)
        return net

    infer_s = []
    with mock.patch.object(infer, "load_network", timed_load):
        for run in range(DUMP_REPEATS + 1):
            torch.cuda.synchronize()
            if run == 1:
                reset()
            t = time.perf_counter()
            _, out_names, vecs = infer.infer(copy.deepcopy(params),
                                             (list(listed),), device=device)
            torch.cuda.synchronize()
            infer_s.append(time.perf_counter() - t)
            if run == 1:
                launches = {"infer_embedding": counts()}
    runs = [(wall, wall - load)
            for wall, load in zip(infer_s[1:], loads[1:])]
    chunks = expected_chunks(shapes)
    missing = np.isnan(vecs).all(axis=1)
    check(list(out_names) == listed and vecs.shape == (len(listed),
                                                       CLAHE_DIM),
          ("infer output", vecs.shape))
    check(np.flatnonzero(missing).tolist() == [WHITEN_MISSING_AT],
          ("one NaN row, at the missing name", np.flatnonzero(missing)))
    vecs = vecs[~missing]
    check(np.isfinite(vecs).all(), "finite infer rows")
    check(launches["infer_embedding"]["gem_l2n"] == chunks * len(SCALES)
          and all(launches["infer_embedding"][name] == chunks
                  for name in ("lab_n", "clahe_tile_luts", "clahe_interp")),
          ("infer launches: gem_l2n chunks x scales, the chain chunks",
           launches["infer_embedding"], chunks))
    transform = initialize_transforms(CLAHE_TRANSFORM, mean_std)
    ref = extract_vectors_network(
        load_network({"path": ckpt, "runtime": None}, device=device),
        arrays, None, transform)
    check(np.array_equal(vecs.astype(np.float32), ref.T),
          ("infer rows vs extract_vectors_network",
           float(np.abs(vecs - ref.T).max())))
    say("dump", "infer (embedding) of %d images + 1 missing, VGG16-GeM "
        "lab CLAHE, scales %s, %d runs after a warm one: %s s, of which "
        "the network load %s s; without the load %s images/s; launches "
        "%s for %d chunks (the first timed run); rows bit-equal to "
        "extract_vectors_network, NaN row at index %d"
        % (len(names), [round(x, 4) for x in SCALES], DUMP_REPEATS,
           ["%.3f" % wall for wall, _ in runs],
           ["%.3f" % load for load in loads[1:]],
           ["%.1f" % (len(names) / run) for _, run in runs],
           launches["infer_embedding"], chunks, WHITEN_MISSING_AT))

    # 2. learn Lw, apply it with the whiten stage and through cirwhiten
    cluster = [name for name in names for _ in range(WHITEN_CROPS - 1)]
    positives = [other for i, name in enumerate(names)
                 for other in names[i - i % WHITEN_CROPS:
                                    i - i % WHITEN_CROPS + WHITEN_CROPS]
                 if other != name]
    check(len(cluster) == len(positives) == 448, "448 ordered pairs")
    t = time.perf_counter()
    lw_meta, lw = whiten.learn_lw_whitening({}, (names, vecs, cluster,
                                                 positives))
    learn_s = time.perf_counter() - t
    # 64 images span at most 63 directions of the 512: the rows of P past
    # them are eigenvectors of a zero eigenspace, complex and arbitrary
    # (numpy's eig), so the Lw applied is P's leading real rows
    complex_rows = np.flatnonzero(np.abs(np.imag(lw["P"])).max(axis=1) > 0)
    dims = int(complex_rows[0]) if len(complex_rows) else lw["P"].shape[0]
    check(dims > 0, "P has real leading rows")
    applied = {"m": lw["m"], "P": np.ascontiguousarray(np.real(
        lw["P"][:dims]))}
    sv = np.linalg.svd(applied["P"], compute_uv=False)
    lw_path = os.path.join(root, "lw_vgg16_clahe.pkl")
    with open(lw_path, "wb") as handle:
        pickle.dump(applied, handle)
    say("dump", "learn_lw_whitening on %d rows, %d pairs: %.2f s, "
        "failed_times %d; cond(P) %.3e (all %d rows, real part), %d real "
        "leading rows applied, cond %.3e"
        % (len(names), len(cluster), learn_s,
           lw_meta["stats"]["failed_times"],
           np.linalg.cond(np.real(lw["P"])), lw["P"].shape[0], dims,
           sv[0] / sv[-1]))
    _, _, white = whiten.whiten({}, (applied, names, vecs), device=device)
    tol = whiten_tolerance(vecs.T, applied)
    host = host_whiten(vecs.T, applied).T
    err = float(np.abs(white - host).max())
    check(err <= tol, ("whiten stage vs host float64", err, tol))
    tf32 = "not run off the card"
    if device.type == "cuda":
        # the gate's control: the stage's apply with TF32 matmuls must fail
        # it (called below the stage, whose resolve_device turns TF32 off)
        allowed = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            white_tf32 = whitenapply_rows(*(
                torch.as_tensor(np.asarray(x, np.float32), device=device)
                for x in (vecs, applied["m"], applied["P"]))).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allowed
        err_tf32 = float(np.abs(white_tf32 - host).max())
        check(err_tf32 > tol, ("a TF32 apply passes the gate", err_tf32,
                               tol))
        tf32 = "%.2e (its own bound %.2e), failing it" % (
            err_tf32, whiten_tolerance(vecs.T, applied, TF32_EPS))
    say("dump", "whiten stage on the card against host float64: max |diff| "
        "%.2e, tolerance %.2e from the conditioning (statistical, lambda "
        "%.0f; worst case %.2e); the apply with TF32 matmuls %s"
        % (err, tol, ROUNDING_LAMBDA,
           whiten_tolerance(vecs.T, applied, worst=True), tf32))

    model = path["network"].model
    out = {}
    for tag, wrappers in (
            ("white", {"0_cirwhiten": {"whitening": lw_path,
                                       "dimensions": None},
                       "1_cirmultiscale": {"scales": SCALES}}),
            ("plain", {"1_cirmultiscale": {"scales": SCALES}})):
        net = CirNetwork(model, CirNetwork.NetworkParams(
            model=dict(CLAHE_MODEL), runtime={
                "wrappers": {"train": None, "eval": wrappers},
                **FLOAT32_RUNTIME}), frozen=True)
        out[tag] = []
        for images in (db, queries):
            extractor = network_extractor(net, path["transform"])
            for i, img in enumerate(images):
                extractor.add(i, img)
            out[tag].append(extractor.finish(len(images)))
    host = [host_whiten(v, applied) for v in out["plain"]]
    tol = max(whiten_tolerance(v, applied) for v in out["plain"])
    err = max(float(np.abs(a - b).max()) for a, b in zip(out["white"], host))
    check(err <= tol, ("cirwhiten vs host whitenapply", err, tol))
    card_ranks = rank_database(*(torch.from_numpy(np.ascontiguousarray(v))
                                 .to(device) for v in out["white"]))
    check((card_ranks.cpu().numpy()[:10] == host_ranks(*host)).all(),
          "top-10 ranks, cirwhiten vs host whitenapply")
    say("dump", "phase 7's path with that Lw (cirwhiten, %d-d) on %d "
        "images against host float64 whitenapply of its unwhitened "
        "descriptors: max |diff| %.2e, tolerance %.2e (worst case %.2e); "
        "top-10 ranks equal"
        % (dims, len(db) + len(queries), err, tol,
           max(whiten_tolerance(v, applied, worst=True)
               for v in out["plain"])))

    # 3. cirtorch_format: the phase-4 ResNet101-GeM as an official file
    official = os.path.join(root, "resnet101_gem_official.pth")
    torch.save({"meta": {
        "architecture": "resnet101", "local_whitening": False,
        "pooling": "gem", "regional": False, "whitening": False,
        "mean": resnet["mean_std"][0], "std": resnet["mean_std"][1],
        "outputdim": 2048, "Lw": None},
        "state_dict": {k: v.cpu() for k, v
                       in resnet["model"].state_dict().items()}}, official)
    converted = os.path.join(root, "resnet101_gem_converted.ckpt")
    t = time.perf_counter()
    cirtorch_format.convert_contained_net({"source": official,
                                           "net": converted}, ())
    convert_s = time.perf_counter() - t
    runtime = {"wrappers": "", "data": {"mean_std": resnet["mean_std"],
               "transforms": "pil2np | totensor | normalize"},
               **FLOAT32_RUNTIME}
    nets = [CirNetwork(resnet["model"], CirNetwork.NetworkParams(
                model=dict(MODEL), runtime=runtime), frozen=True),
            load_network({"path": converted,
                          "runtime": dict(FLOAT32_RUNTIME)}, device=device)]
    descs = []
    for net in nets:
        extractor = network_extractor(net, resnet["transform"])
        for i, img in enumerate(db + queries):
            extractor.add(i, img)
        descs.append(extractor.finish(len(db) + len(queries)))
    check(np.array_equal(*descs),
          ("converted net vs source", float(np.abs(descs[0]
                                                   - descs[1]).max())))
    model, meta, _ = cirtorch_format._load_official(official, device)
    torch.cuda.synchronize()
    reset()
    t = time.perf_counter()
    wvecs = cirtorch_format._extract(model, meta, arrays, IMAGE_SIZE,
                                     SCALES)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t
    launches["learn_whitening"] = counts()
    check(launches["learn_whitening"]["gem_l2n"] == chunks * len(SCALES),
          ("learn_whitening gem_l2n launches", launches["learn_whitening"],
           chunks))
    index = {name: i for i, name in enumerate(names)}
    t = time.perf_counter()
    m, P = whitenlearn(wvecs, [index[n] for n in cluster],
                       [index[n] for n in positives])
    whitenlearn_s = time.perf_counter() - t
    check(P.shape == (2048, 2048) and m.shape == (2048, 1),
          ("whitenlearn of the extraction", P.shape))
    say("dump", "cirtorch_format: convert_contained_net %.2f s; the "
        "converted ResNet101-GeM bit-equal to its source on %d images; "
        "learn_whitening's _extract of %d images at scales %s: %.2f s "
        "(gem_l2n %d launches = %d chunks x %d), whitenlearn 2048-d %.2f s"
        % (convert_s, len(db) + len(queries), len(names),
           [round(x, 4) for x in SCALES], extract_s,
           launches["learn_whitening"]["gem_l2n"], chunks, len(SCALES),
           whitenlearn_s))

    # 4. the infer stage's translation: phase 10's P2pUNet, batched
    translator = composed["network"]["translate"].eval()
    mean, std = (np.asarray(v, np.float32) for v in UNET_DATA["mean_std"])
    kept = {}

    def translate(spans, depth):
        stream = StreamingTranslator(
            translator, lambda i, inp, res: kept.__setitem__(
                i, host_u8_image(res[0], mean, std)),
            mean_std=UNET_DATA["mean_std"], depth=depth)
        forward = stream.model

        def timed_forward(x):
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
            out = forward(x)
            span[1].record()
            spans.append(span)
            return out

        stream.model = timed_forward
        for i, img in enumerate(arrays):
            stream.add(i, img)
        stream.finish()
        return stream.batches

    # two batches in flight (the default) and, alternating with them, none
    # (each batch drained as soon as it is queued): one pass of each warm
    passes = {2: [], 0: []}  # depth -> [(wall s, forwards' device ms)]
    for run in range(DUMP_REPEATS + 1):
        for depth in passes:
            spans = []
            torch.cuda.synchronize()
            if run == 1 and depth == 2:
                reset()
            t = time.perf_counter()
            batches = translate(spans, depth)
            torch.cuda.synchronize()
            passes[depth].append((time.perf_counter() - t, sum(
                a.elapsed_time(b) for a, b in spans)))
            if run == 1 and depth == 2:
                launches["translation"] = counts()
    differ = total = worst = 0
    for i, img in enumerate(arrays):
        with torch.no_grad():
            single = translator((img.astype(np.float32) / 255.0 - mean)
                                / std)
        single = host_u8_image(single[0].permute(1, 2, 0).cpu().numpy(),
                               mean, std)
        check(kept[i].shape == img.shape == single.shape,
              ("translated shape", kept[i].shape, img.shape))
        diff = np.abs(kept[i].astype(np.int16) - single)
        worst = max(worst, int(diff.max()))
        differ += int((diff > 0).sum())
        total += diff.size
    check(worst <= 1, ("batched vs per-image translation", worst))
    peak = torch.cuda.max_memory_allocated()
    for depth, timed in passes.items():
        say("dump", "translation of %d images at up to %d px, P2pUNet "
            "(reflectpad_divisible:%d) in %d batches, %d in flight, %d "
            "passes after a warm one: %s s, %s images/s; the forwards' "
            "device time (CUDA events) %s ms, %s of the pass"
            % (len(arrays), IMAGE_SIZE, UNET_DIVISOR, batches, depth,
               DUMP_REPEATS, ["%.3f" % wall for wall, _ in timed[1:]],
               ["%.1f" % (len(arrays) / wall) for wall, _ in timed[1:]],
               ["%.1f" % busy for _, busy in timed[1:]],
               ["%.1f%%" % (busy / 10.0 / wall) for wall, busy in timed[1:]]))
    say("dump", "translation against the per-image path: max |diff| %d "
        "level, %.4f%% of values differ; phase peak %.2f GB"
        % (worst, 100.0 * differ / total, peak / 1e9))
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; it runs on a card only")
    # the port is imported only now: a copy of this file alone fails here
    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.device import resolve_device
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.ops import clahe, lab_trilinear, pooling_kernel
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
    max_err = 0.0
    for shape in KERNEL_SHAPES:
        x = torch.rand(shape, generator=gen).to(device)
        valid = ragged_valid(gen, shape[0], shape[2], shape[3], device)
        err = kernel_against_plain(pooling_kernel, gem_l2n_plain, x, valid)
        max_err = max(max_err, err)
        say("kernel", "gem_l2n %s ragged, p in %s: max |kernel - plain| "
            "%.2e" % (shape, P_VALUES, err))
    half_err = {}
    for dtype in HALF_TYPES:
        half_err[dtype] = 0.0
        for shape in BF16_KERNEL_SHAPES:
            x = torch.rand(shape, generator=gen).to(device, dtype)
            valid = ragged_valid(gen, shape[0], shape[2], shape[3], device)
            half_err[dtype] = max(
                half_err[dtype],
                kernel_against_plain(pooling_kernel, gem_l2n_plain, x, valid),
                kernel_against_plain(pooling_kernel, gem_l2n_plain,
                                     offset_copy(x), valid))
        say("kernel", "gem_l2n on %s maps %s ragged, and on views 4 bytes "
            "past a 16-byte boundary, p in %s: max |kernel - plain| %.2e"
            % (str(dtype)[6:], BF16_KERNEL_SHAPES, P_VALUES,
               half_err[dtype]))
    head_gradients_phase(device, gen)

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
            "1_cirmultiscale": {"scales": SCALES}}}, **FLOAT32_RUNTIME}),
        frozen=True)
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
    pooling_kernel.reset_launches()
    t = time.perf_counter()
    with mock.patch.object(pooling_kernel, "gem_l2n", recording_pool(
            pooling_kernel.gem_l2n, shapes_seen)):
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

    # 5. the kernel at the main path's inputs; time against plain and bound
    resnet_pool = gem_path_phase("ResNet101", pooling_kernel, gem_l2n_plain,
                                 shapes_seen, gen, device)

    # 6-8. the lab CLAHE chain's kernels and the CLAHE main path
    clahe_kernel_phase(device, clahe, lab_trilinear)
    path = clahe_path_phase(device, db, queries, gnd, rng)
    timed = clahe_timing_phase(clahe, lab_trilinear, path["inputs"],
                               path["grid"])
    vgg_pool = gem_path_phase("VGG16 CLAHE", pooling_kernel, gem_l2n_plain,
                              path["gem_inputs"], gen, device)

    # 9. the train stage: mining and train steps on the same kernels
    trained = train_phase(device, clahe, lab_trilinear, pooling_kernel)

    # 10. the U-Net jointly N/D composition path
    composed = composition_phase(device, db, queries, gnd,
                                 path["whiten_path"], pooling_kernel,
                                 gem_l2n_plain)
    unet_pool = gem_path_phase("U-Net VGG16", pooling_kernel, gem_l2n_plain,
                               composed["gem_inputs"], gen, device)

    # 11. the three eval paths in bfloat16 and under auto, and the bf16
    # kernel at every input they gave it
    from mdir_tpu_torch.parallel.extract import ComposedExtractor

    image_sets = (db, queries)
    bf16 = {
        "ResNet101": half_path_phase(
            "ResNet101-GeM", lambda mode: network_extractor(
                with_compute_dtype(network, mode), transform), image_sets,
            {"out": (vecs, qvecs), "ranks": ranks,
             "images_per_s": n_images / seconds, "peak": peak},
            pooling_kernel, device),
        "VGG16 CLAHE": half_path_phase(
            "VGG16-GeM lab CLAHE", lambda mode: network_extractor(
                with_compute_dtype(path["network"], mode),
                path["transform"]), image_sets, path, pooling_kernel,
            device)}
    composition_nets = {}

    def composed_extractor(mode):
        if mode not in composition_nets:  # one embedder per mode: its guard
            composition_nets[mode] = with_compute_dtype(composed["network"],
                                                        mode)
        return ComposedExtractor(composition_nets[mode], composed["mean_std"])

    bf16["U-Net VGG16"] = half_path_phase(
        "U-Net jointly N/D", composed_extractor, image_sets, composed,
        pooling_kernel, device)
    # the VGG16 lab CLAHE path in float16 (forced, unguarded: the JAX
    # package sets no bar for it, so its cosine is a finding, not a gate)
    f16 = half_path_phase(
        "VGG16-GeM lab CLAHE", lambda mode: network_extractor(
            with_compute_dtype(path["network"], mode), path["transform"]),
        image_sets, path, pooling_kernel, device, mode="float16")
    # both 16-bit kernels at every map the three bf16 paths gave the pool,
    # and the float16 kernel at the float16 path's own maps
    half_pools = {(tag, dtype): gem_path_phase(
        tag + " bf16", pooling_kernel, gem_l2n_plain, run["gem_inputs"],
        gen, device, dtype) for tag, run in bf16.items()
        for dtype in HALF_TYPES}
    f16_pool = gem_path_phase("VGG16 CLAHE fp16", pooling_kernel,
                              gem_l2n_plain, f16["gem_inputs"], gen, device,
                              torch.float16)
    # 12. the descriptor-dump and Lw-learning path
    dump_launches = dump_phase(device, db, queries, path, composed, {
        "model": model, "mean_std": (model.meta["mean"], model.meta["std"]),
        "transform": transform}, clahe, lab_trilinear, pooling_kernel)
    sources = {"lab_n": ("mdir_tpu_torch/csrc/lab_n.cu",
                         "mdir_tpu/ops/lab_trilinear.py:493",
                         ["mdir_tpu/ops/lab_trilinear.py:359"],
                         ["lab_trilinear.lab_l_u8"]),
               "clahe_tile_luts": ("mdir_tpu_torch/csrc/clahe.cu",
                                   "mdir_tpu/ops/clahe_pallas.py:157",
                                   ["mdir_tpu/ops/clahe_pallas.py:185"],
                                   ["clahe.clahe_u8"]),
               "clahe_interp": ("mdir_tpu_torch/csrc/clahe.cu",
                                "mdir_tpu/ops/clahe_pallas.py:262",
                                ["mdir_tpu/ops/clahe_pallas.py:75",
                                 "mdir_tpu/ops/clahe_pallas.py:185"],
                                ["clahe.clahe_u8"])}
    kernels = [{
        "name": "gem_l2n", "route": "cuda",
        "source": "mdir_tpu_torch/csrc/gem_l2n.cu",
        "replaces": "mdir_tpu/ops/pooling_pallas.py:59",
        "launches": launches,
        "max_abs_err": max(max_err, resnet_pool["max_abs_err"],
                           vgg_pool["max_abs_err"], trained["gem_err"],
                           unet_pool["max_abs_err"]),
        **resnet_pool["timed"], "library_ms": None,
        "small_batch": resnet_pool["small_batch"],
        "clahe_path_launches": path["launches"]["gem_l2n"],
        "clahe_path": dict(vgg_pool["timed"],
                           small_batch=vgg_pool["small_batch"]),
        "composition_path_launches": composed["launches"],
        "composition_path": dict(unet_pool["timed"],
                                 small_batch=unet_pool["small_batch"])}]
    for name, (source, replaces, also, wrappers) in sources.items():
        kernels.append(dict(
            {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": path["launches"][name],
             "max_abs_err": 0.0}, **timed[name], library_ms=None,
            also_replaces=also, off_path_wrappers=wrappers))
    for entry in kernels:
        entry["train_path_launches"] = trained["launches"][entry["name"]]
        entry.setdefault("composition_path_launches", 0)

    # the 16-bit-input instantiations of the same source (the train step
    # pools under autograd, so neither runs there). Each entry's top-level
    # times are those of its launches' path: bf16's the bf16 ResNet path's
    # maps, float16's the float16 VGG16 CLAHE path's.
    def half_entry(dtype, launches, pool, err):
        return {
            "name": "gem_l2n_" + {torch.bfloat16: "bf16",
                                  torch.float16: "f16"}[dtype],
            "route": "cuda", "source": "mdir_tpu_torch/csrc/gem_l2n.cu",
            "replaces": "mdir_tpu/ops/pooling_pallas.py:59",
            "launches": launches, "max_abs_err": err, **pool["timed"],
            "library_ms": None, "small_batch": pool["small_batch"],
            "train_path_launches": {"mining": 0, "train_step": 0}}

    def path_times(pool):
        return dict(pool["timed"], small_batch=pool["small_batch"])

    bf16_pools = {tag: half_pools[(tag, torch.bfloat16)] for tag in bf16}
    bf16_entry = half_entry(
        torch.bfloat16, bf16["ResNet101"]["launches"], bf16_pools["ResNet101"],
        max([half_err[torch.bfloat16]]
            + [run["max_abs_err"] for run in bf16_pools.values()]))
    bf16_entry.update(
        clahe_path_launches=bf16["VGG16 CLAHE"]["launches"],
        clahe_path=path_times(bf16_pools["VGG16 CLAHE"]),
        composition_path_launches=bf16["U-Net VGG16"]["launches"],
        composition_path=path_times(bf16_pools["U-Net VGG16"]))
    # float16 runs on the VGG16 CLAHE path only; its kernel is also held
    # and timed at the bf16 paths' maps, which no float16 path launches
    f16_off = {tag: half_pools[(tag, torch.float16)] for tag in bf16}
    f16_entry = half_entry(
        torch.float16, f16["launches"], f16_pool,
        max([half_err[torch.float16], f16_pool["max_abs_err"]]
            + [run["max_abs_err"] for run in f16_off.values()]))
    f16_entry.update(
        path="VGG16-GeM lab CLAHE, compute_dtype float16",
        min_cosine_vs_float32=f16["min_cosine"],
        images_per_s=f16["images_per_s"], composition_path_launches=0,
        off_path={tag + " bf16 maps": path_times(run)
                  for tag, run in f16_off.items()})
    kernels[1:1] = [bf16_entry, f16_entry]
    for entry in kernels:
        if entry["name"] in REDESIGNED:
            entry["redesigned"] = REDESIGNED[entry["name"]]
        entry["dump_path_launches"] = {
            run: counted.get(entry["name"], 0)
            for run, counted in dump_launches.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
