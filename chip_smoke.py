#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mdir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # no arguments, no environment variables

Phases, one line each with its wall time:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every CUDA source of the port into
     build/mdir_tpu_torch/ (seconds, registers, shared memory); while it
     runs, phase 4's images and network are made and its passes that need
     no kernel of the port run (the plain pool's, which also warms cuDNN
     and the allocator, and the small input's on the CPU), and phase 9's
     images are made (phase 15 crops them);
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
     2 epochs of mining and steps with checkpoints, then resumed to 3,
     through the device image cache (``device_cache_mb`` 512: the 60
     images take about 129 MB on the card), the steps on the items mining
     left in it (the mining -> train hand-off). Checks: the epoch-2 mining
     hits the cache, its chunks launch gem_l2n and the three chain kernels,
     and its query and pool descriptors are bit-equal to one uncached
     re-extraction of the same images; one tuple's bucket assembled from
     the cache is bit-equal to ``pad_image_batch`` of its loaded images;
     the steps took cached items; the train step's chain bit-equal to the
     plain versions on
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
     scale and each CLAHE kernel once per chunk (a timed run, images/s
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
     ``StreamingTranslator``, a timed pass with two batches in
     flight and one with none, of the input shapes and within one level
     of the per-image path (images/s, the forwards' device time and share
     of the pass, share of differing values, the phase's peak memory);
 13. the rest of the photometric chain, in float32, on phase 7's VGG16-GeM
     (scales 1, 2^-1/2, 1/2, Lw) and the same 40 images: the device chains
     pil2np | apply_clahe:4:lsh:8 | totensor | normalize, the same in luv,
     and pil2np | tospace:lab | totensor | normalize. The CLAHE kernels
     must launch once per chunk on the lsh and luv runs and lab_n once per
     chunk on the tospace:lab run (and not otherwise), gem_l2n once per
     chunk x scale; the run with the plain lab and CLAHE versions must give
     descriptors within 1e-4 and the same top-10 ranks, and every chain
     bit-equal per chunk; the lsh and luv CLAHE planes of every chunk on
     the card against the same function on the CPU: lsh bit-equal, luv
     within one level at a flip rate of at most 1e-4 (set from the
     readings) and 2 % (the JAX package's runtime-guard bar; the rate is
     printed). Then two host routes on the same 40 images, the transform
     on the host with its device steps on the card: pil2np |
     gamma_equalize:0.5:lab | totensor | normalize and pil2np |
     tospace:lab | apply_clahe:4:lab:8 | totensor | normalize (lab_n once
     an image; the second's clahe_u8 once an image, each plane bit-equal
     to its plain version); the run with the plain versions must give
     bit-equal transformed images, descriptors within 1e-4 and the same
     top-10 ranks. Each run prints its seconds, images/s, peak memory,
     launches and the card's name and power limit.
 14. the rest of the eval stack, in float32, on the same 40 images (scales
     1, 2^-1/2, 1/2, Lw, random weights from the seed): a
     ResNet101-GeM-Rpool (``regional: true``, resnet101-gem-r's layout)
     and a densenet121-GeM and a squeezenet1_1-GeM on the plain route, a
     ResNet101-RMAC on phase 7's lab CLAHE chain. Each net's batched run
     (region boxes per scale for RMAC and Rpool, R rounded up to 8) must
     agree with the exact per-image path at native sizes within 1e-4 with
     the same top-10 ranks; gem_l2n must launch once per chunk x scale on
     the GeM nets and not on the regional heads (plain PyTorch, as the
     JAX package pools regions with XLA), the chain kernels once per chunk
     on the CLAHE run only; the RMAC run's chain must be bit-equal to a
     run on the plain kernels; the Rpool net must agree with the CPU on 4
     small inputs; gem_l2n is held against its plain version (and timed)
     at every map the densenet and squeezenet runs gave it. Then the Rpool
     net under ``auto``: the guard runs once and its verdict is printed (a
     rejection must ship float32). Each run prints images/s, peak memory,
     R per scale, launches and the card's name and power limit.
 15. image-model training, in float32, through the train stage: the
     P2pUNet translator at full width with dropout 0.5 on 16 in-memory
     day/night pairs (``PregeneratedImageTuple``, L1, adam, 4 pairs a
     batch, 2 epochs; ``downscale``, ``scalecrop``, ``mirror`` and
     ``gaussian_noise`` in training, ``downscale``, ``random_crop`` and
     ``center_crop`` in its loss validation on 8 held-out pairs); then the
     joint N/D training of phase 10's P2pUNet and phase 7's VGG16-GeM
     (``embed: null``, contrastive, adam, 5 tuples of 7 square 512 px
     images a step from phase 9's database, 2 steps an epoch, 3 epochs,
     loss validation on a val split each epoch), epoch 3 rerun from epoch
     2's checkpoint files, then two steps with both members trained and
     ``alternate_iteration: 1``. Gates: an epoch's batches bit-identical
     when rerun from its seed; Dropout's mask the same from one generator
     state, eval the identity; one step of each training on the card
     against the CPU at 256 x 256 (loss within 1e-4, the flattened
     gradient at cosine >= 0.9999, the live BatchNorm statistics within
     1e-5); mining's negatives the same with the plain pool; loss
     validation (the composition's through its wrappers, the embedder's as
     one padded bucket a batch) within 1e-4 of its plain run; the
     embedder bit-unchanged; the rerun epoch within 1e-4 of the straight
     run; the alternation moving translate, then embed. gem_l2n must
     launch in mining and loss validation and never in a step (it pools
     under autograd). It prints s/step, mining images/s, loss validation
     s, peak memory, launches and the phase's seconds. Weights are logged
     as histograms (on the card) in phases 9 and 15, as training logs
     them, and image samples written as PNG blobs.
 16. the branched retrieval net (``cirnet_branched``), in float32, on the
     same 40 images (scales 1, 2^-1/2, 1/2, phase 7's Lw): a VGG16-GeM
     whose RGB branch (weight 1) and lab CLAHE lightness branch (weight
     0.5) run conv1_1 and conv1_2 at full resolution and are summed at
     layer 2, behind pil2np | add_clahe_fromrgb:4:8:lab | totensor |
     normalize (a 4-channel mean and std), warmed up with
     ``warmup_extraction`` (one full chunk per bucket) before its timed
     run. Gates: gem_l2n once per chunk x scale and each CLAHE kernel once
     per chunk; the run on every kernel's plain version within 1e-4 with
     the same top-10 ranks; 8 images on the exact per-image path within
     1e-4; gem_l2n at the net's maps within 1e-6 of plain; the concat
     merge at layer 2 and the input-merged net (layer 0) on 8 images at
     one scale against their per-image paths; the net under ``auto`` (the
     guard once; a rejection ships float32); one step (5 tuples at 256)
     card against CPU, and ``auto`` leaving the step float32; one weight
     log through the event broker (a tensor's counts equal to numpy's), a
     PNG sample blob read back equal, the device's memory statistics. It
     prints images/s, peak memory, launches, the weight log's time and the
     phase's seconds.
 17. several cards on ``torch.distributed``, as a world of one on NCCL
     (one process cannot put two ranks on one card, and gloo on CUDA
     tensors lacks reduce-scatter and all-gather): the validate stage's
     ``CirDatasetAp`` with ``parallel: {data: 1}`` on phase 7's net and
     the same 40 images (through its ``loader``), float32: descriptors
     within 1e-6 of phase 7's, the same top-10 ranks and mAP, gem_l2n
     launched 15 times and each chain kernel 5, the chain kernels
     bit-equal and gem_l2n equal to their plain versions at the pass's
     first chunk, images/s beside phase 7's; ``rank_database_sharded``
     equal to ``rank_database`` on those descriptors; a single-card, a
     data-parallel and a ZeRO step from phase 9's epoch-2 weights on its
     first batch (adam, lr 1e-6), cuDNN deterministic: the DP step within
     1e-6 (loss and parameters) of the single-card step, ZeRO within 1e-6
     of DP, and the ZeRO optimizer's gathered state dict equal to the
     single card's (the gap to phase 9's own float32 step is printed:
     cuDNN's backward is not bit-reproducible there); the whole-batch
     route on phase 15's joint N/D net (the P2pUNet at nested 7 with live
     BatchNorm, then the VGG16-GeM, frozen again; adam on the translator
     through the optimizer alternation) and its first batch of
     5 tuples of 7 square 512 px images: a single-card, a DP and a ZeRO
     step, float32, cuDNN deterministic, the losses, translator
     parameters and BatchNorm running statistics 0.0 apart and the
     alternation's gathered state dict bit-equal to the single card's;
     then the DP step through the lab CLAHE chain, each chain kernel
     launched inside it and its bucket's chain bit-equal to plain; and
     ``dryrun_multicard(1, "cuda")``, which shares the group (finite
     losses). It prints launches and the phase's seconds.
Then one JSON line of kernels (gem_l2n, gem_l2n_bf16 timed at the bf16
paths' maps, gem_l2n_f16 at the float16 path's, with its times at the bf16
maps as off-path readings; each redesigned kernel tagged with the PR of
its redesign; launches on the training and composition paths, mining and
train step apart; on phase 12's runs, ``dump_path_launches``; on phase
13's, ``photometric_path_launches``; on phase 14's,
``eval_stack_path_launches``, and gem_l2n's times at the densenet and
squeezenet maps, ``eval_stack_path``; on phase 15's,
``image_train_path_launches``; on phase 16's timed run,
``branched_path_launches``, and gem_l2n's times at its maps,
``branched_path``; on phase 17's score pass and steps,
``parallel_path_launches``), the
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
TRAIN_CACHE_MB = 512  # phase 9's device image cache (about 129 MB of it used)
LOSS_RTOL, GRAD_MIN_COSINE = 1e-4, 0.9999  # that step's tolerances
CLAHE_DIM = 512
CLAHE_TRANSFORM = "pil2np | apply_clahe:4:lab:8 | totensor | normalize"
PLAIN_TRANSFORM = "pil2np | totensor | normalize"
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
# timed infer and translation passes after a warm one: one, so that the
# whole script stays within 300 s cold
DUMP_REPEATS = 1
F32_EPS = 2.0 ** -24  # float32 unit roundoff
TF32_EPS = 2.0 ** -11  # TF32's (10 stored mantissa bits)
ROUNDING_LAMBDA = 1.0  # the statistical rounding bound's lambda
LAB_OPS_PER_PIXEL = 60
INTERP_OPS_PER_PIXEL = 22
LUT_OPS_PER_BIN = 10
# phase 13: the luv CLAHE plane, card against CPU: at most one level, at
# the JAX package's runtime-guard rate (its preprocess.py:161) and at a bar
# set from the readings (2.7e-6 of the pixels on an H100 on the smoke's
# images)
LUV_FLIP_RATE = 0.02
LUV_FLIP_READ = 1e-4
# phase 15: image-model training, float32. The translator alone: L1 on 16
# in-memory day/night pairs (a smooth colour field by day, darkened and
# tinted by night), validated on 8 held-out pairs; all six augmentations
# run between the two pipelines. Then the joint N/D training of phase 10's
# P2pUNet and phase 7's VGG16-GeM on phase 9's database cut to square
# 512 px images (its val split: 5 further pairs over the same pool)
PAIR_IMAGES = {}  # name -> (H, W, 3) uint8, served by pairs_loader
PAIR_SHAPE = (384, 512)
PAIR_TRAIN, PAIR_HELD_OUT, PAIR_BATCH, PAIR_EPOCHS = 16, 8, 4, 2
PAIR_TRANSFORM = ("pil2np | downscale:362 | scalecrop:256_256:0.75_1 | "
                  "mirror | gaussian_noise:0.02 | totensor | normalize")
PAIR_VAL_TRANSFORM = ("pil2np | downscale:288 | random_crop:272 | "
                      "center_crop:256 | totensor | normalize")
TRANSLATOR_MODEL = dict(UNET_MODEL, dropout=0.5)
JOINT_IMAGES = {}  # name -> (512, 512, 3) uint8, served by joint_loader
JOINT_SIDE, JOINT_EPOCHS = 512, 3  # epoch 3 is rerun from epoch 2's files
JOINT_VAL_PAIRS, JOINT_VAL_POOL = 5, 20
CHECK_SIDE = 256  # the card-against-CPU steps (the P2pUNet's 2^8)
BN_RTOL = BN_ATOL = 1e-5  # BatchNorm statistics, card against CPU
# each gradient tensor's floor beside the flattened gradient's
# GRAD_MIN_COSINE: about 10x under the least a tensor read in sound runs
# (0.99987, a BatchNorm bias over the innermost levels' 1 x 1 cells)
GRAD_MIN_TENSOR_COSINE = 0.999
GEM_DTYPES = {torch.float32: "gem_l2n", torch.bfloat16: "gem_l2n_bf16",
              torch.float16: "gem_l2n_f16"}  # instantiation per map dtype
# phase 16: the branched VGG16-GeM (the paper's RGB plus equalized
# lightness input): the RGB and CLAHE branches run conv1_1 and conv1_2,
# summed before the shared rest of the trunk; the transform appends the
# lab CLAHE lightness as a fourth channel, normalised with it
BRANCHES = {"0_rgb": {"in": 3, "init": "clone", "weight": 1.0},
            "1_clahe": {"in": 1, "init": "sum", "weight": 0.5}}
BRANCHED_MODEL = {"architecture": "cirnet_branched",
                  "cir_architecture": "vgg16", "pooling": "gem",
                  "whitening": False, "pretrained": False,
                  "channels": {"merge": {"layer": 2, "aggregation": "sum"},
                               "branches": BRANCHES}}
BRANCHED_TRANSFORM = "pil2np | add_clahe_fromrgb:4:8:lab | totensor | " \
    "normalize"
BRANCHED_MEAN_STD = ([0.485, 0.456, 0.406, 0.5], [0.229, 0.224, 0.225, 0.25])
BRANCHED_EXACT = 8  # images held against the exact per-image path
PARALLEL_IMAGES = {}  # name -> (H, W, 3) uint8, served by parallel_loader

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


def recording_chain(chain_fn, sink):
    """``chain_fn`` (an extractor's device chain) that also copies each
    chunk's input, the uint8 bucket and its CLAHE aux, into ``sink``."""
    def fn(batch, aux):
        sink.append((batch.clone(), {k: v.clone() for k, v in aux.items()}))
        return chain_fn(batch, aux)
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


def train_images():
    """Phase 9's images, made once (phase 15 crops them)."""
    if not TRAIN_IMAGES:
        make_train_images(np.random.RandomState(SEED))
    return TRAIN_IMAGES


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
                        "pool_size": TRAIN_POOL_SIZE, "loader": smoke_loader,
                        "device_cache_mb": TRAIN_CACHE_MB},
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
    from mdir_tpu_torch.learning.train_step import TrainStep, pad_image_batch
    from mdir_tpu_torch.ops.clahe import aux_to_device, clahe_bucket_aux
    from mdir_tpu_torch.ops.pooling import gem_l2n_plain
    from mdir_tpu_torch.ops.preprocess import make_bucketed_chain
    from mdir_tpu_torch.parallel.device_cache import (CachedImageRef,
                                                      assemble, shared_cache)
    from mdir_tpu_torch.stages.train import train

    root = os.path.join(_build.BUILD_ROOT, "smoke", "train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    db_pkl = os.path.join(root, "db.pkl")
    names = sorted(train_images())
    with open(db_pkl, "wb") as handle:
        pickle.dump({"train": {
            "cids": ["/smoke/%s" % name for name in names],
            "cluster": [i // 2 for i in range(len(names))],
            "qidxs": [2 * k for k in range(TRAIN_PAIRS)],
            "pidxs": [2 * k + 1 for k in range(TRAIN_PAIRS)]}}, handle)
    exp = os.path.join(root, "exp")

    minings, steps, chain_inputs, gem_in, saved = [], [], [], [], {}
    cache_stats = lambda: shared_cache(device, TRAIN_CACHE_MB).stats()
    counts = functools.partial(kernel_counts, clahe, lab_trilinear,
                               pooling_kernel)
    mine, step, chain, save = (TuplesDataset.create_epoch_tuples,
                               SupervisedEpoch._optimization_step,
                               TrainStep.chain, Checkpoints.save_epoch)

    def timed_mine(dataset, network):
        record = {"dataset": dataset, "rng": np.random.get_state(),
                  "weights": {k: v.clone() for k, v
                              in network.model.state_dict().items()},
                  "before": counts(), "cache_before": cache_stats()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = mine(dataset, network)
        torch.cuda.synchronize()
        record.update(seconds=time.perf_counter() - t, after=counts(),
                      cache_after=cache_stats(),
                      mined=dict(dataset.mined),
                      nidxs=[list(n) for n in dataset.nidxs])
        minings.append(record)
        return stats

    def timed_step(epoch, network, optimizer, images, targets):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = step(epoch, network, optimizer, images, targets)
        torch.cuda.synchronize()
        steps.append((epoch.epoch, time.perf_counter() - t, len(images),
                      sum(isinstance(img, CachedImageRef)
                          for tpl in images for img in tpl),
                      sum(len(tpl) for tpl in images)))
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
        step_s = [s for e, s, *_ in steps if e == epoch]
        tuples = sum(n for e, _, n, *_ in steps if e == epoch)
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

    dataset = minings[-1]["dataset"]
    # the device image cache: epoch 2's mining hit it and its cached chunks
    # launched the four kernels; the steps took cached items, and one
    # tuple's bucket assembled from the cache is the host-padded one
    second = minings[1]
    cached = {k: second["cache_after"][k] - second["cache_before"][k]
              for k in ("hits", "misses", "entries")}
    check(cached["hits"] > 0, ("epoch-2 mining hits the cache", cached))
    cached_launches = {name: second["after"][name] - second["before"][name]
                       for name in total}
    check(all(n > 0 for n in cached_launches.values()),
          ("kernels on the cached chunks", cached_launches))
    step_refs = sum(r for *_, r, _ in steps)
    check(step_refs > 0, "the steps took cached items")
    refs, _ = dataset[0]
    pixels, _ = pixel_items(dataset, [0])[0]
    bucket, valid, _ = assemble(refs, 32)
    host, host_valid = pad_image_batch(pixels, 32)
    check(any(isinstance(img, CachedImageRef) for img in refs)
          and torch.equal(bucket.cpu(), torch.from_numpy(host))
          and np.array_equal(valid, host_valid),
          ("hand-off bucket vs pad_image_batch", tuple(host.shape)))
    say("train", "device image cache %s; epoch-2 mining %s, launches on its "
        "cached chunks %s; the steps took %d of %d images from the cache; "
        "tuple 0's hand-off bucket %s (%d of %d images cached) bit-equal to "
        "pad_image_batch"
        % (cache_stats(), cached, cached_launches, step_refs,
           sum(n for *_, n in steps), tuple(host.shape),
           sum(isinstance(img, CachedImageRef) for img in refs), len(refs)))

    def gates():
        """Gates 1, 2 and 4 (none timed), on the card beside the CPU's
        step of gate 3."""
        # 1. the step's chain on every tuple bucket against the plain kernels
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
            clahe_against_plain(clahe, lab_trilinear.lab_l_u8(batch), aux,
                                grid,
                                ("train", tuple(batch.shape)))
        say("train", "train-step chain and its three kernels bit-equal to "
            "plain on all %d tuple buckets %s"
            % (len(chain_inputs),
               sorted({tuple(b.shape) for b, _ in chain_inputs})))
        gem_err = gem_train_inputs(pooling_kernel, gem_l2n_plain, gem_in,
                                   device)

        # 2. mining with the kernels against the plain versions, per epoch:
        # descriptors within DESC_ATOL and the same negatives in every epoch.
        # Seeded weights collapse the descriptors (every query-pool score near
        # 1; the span is printed), so the smallest score gap the picks relied
        # on is printed beside the descriptor tolerance: under it, the same
        # negatives are not implied by the tolerance (an open item until
        # published weights are in the repository)
        net = initialize_network(None, device, dict(saved[TRAIN_EPOCHS - 1]))
        # epoch 2's cached mining against one uncached re-extraction
        net.model.load_state_dict(second["weights"])
        np.random.set_state(second["rng"])
        with mock.patch.object(second["dataset"], "device_cache_mb", 0), \
                contextlib.redirect_stdout(io.StringIO()):
            mine(second["dataset"], net)
        for key in ("qvecs", "poolvecs"):
            check(np.array_equal(second["dataset"].mined[key],
                                 second["mined"][key]),
                  ("epoch-2 cached mining vs uncached", key))
        say("train", "epoch-2 mining through the cache: query and pool "
            "descriptors bit-equal to an uncached re-extraction")
        desc_err = score_err = 0.0
        gaps = []
        for epoch, record in enumerate(minings):
            net.model.load_state_dict(record["weights"])
            np.random.set_state(record["rng"])
            with plain_clahe_kernels(clahe, lab_trilinear), \
                    mock.patch.object(pooling_kernel, "gem_l2n",
                                      gem_l2n_plain), \
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
        scores = np.concatenate([r["mined"]["scores"].ravel()
                                 for r in minings])
        say("train", "mining, kernels against plain: max |desc diff| %.2e, "
            "max |score diff| %.2e; the same negatives for all %d queries "
            "in %d epochs; query-pool scores span [%.4f, %.4f]; smallest "
            "score gap the picks relied on %s (descriptor tolerance %g%s)"
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
        return gem_err

    # 3. one step on the card against the CPU at a reduced size
    gem_err = card_cpu_step(device, dataset, saved[TRAIN_EPOCHS - 1],
                            meanwhile=gates)
    # 6. two steps under auto (bf16 trunk, the guard) beside float32
    bf16 = bf16_train_steps(device, dataset, saved[TRAIN_EPOCHS - 1])
    shutil.rmtree(root, ignore_errors=True)
    # later phases' peak memory without phase 9's cached images
    shared_cache(device, TRAIN_CACHE_MB).clear()
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

    # the plain pool's run, which also records the pool's inputs and warms
    # cuDNN and the allocator for the timed run
    gem_in = []
    with mock.patch.object(pooling_kernel, "gem_l2n",
                           recording_pool(gem_l2n_plain, gem_in)):
        pout, _ = run_path((db, queries))
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


def cut_to_side(img, side=TRAIN_CHECK_SIDE):
    """An image's top-left crop scaled to a longer side of ``side``."""
    scale = side / max(img.shape[:2])
    return img[:max(1, int(img.shape[0] * scale)),
               :max(1, int(img.shape[1] * scale))]


def card_cpu_step(device, dataset, state, meanwhile):
    """One batch's step from the same weights on the card and on the CPU,
    every image cut to a longer side of TRAIN_CHECK_SIDE, ``meanwhile()``
    on the card beside the CPU's; returns what it returned."""
    from mdir_tpu_torch.learning.network import initialize_network

    items = pixel_items(dataset, range(TRAIN_BATCH))
    _, also = card_cpu_tuple_step(
        "train", device, lambda where: initialize_network(None, where, state),
        [[cut_to_side(img) for img in tpl] for tpl, _ in items],
        [target for _, target in items], dataset.device_chain, meanwhile)
    return also


def pixel_items(dataset, indices):
    """The dataset's tuples as loaded pixels, its device cache off."""
    with mock.patch.object(dataset, "device_cache", None):
        return [dataset[i] for i in indices]


def tuple_step(where, make_network, images, targets, chain):
    """One contrastive step of ``make_network(where)`` on the tuples:
    (loss, {name: gradient on the CPU in float64}, seconds)."""
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.optim.criteria import initialize_criterion

    net = make_network(where).train()
    step = TrainStep(net, initialize_criterion(
        {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}),
        device_chain=chain)
    t = time.perf_counter()
    loss, _ = step.gradients(images, targets)
    loss = float(loss)
    return loss, {name: p.grad.detach().cpu().double()
                  for name, p in net.model.named_parameters()}, \
        time.perf_counter() - t


def card_cpu_tuple_step(phase, device, make_network, images, targets,
                        chain, meanwhile):
    """One contrastive step of ``make_network(where)`` on the tuples, on
    the card and on the CPU: the loss within LOSS_RTOL, every gradient
    tensor at cosine >= GRAD_MIN_COSINE. The CPU's step runs on a second
    thread while the card runs its own and then ``meanwhile()`` (card work
    with gates of its own, none of it timed), so that its seconds hide
    behind the card's. Returns ((loss gap, least cosine, the card's step
    seconds), what ``meanwhile`` returned)."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_cpu = pool.submit(tuple_step, torch.device("cpu"), make_network,
                             images, targets, chain)
        card_loss, card, card_s = tuple_step(device, make_network, images,
                                             targets, chain)
        also = meanwhile()
        cpu_loss, cpu, cpu_s = on_cpu.result()
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    cosines = {name: float((card[name] * cpu[name]).sum()
                           / (card[name].norm() * cpu[name].norm()))
               for name in cpu}
    worst = min(cosines, key=cosines.get)
    say(phase, "one step at longer side %d (%d tuples), card against CPU: "
        "loss %.6f vs %.6f (rel %.2e), least gradient cosine %.7f (%s); "
        "%.2f s on the card, %.2f s on the CPU"
        % (TRAIN_CHECK_SIDE, len(images), card_loss, cpu_loss, rel,
           cosines[worst], worst, card_s, cpu_s))
    check(rel <= LOSS_RTOL, (phase, "card step loss vs CPU", card_loss,
                             cpu_loss))
    check(cosines[worst] >= GRAD_MIN_COSINE,
          (phase, "card step gradient vs CPU", worst, cosines[worst]))
    return (rel, cosines[worst], card_s), also


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
        items = pixel_items(dataset, range(b * TRAIN_BATCH,
                                           (b + 1) * TRAIN_BATCH))
        batches.append(([tpl for tpl, _ in items], [t for _, t in items]))
    runs = {}
    first = {}  # the float32 first step, phase 17's single-card reference
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
            if mode == "float32" and not first:
                first.update(
                    images=images, targets=targets, loss=losses[0],
                    chain=dataset.device_chain, state=state,
                    params={k: p.detach().clone() for k, p
                            in net.model.named_parameters()})
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
            "f32_peak": f32_peaks[1], "first_step": first}


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
    # (each batch drained as soon as it is queued): one warm pass, in flight
    passes = {2: [], 0: []}  # depth -> [(wall s, forwards' device ms)]
    for run in range(DUMP_REPEATS + 1):
        for depth in passes if run else (2,):
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
            "passes after a warm one in flight: %s s, %s images/s; the "
            "forwards' "
            "device time (CUDA events) %s ms, %s of the pass"
            % (len(arrays), IMAGE_SIZE, UNET_DIVISOR, batches, depth,
               DUMP_REPEATS,
               ["%.3f" % wall for wall, _ in timed[-DUMP_REPEATS:]],
               ["%.1f" % (len(arrays) / wall)
                for wall, _ in timed[-DUMP_REPEATS:]],
               ["%.1f" % busy for _, busy in timed[-DUMP_REPEATS:]],
               ["%.1f%%" % (busy / 10.0 / wall)
                for wall, busy in timed[-DUMP_REPEATS:]]))
    say("dump", "translation against the per-image path: max |diff| %d "
        "level, %.4f%% of values differ; phase peak %.2f GB"
        % (worst, 100.0 * differ / total, peak / 1e9))
    return launches


def photometric_phase(device, db, queries, path, clahe, lab_trilinear,
                      pooling_kernel, smi):
    """Phase 13: the rest of the photometric chain -- lsh and luv CLAHE and
    ``tospace:lab`` as device chains on phase 7's VGG16-GeM, and two host
    routes (``gamma_equalize``; ``tospace`` before CLAHE). Returns each
    kernel's launches on each run."""
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.ops import preprocess
    from mdir_tpu_torch.ops.ranking import rank_database
    from mdir_tpu_torch.parallel.extract import network_extractor

    network = path["network"]
    mean_std = (network.model.meta["mean"], network.model.meta["std"])
    launches = {}

    def ranks_of(out):
        vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for v in out)
        return rank_database(vecs, qvecs).cpu().numpy()

    def run(transform, image_sets, sink=None):
        """Descriptors of the image sets; ``sink`` gets each chunk's chain
        (input bucket, output) or, on the host route, each image's
        transform."""
        out, chunks = [], 0
        for images in image_sets:
            extractor = network_extractor(network, transform)
            if sink is not None and extractor.chain_fn is not None:
                chain_fn = extractor.chain_fn

                def recorded(batch, aux, chain_fn=chain_fn):
                    result = chain_fn(batch, aux)
                    sink.append((batch.clone(), result.clone()))
                    return result
                extractor.chain_fn = recorded
            host = extractor.host_dtype != np.uint8
            for i, img in enumerate(images):
                x = transform(img) if host else img
                if host and sink is not None:
                    sink.append(np.asarray(x))
                extractor.add(i, x)
            out.append(extractor.finish(len(images)))
            chunks += extractor.chunks
        return out, chunks

    def timed(tag, transform, image_sets, sink=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for module in (pooling_kernel, lab_trilinear, clahe):
            module.reset_launches()
        t = time.perf_counter()
        out, chunks = run(transform, image_sets, sink)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches[tag] = kernel_counts(clahe, lab_trilinear, pooling_kernel)
        n = sum(len(images) for images in image_sets)
        for v in out:
            check(v.shape[0] == CLAHE_DIM and np.isfinite(v).all(),
                  (tag, "finite descriptors"))
            norms = np.linalg.norm(v, axis=0)
            check(np.abs(norms - 1).max() < 1e-4, (tag, "unit norms"))
        say("photo", "%s: %d images in %d chunks, %.2f s, %.1f images/s, "
            "peak %.2f GB; launches %s | %s"
            % (tag, n, chunks, seconds, n / seconds,
               torch.cuda.max_memory_allocated() / 1e9, launches[tag], smi))
        return out, chunks

    # the device chains: CLAHE in lsh and luv, tospace:lab
    for space in ("lsh", "luv", "tospace:lab"):
        dsl = "pil2np | tospace:lab | totensor | normalize" \
            if space == "tospace:lab" \
            else "pil2np | apply_clahe:4:%s:8 | totensor | normalize" % space
        transform = initialize_transforms(dsl, mean_std)
        check(preprocess.chain_from_transform(transform) is not None,
              (dsl, "lowers to the device chain"))
        if space == "lsh":  # one warm pass (phase 7's net and shapes)
            run(transform, (db, queries))
        chains = []
        out, chunks = timed(space, transform, (db, queries), chains)
        counted = launches[space]
        clahe_runs = 0 if space == "tospace:lab" else chunks
        check(counted["clahe_tile_luts"] == counted["clahe_interp"]
              == clahe_runs, (dsl, "CLAHE launches", counted, chunks))
        check(counted["lab_n"] == (chunks if space == "tospace:lab" else 0),
              (dsl, "lab_n launches", counted, chunks))
        check(counted["gem_l2n"] == chunks * len(SCALES) > 0,
              (dsl, "gem_l2n launches", counted, chunks))
        plain_chains = []
        with plain_clahe_kernels(clahe, lab_trilinear):
            pout, _ = run(transform, (db, queries), plain_chains)
        check(len(plain_chains) == len(chains) == chunks, "chunks recorded")
        chain_diff = max(float((a[1] - b[1]).abs().max())
                         for a, b in zip(chains, plain_chains))
        check(chain_diff == 0.0, (dsl, "chain vs plain", chain_diff))
        desc_err = max(np.abs(a - b).max() for a, b in zip(out, pout))
        check(desc_err <= DESC_ATOL, (dsl, "descriptors vs plain",
                                      desc_err))
        check((ranks_of(out)[:10] == ranks_of(pout)[:10]).all(),
              (dsl, "top-10 ranks vs plain"))
        say("photo", "%s (%s) against the plain kernels on the card: chain "
            "max |diff| %.2e, descriptors %.2e, top-10 ranks equal"
            % (space, dsl, chain_diff, desc_err))
        if space in ("lsh", "luv"):
            # the card's plane against the same function on the CPU (the
            # luv plane's bar is the JAX package's runtime guard's)
            worst, flips, total = 0, 0, 0
            for batch, _ in chains:
                card = preprocess.clahe_plane(batch, space).cpu()
                cpu = preprocess.clahe_plane(batch.cpu(), space)
                diff = (card - cpu).abs()
                worst = max(worst, int(diff.max()))
                flips += int((diff != 0).sum())
                total += diff.numel()
            rate = flips / total
            if space == "lsh":
                check(flips == 0, ("lsh plane, card vs CPU", flips))
            check(worst <= 1 and rate <= LUV_FLIP_RATE
                  and rate <= LUV_FLIP_READ,
                  (space, "plane, card vs CPU", worst, rate))
            say("photo", "%s CLAHE plane, card against CPU on %d pixels: "
                "max |diff| %d level, flip rate %.3e (bars %.0e, the JAX "
                "guard's %.0e)" % (space, total, worst, rate, LUV_FLIP_READ,
                                   LUV_FLIP_RATE))

    # two host routes on the device chains' images: lab_n and clahe_u8
    # (both CLAHE kernels at batch 1) run on the card image by image; each
    # route is held against a second run on the plain versions
    planes = []
    real_clahe_u8 = clahe.clahe_u8

    def recording_clahe_u8(src, clip_limit=4.0, grid=(8, 8)):
        planes.append((src.clone(), clip_limit, grid))
        return real_clahe_u8(src, clip_limit, grid)

    n = len(db) + len(queries)
    for tag, dsl in (
            ("host gamma_equalize",
             "pil2np | gamma_equalize:0.5:lab | totensor | normalize"),
            ("host tospace, apply_clahe",
             "pil2np | tospace:lab | apply_clahe:4:lab:8 | totensor | "
             "normalize")):
        transform = initialize_transforms(dsl, mean_std)
        check(preprocess.chain_from_transform(transform) is None,
              (dsl, "stays on the host"))
        run(transform, (queries[:2],))  # warm-up
        del planes[:]
        images = []
        with mock.patch.object(clahe, "clahe_u8", recording_clahe_u8):
            out, _ = timed(tag, transform, (db, queries), images)
        counted = launches[tag]
        clahe_runs = n if "apply_clahe" in dsl else 0
        check(len(planes) == counted["clahe_tile_luts"]
              == counted["clahe_interp"] == clahe_runs,
              (dsl, "clahe_u8 calls", len(planes), counted))
        check(counted["lab_n"] == n, (dsl, "lab_n", counted))
        for src, clip_limit, grid in planes:
            got = real_clahe_u8(src, clip_limit, grid)
            with plain_clahe_kernels(clahe, lab_trilinear):
                check_equal(got, real_clahe_u8(src, clip_limit, grid),
                            (dsl, "clahe_u8 vs plain", tuple(src.shape)))
        plain_images = []
        with plain_clahe_kernels(clahe, lab_trilinear):
            pout, _ = run(transform, (db, queries), plain_images)
        check(len(images) == len(plain_images) == n, "images recorded")
        image_diff = max(float(np.abs(a - b).max())
                         for a, b in zip(images, plain_images))
        check(image_diff == 0.0, (dsl, "transform vs plain", image_diff))
        desc_err = max(np.abs(a - b).max() for a, b in zip(out, pout))
        check(desc_err <= DESC_ATOL, (dsl, "descriptors vs plain",
                                      desc_err))
        check((ranks_of(out)[:10] == ranks_of(pout)[:10]).all(),
              (dsl, "top-10 ranks vs plain"))
        say("photo", "%s (%s) against the plain kernels on the card: "
            "transformed images max |diff| %.2e, descriptors %.2e, top-10 "
            "ranks equal; clahe_u8 bit-equal to its plain version on all "
            "%d planes" % (tag, dsl, image_diff, desc_err, len(planes)))
    return launches


def eval_stack_phase(device, db, queries, gnd, whiten_paths, clahe,
                     lab_trilinear, pooling_kernel, gem_l2n_plain, gen, smi):
    """Phase 14: the rest of the eval stack, in float32, on the 40 images
    (scales 1, 2^-1/2, 1/2, Lw): a ResNet101-GeM-Rpool on the plain route,
    a ResNet101-RMAC on phase 7's lab CLAHE chain, a densenet121-GeM and a
    squeezenet1_1-GeM on the plain route; then the Rpool net under
    ``auto``. Returns each kernel's launches on each net's batched run and
    gem_l2n's checks and times at the densenet and squeezenet maps."""
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.ops import dtypes as dtype_policy
    from mdir_tpu_torch.ops.ranking import compute_map, rank_database
    from mdir_tpu_torch.parallel import extract

    t_phase = time.perf_counter()
    n_images = len(db) + len(queries)
    launches, pools, readings = {}, {}, {}

    def make_net(arch, pooling, regional, where=device):
        params = dict(MODEL, cir_architecture=arch, pooling=pooling,
                      regional=regional)
        model = initialize_model(params, device=where, seed=SEED)
        return CirNetwork(model, CirNetwork.NetworkParams(
            model=params, runtime={
                "wrappers": {"train": None, "eval": {
                    "0_cirwhiten": {"whitening":
                                    whiten_paths[model.meta["outputdim"]],
                                    "dimensions": None},
                    "1_cirmultiscale": {"scales": SCALES}}},
                **FLOAT32_RUNTIME}), frozen=True)

    def ranks_of(out):
        vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for v in out)
        return rank_database(vecs, qvecs).cpu().numpy()

    def batched(network, transform, image_sets, chains=None, boxes=None):
        """Descriptors of the image sets through the batched extractor;
        ``chains`` gets each chunk's chain output, ``boxes`` each chunk's
        R per scale."""
        out, chunks = [], 0
        for images in image_sets:
            extractor = extract.network_extractor(network, transform)
            if chains is not None and extractor.chain_fn is not None:
                chain_fn = extractor.chain_fn

                def recorded(batch, aux, chain_fn=chain_fn):
                    result = chain_fn(batch, aux)
                    chains.append(result.clone())
                    return result
                extractor.chain_fn = recorded
            if boxes is not None:
                region_boxes = extractor.region_boxes

                def counted(*args, region_boxes=region_boxes):
                    result = region_boxes(*args)
                    boxes.append([b.shape[1] for b in result])
                    return result
                extractor.region_boxes = counted
            for i, img in enumerate(images):
                extractor.add(i, img)
            out.append(extractor.finish(len(images)))
            chunks += extractor.chunks
        return out, chunks

    def run_net(tag, network, transform, label, chain=False):
        """A warm-up, the timed batched run (its launches counted from 0),
        the exact per-image path, and the gates they share."""
        dim = network.model.meta["outputdim"]
        gem_in, boxes = [], []
        with mock.patch.object(pooling_kernel, "gem_l2n", recording_pool(
                pooling_kernel.gem_l2n, gem_in)):
            batched(network, transform, (db, queries), boxes=boxes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for module in (pooling_kernel, lab_trilinear, clahe):
            module.reset_launches()
        chains = [] if chain else None
        t = time.perf_counter()
        out, chunks = batched(network, transform, (db, queries), chains)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches[tag] = kernel_counts(clahe, lab_trilinear, pooling_kernel)
        peak = torch.cuda.max_memory_allocated()
        ranks = ranks_of(out)
        for v in out:
            check(v.shape[0] == dim and np.isfinite(v).all(),
                  (tag, "finite descriptors"))
            norms = np.linalg.norm(v, axis=0)
            check(np.abs(norms - 1).max() < 1e-4, (tag, "unit norms"))
        regional = network.model.needs_region_boxes
        counted = launches[tag]
        check(counted["gem_l2n"] == (0 if regional
                                     else chunks * len(SCALES)),
              (tag, "gem_l2n launches", counted, chunks))
        for name in ("lab_n", "clahe_tile_luts", "clahe_interp"):
            check(counted[name] == (chunks if chain else 0),
                  (tag, "%s launches" % name, counted, chunks))
        r_per_scale = [sorted({r[s] for r in boxes})
                       for s in range(len(SCALES))] if regional else None
        if regional:
            check(len(boxes) == chunks and all(
                r % 8 == 0 for rs in r_per_scale for r in rs),
                (tag, "region boxes per chunk", boxes))
        mean_ap = compute_map(ranks, gnd)[0]
        say("stack", "%s %d-d, %s, scales %s, Lw: %d images in %d chunks, "
            "%.2f s, %.1f images/s, peak %.2f GB; R per scale %s; launches "
            "%s; mAP %.4f | %s"
            % (tag, dim, label, [round(x, 4) for x in SCALES], n_images,
               chunks, seconds, n_images / seconds, peak / 1e9, r_per_scale,
               counted, mean_ap, smi))
        # the exact per-image path at native sizes
        t = time.perf_counter()
        exact = [extract.extract_vectors_per_image(network, images, None,
                                                   transform)
                 for images in (db, queries)]
        exact_s = time.perf_counter() - t
        err = max(float(np.abs(a - b).max()) for a, b in zip(out, exact))
        check(err <= DESC_ATOL, (tag, "batched vs per-image", err))
        check((ranks[:10] == ranks_of(exact)[:10]).all(),
              (tag, "top-10 ranks vs per-image"))
        say("stack", "%s: the per-image path at native sizes (%.2f s): max "
            "|desc diff| %.2e, top-10 ranks equal" % (tag, exact_s, err))
        readings[tag] = {"images_per_s": n_images / seconds,
                         "peak_gb": peak / 1e9, "r_per_scale": r_per_scale,
                         "chunks": chunks, "per_image_err": err}
        return out, chains, gem_in

    mean_std = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    plain = initialize_transforms(PLAIN_TRANSFORM, mean_std)
    clahe_transform = initialize_transforms(CLAHE_TRANSFORM, mean_std)

    # a. ResNet101-GeM-Rpool (resnet101-gem-r's layout) on the plain route
    rpool = make_net("resnet101", "gem", True)
    rpool_out, _, _ = run_net("ResNet101-GeM-Rpool", rpool, plain,
                              PLAIN_TRANSFORM)
    small = [db[0][:256, :192], queries[4][:192, :256], db[-1][:200, :240],
             queries[0][:224, :224]]
    card, cpu = (batched(net, plain, (small,))[0][0] for net in (
        rpool, make_net("resnet101", "gem", True, where="cpu")))
    cross_err = float(np.abs(card - cpu).max())
    check(cross_err <= DESC_ATOL, ("Rpool, card vs CPU", cross_err))
    say("stack", "ResNet101-GeM-Rpool, 4 small inputs, card against CPU: "
        "max |desc diff| %.2e" % cross_err)

    # b. ResNet101-RMAC on the lab CLAHE chain, its chain against plain
    rmac = make_net("resnet101", "rmac", False)
    out, chains, _ = run_net("ResNet101-RMAC lab CLAHE", rmac,
                             clahe_transform, CLAHE_TRANSFORM, chain=True)
    plain_chains = []
    with plain_clahe_kernels(clahe, lab_trilinear):
        pout, _ = batched(rmac, clahe_transform, (db, queries), plain_chains)
    check(len(chains) == len(plain_chains) > 0, "chunks recorded")
    for i, (a, b) in enumerate(zip(chains, plain_chains)):
        check(torch.equal(a, b), ("RMAC chain of chunk %d vs plain" % i,
                                  float((a - b).abs().max())))
    desc_err = max(float(np.abs(a - b).max()) for a, b in zip(out, pout))
    check(desc_err <= DESC_ATOL, ("RMAC descriptors vs plain", desc_err))
    say("stack", "ResNet101-RMAC: the chain bit-equal to the plain kernels "
        "in all %d chunks, descriptors %.2e apart" % (len(chains), desc_err))

    # c. densenet121-GeM and squeezenet1_1-GeM: gem_l2n at their maps
    for arch in ("densenet121", "squeezenet1_1"):
        tag = arch + "-GeM"
        _, _, gem_in = run_net(tag, make_net(arch, "gem", False), plain,
                               PLAIN_TRANSFORM)
        pools[tag] = gem_path_phase(tag, pooling_kernel, gem_l2n_plain,
                                    gem_in, gen, device)

    # the Rpool net under auto: the guard's verdict (a reading)
    auto = with_compute_dtype(rpool, "auto")
    torch.cuda.synchronize()
    t = time.perf_counter()
    reports, outs = [], []
    for images in (db, queries):
        extractor = extract.network_extractor(auto, plain)
        for i, img in enumerate(images):
            extractor.add(i, img)
        outs.append(extractor.finish(len(images)))
        reports.append(extractor.guard_report)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    guard = reports[0]
    check(guard is not None and reports[1] is None,
          ("auto: the guard runs once, on the first chunk", reports))
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs, rpool_out))
    if not guard["ok"]:
        check(err <= DESC_ATOL, ("guard rejected: float32 shipped", err))
    readings["ResNet101-GeM-Rpool auto"] = dict(guard, images_per_s=(
        n_images / seconds), max_err_vs_float32=err)
    say("stack", "ResNet101-GeM-Rpool, auto: the guard on the first chunk "
        "%s (least row cosine %.6f, bar %g); %.1f images/s with the guard; "
        "max |desc - float32| %.2e | %s"
        % ("accepted bfloat16" if guard["ok"]
           else "rejected it: float32 from there on", guard["min_cosine"],
           dtype_policy.GUARD_MIN_COSINE, n_images / seconds, err, smi))
    say("stack", "phase 14: %.1f s | %s" % (time.perf_counter() - t_phase,
                                            smi))
    return {"launches": launches, "pools": pools, "readings": readings}


def pairs_loader(path):
    """The translator's pairs: in-memory uint8 images."""
    return PAIR_IMAGES[os.path.basename(path)]


def joint_loader(path):
    """The joint training's database: in-memory uint8 images."""
    return JOINT_IMAGES[os.path.basename(path)]


def make_pairs(rng, count):
    """``count`` day/night pairs into PAIR_IMAGES as dayNN and nightNN: a
    smooth colour field with noise, and the same darkened (gamma 2.2, x0.5)
    and tinted toward blue with its own noise."""
    import torch.nn.functional as F

    h, w = PAIR_SHAPE
    for k in range(count):
        field = F.interpolate(
            torch.from_numpy(rng.rand(1, 3, 5, 7).astype(np.float32)),
            size=(h, w), mode="bilinear",
            align_corners=False)[0].numpy().transpose(1, 2, 0)
        day = np.clip(field * 255 + rng.randn(h, w, 3) * 6, 0, 255)
        night = (day / 255) ** 2.2 * np.array([0.35, 0.4, 0.6]) * 255 \
            + rng.randn(h, w, 3) * 4
        PAIR_IMAGES["day%02d" % k] = day.astype(np.uint8)
        PAIR_IMAGES["night%02d" % k] = np.clip(night, 0, 255).astype(np.uint8)


def write_pairs(path, ks):
    with open(path, "w") as handle:
        handle.write("pair\n")
        for k in ks:
            handle.write(json.dumps(["day%02d" % k, "night%02d" % k]) + "\n")


def pairs_data(tsv, transforms):
    """A PregeneratedImageTuple section: input the night shot, target the
    day shot."""
    return {"mean_std": UNET_DATA["mean_std"], "transforms": transforms,
            "dataset": {"name": "PregeneratedImageTuple", "dataset": tsv,
                        "data_key": "pair", "image_dir": "/pairs",
                        "idx": "1_0", "loader": pairs_loader},
            "loader": {"batch_size": PAIR_BATCH}}


def learning_section(directory, epochs, criterion, optimizer, scheduler,
                     batch_average, every=0):
    """A TrainValLearning section validating on ``data: val``; with
    ``every`` 1 every epoch's files are written and stay, with 0 the last
    epoch's only."""
    return {
        "type": "TrainValLearning",
        "checkpoints": {"directory": directory, "store_every": every,
                        "checkpoint_every": every},
        "training": {
            "type": "EpochTraining", "epochs": epochs, "deterministic": True,
            "seed": SEED, "criterion": criterion, "optimizer": optimizer,
            "scheduler": scheduler,
            "epoch_iteration": {"type": "SupervisedEpoch", "data": "train",
                                "criterion": "default",
                                "batch_average": batch_average,
                                "fakebatch": not batch_average}},
        "validation": {"type": "SingleValidation", "data": "val",
                       "criterion": "default", "network_overlay": None,
                       "frequency": 1}}


def translator_scenario(directory, tsvs, epochs):
    """The translator alone (dropout 0.5): L1, adam (pix2pix's lr), loss
    validation on held-out pairs."""
    return {
        "network": {"type": "SingleNetwork", "path": None,
                    "model": dict(TRANSLATOR_MODEL),
                    "initialize": {"weights": "normal_p2p", "seed": SEED},
                    "runtime": {"wrappers": "", "data": dict(UNET_DATA),
                                **FLOAT32_RUNTIME}},
        "learning": learning_section(
            directory, epochs, {"loss": "l1"},
            {"algorithm": "adam", "lr": 2e-4, "weight_decay": 0},
            {"algorithm": "const"}, True),
        "output": {"learning": {"progress": {"print_each": 0}}},
        "data": {"train": pairs_data(tsvs[0], PAIR_TRANSFORM),
                 "val": pairs_data(tsvs[1], PAIR_VAL_TRANSFORM)}}


def joint_optimizer(embed=None, alternate=None, order=None):
    adam = {"algorithm": "adam", "lr": 1e-4, "weight_decay": 0}
    return {"composition": {"type": "alternation",
                            "alternate_iteration": alternate,
                            "order": order},
            "translate": adam, "embed": embed and dict(adam)}


def joint_scenario(directory, db_pkl, epochs):
    """The paper's "U-Net jointly N/D" training: phase 10's P2pUNet then
    phase 7's VGG16-GeM, the embedder frozen (``embed: null``),
    contrastive loss, mining through the composition, loss validation on
    the val split."""
    tuples = {"name": "CirTuples", "dataset": "retrieval-SfM-smoke",
              "image_size": JOINT_SIDE, "neg_num": TRAIN_NEG_NUM,
              "dataset_pkl": db_pkl, "image_dir": None,
              "loader": joint_loader}
    return {
        "network": {
            "type": "SequentialNetwork", "sequence": "translate,embed",
            "translate": {"type": "SingleNetwork", "path": None,
                          "model": dict(UNET_MODEL),
                          "initialize": {"weights": "normal_p2p",
                                         "seed": SEED},
                          "runtime": {"wrappers": "",
                                      "data": dict(UNET_DATA)}},
            "embed": {"type": "CirNetwork", "path": None,
                      "model": dict(CLAHE_MODEL),
                      "initialize": {"weights": "default", "seed": SEED},
                      "runtime": {"wrappers": {
                          "train": "cirfaketuplebatch",
                          "eval": "cirfaketuplebatch"},
                          **FLOAT32_RUNTIME}}},
        "learning": learning_section(
            directory, epochs, {"loss": "contrastive", "margin": 0.7,
                                "eps": 1e-6},
            joint_optimizer(), None, False, every=1),
        "output": {"learning": {"progress": {"print_each": 0}}},
        "data": {
            "train": {"transforms": PLAIN_TRANSFORM, "dataset": dict(
                tuples, split="train", query_size=TRAIN_QUERY_SIZE,
                pool_size=TRAIN_POOL_SIZE),
                "loader": {"batch_size": TRAIN_BATCH}},
            "val": {"transforms": PLAIN_TRANSFORM, "dataset": dict(
                tuples, split="val", query_size=JOINT_VAL_PAIRS,
                pool_size=JOINT_VAL_POOL),
                "loader": {"batch_size": TRAIN_BATCH}}},
    }


def cpu_dropout_masks():
    """Dropout with its masks drawn from a CPU generator and moved to the
    input's device, so a card and a CPU run drop the same cells."""
    from mdir_tpu_torch.models import layers

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = 1.0 - self.p
        u = torch.rand(x.shape, generator=self.generator,
                       dtype=x.dtype).to(x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    return mock.patch.object(layers.Dropout, "forward", forward)


def card_cpu_image_step(tag, device, state, images, targets, chain=None):
    """One step of the network of checkpoint ``state`` on the card and on
    the CPU from the same weights, the Dropout masks from one CPU seed: the
    loss (relative), the cosine of the flattened gradient of the trained
    parameters at GRAD_MIN_COSINE and each tensor's at
    GRAD_MIN_TENSOR_COSINE (a BatchNorm over the four 1 x 1 cells of the
    innermost level amplifies float32 rounding there), and the live
    BatchNorm statistics after the step."""
    from mdir_tpu_torch.learning.network import initialize_network
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.optim.criteria import initialize_criterion

    criterion = {"loss": "l1"} if chain is None else {
        "loss": "contrastive", "margin": 0.7, "eps": 1e-6}
    results = []
    with cpu_dropout_masks():
        for where in (device, torch.device("cpu")):
            net = initialize_network(None, where, copy.deepcopy(state))
            net.train()
            step = TrainStep(net, initialize_criterion(criterion),
                             device_chain=chain,
                             generator=torch.Generator().manual_seed(SEED))
            loss, _ = step.gradients(images, targets)
            models = [m.model for m in step.members]
            results.append((float(loss), {
                name: p.grad.detach().cpu().double()
                for m in models for name, p in m.named_parameters()
                if p.grad is not None}, {
                name: b.detach().cpu().double()
                for m in models for name, b in m.named_buffers()
                if name.endswith(("running_mean", "running_var"))}))
    (card_loss, card, card_bn), (cpu_loss, cpu, cpu_bn) = results
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(card.keys() == cpu.keys() and cpu, ("gradients", sorted(cpu)))

    def cosine(a, b):
        return float((a * b).sum() / (a.norm() * b.norm()))

    flat = cosine(*(torch.cat([g[name].reshape(-1) for name in sorted(cpu)])
                    for g in (card, cpu)))
    cosines = {name: cosine(card[name], cpu[name])
               for name in cpu if cpu[name].norm() > 0}
    worst = min(cosines, key=cosines.get)
    bn_err = max(float(((card_bn[n] - cpu_bn[n]).abs()
                        - BN_RTOL * cpu_bn[n].abs()).max())
                 for n in cpu_bn)
    say(tag, "one step at %d x %d, card against CPU: loss %.6f vs %.6f "
        "(rel %.2e), gradient cosine %.8f (%d tensors; the least a "
        "tensor's %.7f, %s), BatchNorm statistics: max |diff| - rtol |CPU| "
        "%.2e (%d tensors)"
        % (CHECK_SIDE, CHECK_SIDE, card_loss, cpu_loss, rel, flat,
           len(cosines), cosines[worst], worst, bn_err, len(cpu_bn)))
    check(rel <= LOSS_RTOL, (tag + " card step loss vs CPU", card_loss,
                             cpu_loss))
    check(flat >= GRAD_MIN_COSINE, (tag + " card step gradient vs CPU",
                                    flat))
    check(cosines[worst] >= GRAD_MIN_TENSOR_COSINE,
          (tag + " card step gradient tensor vs CPU", worst, cosines[worst]))
    check(cpu_bn and bn_err <= BN_ATOL, (tag + " BatchNorm statistics",
                                         bn_err))


class PhaseRecorder:
    """Patches of the train stage's seams for phase 15: each step timed
    (and epoch 0's batches kept), each mining timed with its launches, RNG
    state and weights, each loss validation timed with its launches and
    losses, and each epoch's network state. The training file of epoch
    ``keep`` is copied aside (a later epoch's save deletes it)."""

    def __init__(self, counts, keep=None):
        self.counts = counts
        self.keep = keep
        self.steps, self.minings, self.validations = [], [], []
        self.saved, self.batches = {}, []

    def patches(self):
        import contextlib

        from mdir_tpu_torch.data.datasets import TuplesDataset
        from mdir_tpu_torch.learning.checkpoints import Checkpoints
        from mdir_tpu_torch.learning.epoch_iteration import SupervisedEpoch
        from mdir_tpu_torch.learning.validation import LossValidation

        mine, step, validate, save = (
            TuplesDataset.create_epoch_tuples,
            SupervisedEpoch._optimization_step, LossValidation.validate,
            Checkpoints.save_epoch)
        recorder = self

        def timed_mine(dataset, network):
            members = getattr(network, "networks", {"net": network})
            record = {"dataset": dataset, "network": network,
                      "rng": np.random.get_state(),
                      "before": recorder.counts(),
                      "weights": {name: {k: v.clone() for k, v in
                                         m.model.state_dict().items()}
                                  for name, m in members.items()}}
            torch.cuda.synchronize()
            t = time.perf_counter()
            stats = mine(dataset, network)
            torch.cuda.synchronize()
            record.update(seconds=time.perf_counter() - t,
                          after=recorder.counts(), mined=dict(dataset.mined),
                          nidxs=[list(n) for n in dataset.nidxs])
            recorder.minings.append(record)
            return stats

        def timed_step(epoch, network, optimizer, images, targets):
            if epoch.epoch == 0:
                recorder.batches.append((images, targets))
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses = step(epoch, network, optimizer, images, targets)
            torch.cuda.synchronize()
            recorder.steps.append((epoch.epoch, time.perf_counter() - t,
                                   len(images)))
            return losses

        def timed_validate(validation, network, logger=None):
            record = {"validation": validation, "before": recorder.counts(),
                      "rng": np.random.get_state()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses = validate(validation, network, logger)
            torch.cuda.synchronize()
            record.update(seconds=time.perf_counter() - t, losses=losses,
                          after=recorder.counts())
            recorder.validations.append(record)
            return losses

        def recorded_save(store, networks_state, *args, **kwargs):
            import shutil

            recorder.saved[args[1]] = copy.deepcopy(networks_state)
            save(store, networks_state, *args, **kwargs)
            if args[1] == recorder.keep:
                path = os.path.join(store.directory, "learning_epoch_%02d.ckpt"
                                    % (args[1] + 1))
                shutil.copy(path, path + ".kept")

        patches = contextlib.ExitStack()
        for owner, name, fn in (
                (TuplesDataset, "create_epoch_tuples", timed_mine),
                (SupervisedEpoch, "_optimization_step", timed_step),
                (LossValidation, "validate", timed_validate),
                (Checkpoints, "save_epoch", recorded_save)):
            patches.enter_context(mock.patch.object(owner, name, fn))
        return patches


def launch_split(recorder, start, end):
    """Each kernel's launches in a run, from the counts ``start`` before it
    to ``end`` after it: mining (train and val tuples), loss validation
    (its own mining apart) and train steps."""
    def spent(records, name):
        return sum(r["after"][name] - r["before"][name] for r in records)

    split = {}
    for name in end:
        mining = spent(recorder.minings, name)
        validation = spent(recorder.validations, name)
        val_mining = spent([m for m in recorder.minings
                            if m["dataset"].mode == "val"], name)
        split[name] = {"mining": mining,
                       "loss_validation": validation - val_mining,
                       "train_step": end[name] - start[name] - mining
                       - (validation - val_mining)}
    return split


def query_gaps(mined):
    """Each query's smallest score gap its picked negatives relied on:
    ``selection_gap`` of that query's picks alone."""
    from mdir_tpu_torch.data.datasets import selection_gap

    positions = mined["positions"]
    return [selection_gap(mined["scores"], mined["ranks"], [
        picked if i == q else [] for i, picked in enumerate(positions)])
        for q in range(len(positions))]


def image_train_phase(device, clahe, lab_trilinear, pooling_kernel,
                      gem_l2n_plain, gen, smi):
    """Phase 15: the translator's L1 training on image pairs and the joint
    N/D training of the composition, in float32, each through the train
    stage with loss validation; their checks; each kernel entry's launches;
    the pool kernel at every input the phase gave it."""
    import contextlib
    import io
    import shutil

    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.datasets import initialize_dataset_loader
    from mdir_tpu_torch.data.loaders import DataLoader
    from mdir_tpu_torch.learning.epoch_iteration import SupervisedEpoch
    from mdir_tpu_torch.learning.network import initialize_network
    from mdir_tpu_torch.learning.training import reseed_host
    from mdir_tpu_torch.models.layers import Dropout, set_dropout_generator
    from mdir_tpu_torch.optim.criteria import initialize_criterion
    from mdir_tpu_torch.optim.optimizers import initialize_optimizer
    from mdir_tpu_torch.stages.train import train

    t_phase = time.perf_counter()
    root = os.path.join(_build.BUILD_ROOT, "smoke", "image_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    loss_key = "train/learning/loss:total_avg.4"
    val_key = "val/learning/loss:total_avg.4"
    # every gem_l2n call of the phase, recorded (comparisons with the plain
    # version patch the pool and are not recorded)
    pool_inputs, pool_dtypes = [], []
    recording = mock.patch.object(pooling_kernel, "gem_l2n", recording_pool(
        pooling_kernel.gem_l2n, pool_inputs, pool_dtypes))
    pooling_kernel.reset_launches()
    lab_trilinear.reset_launches()
    clahe.reset_launches()
    recording.start()

    def counts():
        """Each kernel entry's launches in the phase so far: the chain
        kernels' counters, and gem_l2n's counter (one for its three
        instantiations) split by the dtype of the maps it was given."""
        n = kernel_counts(clahe, lab_trilinear, pooling_kernel)
        check(n["gem_l2n"] == len(pool_dtypes),
              ("gem_l2n launches against its recorded calls", n["gem_l2n"],
               len(pool_dtypes)))
        n.update({name: sum(d == dtype for d in pool_dtypes)
                  for dtype, name in GEM_DTYPES.items()})
        return n

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return counts()

    # 1. the translator alone on day/night pairs
    make_pairs(np.random.RandomState(SEED), PAIR_TRAIN + PAIR_HELD_OUT)
    tsvs = [os.path.join(root, name) for name in ("pairs.tsv", "val.tsv")]
    write_pairs(tsvs[0], range(PAIR_TRAIN))
    write_pairs(tsvs[1], range(PAIR_TRAIN, PAIR_TRAIN + PAIR_HELD_OUT))
    exp = os.path.join(root, "translator")
    recorder = PhaseRecorder(counts)
    start = reset()
    t = time.perf_counter()
    with recorder.patches(), contextlib.redirect_stdout(io.StringIO()):
        meta, = train(translator_scenario(exp, tsvs, PAIR_EPOCHS), (),
                      device=device)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    translator_launches = launch_split(recorder, start, counts())
    losses, val = meta["metrics"][loss_key], meta["metrics"][val_key]
    step_s = [s for _, s, _ in recorder.steps]
    check(len(losses) == len(val) == PAIR_EPOCHS and all(
        np.isfinite(x) and x > 0 for x in losses + val),
        ("translator losses", losses, val))
    check(len(step_s) == PAIR_EPOCHS * PAIR_TRAIN // PAIR_BATCH,
          ("translator steps", len(step_s)))
    check(all(n["mining"] == n["train_step"] == n["loss_validation"] == 0
              for n in translator_launches.values()),
          ("the translator's path has no kernel", translator_launches))
    first = recorder.batches[0][0]
    say("imgtr", "translator P2pUNet (nested %d, dropout %.1f), L1, adam: "
        "%d epochs of %d pairs in %d-pair batches (%s), %.2f s with "
        "validation and checkpoints; %.4f s/step (%.4f-%.4f); loss %s, "
        "validation loss %s (%s s); peak %.2f GB"
        % (TRANSLATOR_MODEL["nested_levels"], TRANSLATOR_MODEL["dropout"],
           PAIR_EPOCHS, PAIR_TRAIN, PAIR_BATCH, first.shape, seconds,
           np.mean(step_s), min(step_s), max(step_s),
           ["%.6f" % x for x in losses], ["%.6f" % x for x in val],
           ["%.3f" % v["seconds"] for v in recorder.validations],
           peak / 1e9))

    # an epoch's loader batches, rerun from the epoch's seed
    scenario = translator_scenario(exp, tsvs, PAIR_EPOCHS)
    reseed_host(SEED)
    again = list(initialize_dataset_loader(
        (), "train", copy.deepcopy(scenario["data"]["train"]),
        {"shuffle": True}))
    check(len(again) == len(recorder.batches) and all(
        np.array_equal(a, b) for (x, y), (u, v) in zip(
            recorder.batches, again) for a, b in ((x, u), (y, v))),
        "epoch 0's batches rerun from its seed")
    say("imgtr", "epoch 0's %d batches through %s bit-identical when "
        "rerun from its seed" % (len(recorder.batches), PAIR_TRANSFORM))

    # Dropout on the card: the same generator state gives the same output
    # (the layer alone: the net's transposed convolutions need not repeat
    # bit for bit), and train output differs from eval
    state = recorder.saved[PAIR_EPOCHS - 1]
    model = initialize_network(None, device, copy.deepcopy(state)).model
    drop = next(m for m in model.modules() if isinstance(m, Dropout))
    x = torch.from_numpy(first[:2]).to(device).permute(0, 3, 1, 2)
    h = torch.rand((2, 512, 2, 2), generator=torch.Generator(
        device=device).manual_seed(SEED), device=device)
    outs = []
    with torch.no_grad():
        for _ in range(2):
            set_dropout_generator(model, torch.Generator(
                device=device).manual_seed(SEED + 1))
            model.train()
            outs.append((drop(h), model(x)))
        model.eval()
        plain = model(x)
    kept = float((outs[0][0] != 0).float().mean())
    check(torch.equal(outs[0][0], outs[1][0]),
          "dropout: same generator state, same output")
    check(torch.equal(drop(h), h) and not torch.equal(outs[0][1], plain),
          "dropout: eval is the identity, train != eval")
    say("imgtr", "dropout on the card: one generator seed, one mask "
        "(%.3f kept at p %.1f); max |train - eval| of the net %.3e"
        % (kept, drop.p, float((outs[0][1] - plain).abs().max())))

    # one step on the card against the CPU at 256 x 256
    images, targets = recorder.batches[0]
    card_cpu_image_step("imgtr", device, state, images[:2], targets[:2])

    # 2. the joint N/D training
    for name, img in train_images().items():  # square crops of phase 9's
        JOINT_IMAGES[name] = np.ascontiguousarray(img[:JOINT_SIDE,
                                                      :JOINT_SIDE])
    names = sorted(JOINT_IMAGES)
    db_pkl = os.path.join(root, "db.pkl")
    cids = ["/smoke/%s" % name for name in names]
    clusters = [i // 2 for i in range(len(names))]
    with open(db_pkl, "wb") as handle:
        pickle.dump({"train": {
            "cids": cids, "cluster": clusters,
            "qidxs": [2 * k for k in range(TRAIN_PAIRS)],
            "pidxs": [2 * k + 1 for k in range(TRAIN_PAIRS)]},
            "val": {
            "cids": cids, "cluster": clusters,
            "qidxs": [2 * k for k in range(
                TRAIN_PAIRS, TRAIN_PAIRS + JOINT_VAL_PAIRS)],
            "pidxs": [2 * k + 1 for k in range(
                TRAIN_PAIRS, TRAIN_PAIRS + JOINT_VAL_PAIRS)]}}, handle)
    exp = os.path.join(root, "joint")
    recorder = PhaseRecorder(counts, keep=JOINT_EPOCHS - 2)
    start = reset()
    t = time.perf_counter()
    with recorder.patches(), contextlib.redirect_stdout(io.StringIO()):
        meta, = train(joint_scenario(exp, db_pkl, JOINT_EPOCHS), (),
                      device=device)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    joint_launches = launch_split(recorder, start, counts())
    losses, val = meta["metrics"][loss_key], meta["metrics"][val_key]
    check(len(losses) == len(val) == JOINT_EPOCHS and all(
        np.isfinite(x) and x > 0 for x in losses + val),
        ("joint losses", losses, val))
    gem = joint_launches["gem_l2n"]
    check(gem["mining"] > 0 and gem["loss_validation"] > 0
          and gem["train_step"] == 0,
          ("gem_l2n on the joint path: mining and loss validation, not the "
           "step (it pools under autograd)", gem))
    for name, n in joint_launches.items():
        check(name == "gem_l2n" or sum(n.values()) == 0,
              ("no chain kernel on the plain route", name, n))
    step_s = [s for _, s, _ in recorder.steps]
    train_minings = [m for m in recorder.minings
                     if m["dataset"].mode == "train"]
    mined = (TRAIN_QUERY_SIZE + TRAIN_POOL_SIZE) * len(train_minings)
    mining_s = sum(m["seconds"] for m in train_minings)
    say("joint", "P2pUNet -> VGG16-GeM (embed: null), contrastive, adam, "
        "tuples of %d at %d px, %d a batch: %d epochs in %.2f s with mining, "
        "validation and checkpoints; %.3f s/step (%d steps, %.1f tuples/s); "
        "mining %.1f images/s; loss %s, validation loss %s (%s s each, "
        "mining included); peak %.2f GB; launches %s"
        % (2 + TRAIN_NEG_NUM, JOINT_SIDE, TRAIN_BATCH, JOINT_EPOCHS,
           seconds, np.mean(step_s), len(step_s),
           sum(n for _, _, n in recorder.steps) / sum(step_s),
           mined / mining_s, ["%.6f" % x for x in losses],
           ["%.6f" % x for x in val],
           ["%.3f" % v["seconds"] for v in recorder.validations],
           peak / 1e9, joint_launches))

    # the embedder is bit-unchanged
    first_weights = recorder.minings[0]["weights"]["embed"]
    final = recorder.saved[JOINT_EPOCHS - 1]
    for name, value in final["embed"]["model_state"].items():
        check(torch.equal(value, first_weights[name].cpu()),
              ("the frozen embedder moved", name))
    moved = max(float((value - recorder.minings[0]["weights"]["translate"][
        name].cpu()).abs().max()) for name, value
        in final["translate"]["model_state"].items())
    check(moved > 0, "the translator trained")
    say("joint", "the embedder bit-unchanged over %d epochs (%d tensors); "
        "the translator moved by up to %.3e"
        % (JOINT_EPOCHS, len(first_weights), moved))

    # mining with the kernels against the plain versions: the descriptors
    # within DESC_ATOL, and the same negatives for every query whose picks
    # the measured score error cannot reorder (its score gap over twice
    # the error: each of two scores moves by at most the error); the
    # other queries' gaps are printed
    network = recorder.minings[0]["network"]
    desc_err, reads = 0.0, []
    for record in recorder.minings:
        for name, weights in record["weights"].items():
            network.networks[name].model.load_state_dict(weights)
        np.random.set_state(record["rng"])
        with mock.patch.object(pooling_kernel, "gem_l2n", gem_l2n_plain), \
                contextlib.redirect_stdout(io.StringIO()):
            record["dataset"].create_epoch_tuples(network)
        plain, mined = record["dataset"].mined, record["mined"]
        desc_err = max([desc_err] + [float(np.abs(plain[key] - mined[key])
                                           .max())
                                     for key in ("qvecs", "poolvecs")])
        score_err = float(np.abs(plain["scores"] - mined["scores"]).max())
        gaps = query_gaps(mined)
        differing = [q for q, nidxs in enumerate(record["dataset"].nidxs)
                     if nidxs != record["nidxs"][q]]
        implied = [q for q, gap in enumerate(gaps) if gap > 2 * score_err]
        check(not set(differing) & set(implied),
              ("mined negatives, kernels against plain, where the score "
               "error cannot reorder them", record["dataset"].mode,
               differing, score_err))
        reads.append("%s: score error %.2e, %d/%d queries gated, least "
                     "gap %.2e%s" % (
                         record["dataset"].mode, score_err, len(implied),
                         len(gaps), min(gaps), "".join(
                             "; query %d gap %.2e %s" % (
                                 q, gaps[q], "differs" if q in differing
                                 else "same") for q in range(len(gaps))
                             if q not in implied)))
    check(desc_err <= DESC_ATOL, ("mining descriptors vs plain", desc_err))
    say("joint", "mining, kernels against plain: max |desc diff| %.2e "
        "(tolerance %g); the same negatives for every gated query: %s"
        % (desc_err, DESC_ATOL, " | ".join(reads)))

    # loss validation with the kernels against its plain run, on the final
    # weights: the composition (per image, through its wrappers) and the
    # embedder alone (one padded bucket per batch)
    record = recorder.validations[-1]
    validation = record["validation"]
    composed = recorder.minings[0]["network"]  # the run's, final weights
    for name in composed.sequence:
        composed.networks[name].model.load_state_dict(
            final[name]["model_state"])
    embedder = initialize_network(None, device, {"net": copy.deepcopy(
        final["embed"])})
    def spent(before, after):
        return {name: after[name] - before[name] for name in after}

    val_reads = {"composition": (record["seconds"], spent(record["before"],
                                                          record["after"]))}
    for tag, net in (("composition", composed), ("embedder", embedder)):
        # the composition's run with the kernels is the stage's own last
        # validation, on these weights
        runs = [record["losses"]] if tag == "composition" else []
        for plain in (True,) if tag == "composition" else (False, True):
            np.random.set_state(record["rng"])
            patch = mock.patch.object(pooling_kernel, "gem_l2n",
                                      gem_l2n_plain) if plain \
                else contextlib.nullcontext()
            before = counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with patch, contextlib.redirect_stdout(io.StringIO()):
                runs.append(validation.validate(net))
            torch.cuda.synchronize()
            if not plain:
                val_reads[tag] = (time.perf_counter() - t,
                                  spent(before, counts()))
        rel = max(abs(a - b) / abs(b) for a, b in zip(*runs))
        check(rel <= DESC_ATOL, ("loss validation vs plain", tag, rel))
        launched = val_reads[tag][1]
        check(launched["gem_l2n"] > 0, ("gem_l2n in loss validation", tag))
        say("joint", "loss validation of the %s, kernels against plain: "
            "losses %s, max rel diff %.2e; %.3f s, launches %s"
            % (tag, ["%.6f" % x for x in runs[0]], rel, val_reads[tag][0],
               launched))

    # one joint step on the card against the CPU at 256 x 256
    dataset = train_minings[-1]["dataset"]
    images, target = dataset[0]
    tpl = [np.ascontiguousarray(img[:CHECK_SIDE, :CHECK_SIDE])
           for img in images[:3]]
    card_cpu_image_step("joint", device, final, [tpl], [target[:3]],
                        chain=dataset.device_chain)

    # the resumed epoch against the straight run: epoch 2's files as its
    # save left them (its training file put back), the last epoch's gone
    epochs_dir = os.path.join(exp, "epochs")
    for name in os.listdir(epochs_dir):
        if "_%02d." % JOINT_EPOCHS in name or name.endswith(
                ("_best.ckpt", "_bestsofar.ckpt", "_last.ckpt")):
            os.remove(os.path.join(epochs_dir, name))
    kept = os.path.join(epochs_dir, "learning_epoch_%02d.ckpt"
                        % (JOINT_EPOCHS - 1))
    os.replace(kept + ".kept", kept)
    resumed_rec = PhaseRecorder(counts)
    with resumed_rec.patches(), contextlib.redirect_stdout(io.StringIO()):
        resumed, = train(joint_scenario(exp, db_pkl, JOINT_EPOCHS), (),
                         device=device)
    again = resumed["metrics"]
    check(len(resumed_rec.minings) == 2 and again[loss_key][:-1]
          == losses[:-1], ("a resume of the last epoch",
                           len(resumed_rec.minings), again[loss_key]))
    rel = max(abs(again[k][-1] - meta["metrics"][k][-1])
              / abs(meta["metrics"][k][-1]) for k in (loss_key, val_key))
    weights = max(float((value - resumed_rec.saved[JOINT_EPOCHS - 1][
        "translate"]["model_state"][name]).abs().max()) for name, value
        in final["translate"]["model_state"].items())
    check(rel <= LOSS_RTOL, ("resumed epoch vs straight", rel))
    say("joint", "epoch %d resumed from epoch %d's checkpoint files "
        "(members %s) against the straight run: loss and validation loss "
        "max rel diff %.2e, translator weights max |diff| %.2e"
        % (JOINT_EPOCHS, JOINT_EPOCHS - 1,
           sorted(n for n in os.listdir(epochs_dir) if "_%02d." % (
               JOINT_EPOCHS - 1) in n), rel, weights))

    # two steps with both members trained, alternating every step: the
    # final weights, the embedder no longer frozen
    network = initialize_network(None, device, copy.deepcopy(final))
    network.networks["embed"].frozen = False
    optimizer = initialize_optimizer(network, joint_optimizer(
        embed=True, alternate=1, order="translate,embed"))
    epoch = SupervisedEpoch(
        DataLoader(dataset, batch_size=TRAIN_BATCH, **dataset.loader_params),
        initialize_criterion({"loss": "contrastive", "margin": 0.7,
                              "eps": 1e-6}),
        batch_average=False, fakebatch=True).steps(0)
    network.train()
    order = []
    for (images, targets), expected in zip(epoch.data_loader,
                                           ("translate", "embed")):
        before = {name: [p.detach().clone() for p in
                         network.networks[name].model.parameters()]
                  for name in network.sequence}
        check(optimizer.active_names() == [expected],
              ("alternation order", optimizer.active_names()))
        torch.cuda.synchronize()
        t = time.perf_counter()
        epoch._optimization_step(network, optimizer, images, targets)
        torch.cuda.synchronize()
        moved = [name for name in network.sequence if any(
            not torch.equal(a, b) for a, b in zip(
                before[name], network.networks[name].model.parameters()))]
        check(moved == [expected], ("alternation moved", moved, expected))
        order.append((expected, time.perf_counter() - t))
    check((optimizer.current_iteration, optimizer.current_optimizer)
          == (2, 0), ("alternation counters", optimizer.current_iteration,
                      optimizer.current_optimizer))
    say("joint", "alternate_iteration 1, both members trained: steps moved "
        "%s (%s s), counters (iteration, optimizer) = (2, 0)"
        % ([m for m, _ in order], ["%.3f" % s for _, s in order]))

    counts()  # the counter and the recorded calls still agree
    recording.stop()
    shutil.rmtree(root, ignore_errors=True)
    PAIR_IMAGES.clear()
    JOINT_IMAGES.clear()
    # the kernel at every input the phase gave it (512 px squares' maps in
    # mining, the one-image launches of the composition's loss validation,
    # the embedder's padded buckets)
    check(set(pool_dtypes) == {torch.float32},
          ("phase 15's pool maps", set(pool_dtypes)))
    pool = gem_path_phase("image train", pooling_kernel, gem_l2n_plain,
                          pool_inputs, gen, device)
    say("imgtr", "phase 15: %.1f s | %s" % (time.perf_counter() - t_phase,
                                            smi))
    return {"translator": translator_launches, "joint": joint_launches,
            "joint_step": {"network": network,
                           "batch": recorder.batches[0],
                           "mean_std": UNET_DATA["mean_std"]},
            "loss_validation": {tag: n for tag, (_, n) in val_reads.items()},
            "pool": pool}


def read_png(path):
    """The pixels of a PNG written by the event broker's encoder (8-bit,
    unfiltered rows), read with the standard library: the card's machine
    has no PIL."""
    import struct
    import zlib

    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", ("PNG signature", path))
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, colour = header[:4]
    channels = {0: 1, 4: 2, 2: 3, 6: 4}[colour]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * channels)
    check(depth == 8 and not rows[:, 0].any(), ("unfiltered 8-bit", path))
    return rows[:, 1:].reshape(h, w, channels).squeeze(-1) \
        if channels == 1 else rows[:, 1:].reshape(h, w, channels)


def branched_phase(device, db, queries, gnd, whiten_path, clahe,
                   lab_trilinear, pooling_kernel, gem_l2n_plain, gen, smi):
    """Phase 16: the branched VGG16-GeM (``cirnet_branched``: an RGB
    branch and a lab CLAHE lightness branch through conv1_1 and conv1_2,
    summed at layer 2) in float32 on the 40 images (scales 1, 2^-1/2, 1/2,
    Lw), after ``warmup_extraction``; the same run on the plain kernels;
    the per-image path; the kernel at the net's maps; the concat merge and
    the input-merged net on 8 images; the net under ``auto``; one train
    step, card against CPU; the event tools on the card. Returns the
    kernels' launches on the timed run and the pool's checks."""
    import shutil
    import tempfile

    from mdir_tpu_torch import _build
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.ops import dtypes as dtype_policy
    from mdir_tpu_torch.ops.preprocess import chain_from_transform
    from mdir_tpu_torch.ops.ranking import compute_map, rank_database
    from mdir_tpu_torch.optim.criteria import initialize_criterion
    from mdir_tpu_torch.parallel import extract
    from mdir_tpu_torch.tools import events, sysstats, warmup

    t_phase = time.perf_counter()
    n_images = len(db) + len(queries)
    transform = initialize_transforms(BRANCHED_TRANSFORM, BRANCHED_MEAN_STD)
    chain = chain_from_transform(transform)
    check(chain is not None, "the branched transform lowers to the chain")

    def make_net(params, where=device, scales=SCALES, mode="float32",
                 wrappers=True):
        model = initialize_model(params, device=where, seed=SEED)
        eval_wrappers = {
            "0_cirwhiten": {"whitening": whiten_path, "dimensions": None},
            "1_cirmultiscale": {"scales": scales}} if wrappers else ""
        return CirNetwork(model, CirNetwork.NetworkParams(
            model=params, runtime={
                "wrappers": {"train": None, "eval": eval_wrappers},
                "data": {"mean_std": [list(v) for v in BRANCHED_MEAN_STD]},
                "compute_dtype": mode}), frozen=True)

    def batched(network, image_sets, chain_in=None):
        """Descriptors, chunks and guard reports of the path; each chunk's
        chain input (the uint8 bucket and its CLAHE aux) is copied into
        ``chain_in`` when it is given."""
        out, chunks, reports = [], 0, []
        for images in image_sets:
            extractor = extract.network_extractor(network, transform)
            check(extractor.chain_fn is not None, "the device chain's route")
            if chain_in is not None:
                extractor.chain_fn = recording_chain(extractor.chain_fn,
                                                     chain_in)
            for i, img in enumerate(images):
                extractor.add(i, img)
            out.append(extractor.finish(len(images)))
            chunks += extractor.chunks
            reports.append(extractor.guard_report)
        return out, chunks, reports

    def ranks_of(out):
        vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for v in out)
        return rank_database(vecs, qvecs).cpu().numpy()

    net = make_net(BRANCHED_MODEL)
    check(net.model.meta["in_channels"] == 4, "4 input channels")
    torch.cuda.synchronize()
    t = time.perf_counter()
    warmed = warmup.warmup_extraction(
        net.model, warmup.bucket_shapes(
            [img.shape[:2] for img in db + queries],
            extract.BUCKET_MULTIPLE), scales=SCALES, msp=net.model.pool_p,
        device_chain=chain)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t

    gem_in, chain_in = [], []
    for module in (pooling_kernel, lab_trilinear, clahe):
        module.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with mock.patch.object(pooling_kernel, "gem_l2n", recording_pool(
            pooling_kernel.gem_l2n, gem_in)):
        out, chunks, _ = batched(net, (db, queries), chain_in)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = kernel_counts(clahe, lab_trilinear, pooling_kernel)
    peak = torch.cuda.max_memory_allocated()
    for v in out:
        check(v.shape[0] == CLAHE_DIM and np.isfinite(v).all(),
              "branched: finite descriptors")
        check(np.abs(np.linalg.norm(v, axis=0) - 1).max() < 1e-4,
              "branched: unit norms")
    check(launches["gem_l2n"] == chunks * len(SCALES),
          ("branched: gem_l2n launches", launches, chunks))
    for name in ("lab_n", "clahe_tile_luts", "clahe_interp"):
        check(launches[name] == chunks,
              ("branched: %s launches" % name, launches, chunks))
    ranks = ranks_of(out)
    mean_ap = compute_map(ranks, gnd)[0]
    say("branch", "VGG16-GeM branched (rgb + lab CLAHE lightness, sum at "
        "layer 2), scales %s, Lw: warm-up %d buckets %.2f s; %d images in "
        "%d chunks, %.2f s, %.1f images/s, peak %.2f GB; launches %s; mAP "
        "%.4f | %s"
        % ([round(x, 4) for x in SCALES], len(warmed), warm_s, n_images,
           chunks, seconds, n_images / seconds, peak / 1e9, launches,
           mean_ap, smi))

    pool = gem_path_phase("branched VGG16", pooling_kernel, gem_l2n_plain,
                          gem_in, gen, device)
    check(pool["max_abs_err"] <= 1e-6, ("branched pool", pool))

    # the event tools on the card: a weight log, a sample blob, the stats
    root = tempfile.mkdtemp(dir=_build.BUILD_ROOT)
    broker = events.initialize_processor({}, dataroot=root)
    row, = net.train_data()
    torch.cuda.synchronize()
    t = time.perf_counter()
    broker.register_data(0, 0, 1, "train/" + row["key"], row["data"],
                         row["dtype"])
    log_s = time.perf_counter() - t
    name = max(row["data"], key=lambda k: row["data"][k].numel())
    _, counts = broker.epoch_log.rows[-1]["data"][name]
    want, _ = np.histogram(row["data"][name].cpu().numpy(), bins=200)
    check(np.array_equal(counts, want), ("weight histogram", name))
    sample = db[0][:96, :64]
    broker.register_data(0, 0, 1, "train/data/input", {
        "image0.rgb": {"dtype": "image:rgb", "data": sample}}, "blob")
    path = broker.epoch_log.rows[-1]["data"]["image0.rgb"]["path"]
    check(np.array_equal(read_png(path), sample), "sample blob round trip")
    broker.close_epoch()
    shutil.rmtree(root)

    def gates():
        """The untimed gates, run on the card beside the CPU's step."""
        # the chain's kernels against plain at every chunk of the timed run
        grid = chain.clahe_params[1]
        check(len(chain_in) == chunks, ("branched: chunks recorded",
                                        len(chain_in), chunks))
        for batch, aux in chain_in:
            check_equal(lab_trilinear.lab_n(batch),
                        lab_trilinear.lab_n_plain(batch),
                        ("branched: lab_n", tuple(batch.shape)))
            clahe_against_plain(clahe, lab_trilinear.lab_l_u8(batch), aux,
                                grid, ("branched", tuple(batch.shape)))
        say("branch", "lab_n, clahe_tile_luts, clahe_interp bit-equal to "
            "plain at all %d chunks of the timed pass" % len(chain_in))
        # every kernel on its plain version: descriptors and ranks
        with plain_clahe_kernels(clahe, lab_trilinear), \
                mock.patch.object(pooling_kernel, "gem_l2n", gem_l2n_plain):
            plain, _, _ = batched(net, (db, queries))
        desc_err = max(float(np.abs(a - b).max())
                       for a, b in zip(out, plain))
        check(desc_err <= DESC_ATOL, ("branched vs plain kernels",
                                      desc_err))
        check((ranks[:10] == ranks_of(plain)[:10]).all(),
              "branched: top-10 ranks vs plain kernels")
        # the exact per-image path on 8 images at native sizes
        exact = extract.extract_vectors_per_image(net, eight, None,
                                                  transform)
        exact_err = float(np.abs(out[0][:, picked] - exact).max())
        check(exact_err <= DESC_ATOL, ("branched vs per-image", exact_err))
        say("branch", "against the plain kernels: max |desc diff| %.2e, "
            "top-10 ranks equal; the per-image path on %d images: %.2e"
            % (desc_err, len(picked), exact_err))
        # the concat merge at layer 2 and the input-merged net, one scale
        variants = {}
        for tag, merge in (("concat at layer 2",
                            {"layer": 2, "aggregation": "concat"}),
                           ("input-merged",
                            {"layer": 0, "aggregation": "concat"})):
            variant = make_net(dict(BRANCHED_MODEL, channels={
                "merge": merge, "branches": BRANCHES}), scales=[1])
            got, _, _ = batched(variant, (eight,))
            want = extract.extract_vectors_per_image(variant, eight, None,
                                                     transform)
            variants[tag] = float(np.abs(got[0] - want).max())
            check(variants[tag] <= DESC_ATOL, (tag, "vs per-image",
                                               variants[tag]))
        say("branch", "%d images at one scale, batched against "
            "per-image: %s" % (len(eight), ", ".join(
                "%s %.2e" % kv for kv in variants.items())))
        # the net under auto: the guard's verdict
        auto_out, _, reports = batched(with_compute_dtype(net, "auto"),
                                       (db, queries))
        guard = reports[0]
        check(guard is not None and reports[1] is None,
              ("branched auto: the guard on the first chunk", reports))
        auto_err = max(float(np.abs(a - b).max())
                       for a, b in zip(auto_out, out))
        if not guard["ok"]:
            check(auto_err <= DESC_ATOL, ("guard rejected: float32",
                                          auto_err))
        say("branch", "auto: the guard %s (least row cosine %.6f, bar %g); "
            "max |desc - float32| %.2e"
            % ("accepted bfloat16" if guard["ok"] else "rejected it",
               guard["min_cosine"], dtype_policy.GUARD_MIN_COSINE,
               auto_err))
        return {"plain_err": desc_err, "per_image_err": exact_err,
                "variants": variants, "guard": guard,
                "auto_err": auto_err}

    # one step, card against CPU (the CPU's beside the gates), and auto
    # leaves the step in float32
    picked = list(range(0, len(db), len(db) // BRANCHED_EXACT))
    eight = [db[i] for i in picked]
    tuples = [[cut_to_side(db[(b * (2 + TRAIN_NEG_NUM) + k) % len(db)])
               for k in range(2 + TRAIN_NEG_NUM)]
              for b in range(TRAIN_BATCH)]
    targets = [np.array([-1, 1] + [0] * TRAIN_NEG_NUM, np.float32)
               ] * TRAIN_BATCH
    step, readings = card_cpu_tuple_step(
        "branch", device, lambda where: make_net(
            BRANCHED_MODEL, where=where, wrappers=False),
        tuples, targets, chain, meanwhile=gates)
    auto_step = TrainStep(make_net(BRANCHED_MODEL, mode="auto"),
                          initialize_criterion({"loss": "contrastive",
                                                "margin": 0.7}))
    check(auto_step.compute_dtype is None, "auto leaves the step float32")
    memory = sysstats.DeviceStats.memory_usage()
    say("branch", "events: %d weight tensors' histograms in %.3f s (%s's "
        "counts equal numpy's); a sample blob decoded equal; device memory "
        "%s" % (len(row["data"]), log_s, name, memory))
    say("branch", "phase 16: %.1f s | %s" % (time.perf_counter() - t_phase,
                                            smi))
    return {"launches": launches, "pool": pool, "readings": dict(
        readings, images_per_s=n_images / seconds, peak_gb=peak / 1e9,
        chunks=chunks, step=step, weight_log_s=log_s)}


def parallel_loader(path):
    """Phase 17's score loader: phase 4's in-memory images by name."""
    return PARALLEL_IMAGES[os.path.basename(path)]


def smoke_step(device, reference, runtime=None, mesh=None):
    """Phase 9's first float32 step (adam, lr 1e-6, one group) from its
    weights on its batch, through ``TrainStep`` on ``mesh``; ZeRO when
    ``runtime`` says so. Returns (loss, parameters, the optimizer)."""
    from mdir_tpu_torch.learning.network import initialize_network
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.optim.criteria import initialize_criterion
    from mdir_tpu_torch.optim.optimizers import Optimizer

    net = initialize_network(None, device, reference["state"],
                             dict(FLOAT32_RUNTIME, **(runtime or {})))
    net.train()
    step = TrainStep(net, initialize_criterion(
        {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}),
        device_chain=reference["chain"], mesh=mesh)
    optimizer = Optimizer(torch.optim.Adam(
        [{"params": list(net.model.parameters()), "lr": 1e-6}]),
        {"default": 1e-6}, ["default"])
    if step.param_sharding == "zero":
        optimizer.shard_state(mesh)
    optimizer.zero_grad()
    loss, _ = step.gradients(reference["images"], reference["targets"])
    optimizer.step()
    if net.device.type == "cuda":
        torch.cuda.synchronize()
    return float(loss), dict(net.model.named_parameters()), optimizer


def joint_step(network, start, batch, chain, optimizer,
               param_sharding=None, mesh=None):
    """One step of the joint N/D composition ``network`` from its member
    weights ``start`` on ``batch`` (``(tuples, targets)`` of uint8
    images) through the device chain ``chain``, with the optimizer section
    ``optimizer`` (an alternation, the embedder's null), in float32,
    through ``TrainStep`` on ``mesh`` (ZeRO with ``param_sharding``).
    Returns the loss, the translator's parameters and BatchNorm running
    statistics, and the optimizer."""
    from mdir_tpu_torch.learning.train_step import TrainStep
    from mdir_tpu_torch.optim.criteria import initialize_criterion
    from mdir_tpu_torch.optim.optimizers import initialize_optimizer

    for name, weights in start.items():
        network.networks[name].model.load_state_dict(weights)
    optimizer = initialize_optimizer(network, copy.deepcopy(optimizer))
    step = TrainStep(network, initialize_criterion(
        {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}),
        device_chain=chain, compute_dtype="float32",
        param_sharding=param_sharding, mesh=mesh)
    if param_sharding == "zero":
        optimizer.shard_state(mesh)
    network.train()
    optimizer.zero_grad()
    loss, _ = step.gradients(*batch)
    optimizer.step()
    if network.device.type == "cuda":
        torch.cuda.synchronize()
    model = network.networks["translate"].model
    return (float(loss),
            {k: v.detach().clone() for k, v in model.named_parameters()},
            {k: v.clone() for k, v in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}, optimizer)


def joint_start(network):
    """Each member's weights, to start every step from."""
    return {name: {k: v.clone() for k, v in
                   network.networks[name].model.state_dict().items()}
            for name in network.sequence}


def whole_batch_steps(mesh, joint, clahe, lab_trilinear, pooling_kernel):
    """Phase 17's whole-batch route: phase 15's joint N/D net (the one of
    its alternating steps, at the weights they left) on its first batch,
    a single-card, a DP and a ZeRO step at
    world 1 (adam on the translator through the alternation, the embedder
    frozen, float32, cuDNN deterministic): losses, translator parameters and
    BatchNorm statistics 0.0 apart, the alternation's gathered state dict
    bit-equal to the single card's; then the DP step through the lab CLAHE
    chain, its three kernels launched inside the step and its first
    bucket's chain bit-equal to plain. Returns each step's launches."""
    import contextlib

    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.learning import train_step
    from mdir_tpu_torch.ops.preprocess import chain_from_transform

    t0 = time.perf_counter()
    network = joint["network"]
    start = joint_start(network)
    images, _ = joint["batch"]
    plain, lab_clahe = (chain_from_transform(initialize_transforms(
        transform, joint["mean_std"]))
        for transform in (PLAIN_TRANSFORM, CLAHE_TRANSFORM))
    launches, steps, chain_in = {}, {}, []
    make_chain = train_step.make_bucketed_chain

    def first_bucket(chain):
        fn = make_chain(chain)

        def recorded(batch, aux):
            if not chain_in:
                chain_in.append((batch.clone(),
                                 {k: v.clone() for k, v in aux.items()}))
            return fn(batch, aux)
        return recorded

    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for tag, chain, sharding, on in (
                ("joint_single_step", plain, None, None),
                ("joint_dp_step", plain, None, mesh),
                ("joint_zero_step", plain, "zero", mesh),
                ("joint_dp_clahe_step", lab_clahe, None, mesh)):
            pooling_kernel.reset_launches()
            lab_trilinear.reset_launches()
            clahe.reset_launches()
            t = time.perf_counter()
            with mock.patch.object(train_step, "make_bucketed_chain",
                                   first_bucket) if chain is lab_clahe \
                    else contextlib.nullcontext():
                steps[tag] = joint_step(network, start, joint["batch"],
                                        chain, joint_optimizer(), sharding,
                                        on)
            launches[tag] = kernel_counts(clahe, lab_trilinear,
                                          pooling_kernel)
            say("parallel", "%s (%d tuples of %d, %d px): loss %.6f, %.2f "
                "s, launches %s" % (tag, len(images), len(images[0]),
                                    JOINT_SIDE, steps[tag][0],
                                    time.perf_counter() - t, launches[tag]))
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    single = steps["joint_single_step"]
    for tag in ("joint_dp_step", "joint_zero_step"):
        loss, params, stats, _ = steps[tag]
        check(loss == single[0], (tag, "loss vs single card", loss,
                                  single[0]))
        for name, ref in list(single[1].items()) + list(single[2].items()):
            check(torch.equal((params if name in params else stats)[name],
                              ref), (tag, "vs single card", name))
    check(steps["joint_zero_step"][3].optimizers[0].mesh is mesh,
          "the alternation's translator optimizer sharded")
    check(equal_trees(steps["joint_zero_step"][3].state_dict(),
                      single[3].state_dict()),
          "the alternation's ZeRO state_dict vs the single card's")
    say("parallel", "joint N/D DP and ZeRO steps at world 1: losses, %d "
        "translator tensors and %d BatchNorm statistics 0.0 from the single "
        "card's; the alternation's gathered state_dict bit-equal"
        % (len(single[1]), len(single[2])))
    # the lab CLAHE DP step: its kernels ran in the step, its first bucket's
    # chain against plain
    loss, params, stats, _ = steps["joint_dp_clahe_step"]
    counted = launches["joint_dp_clahe_step"]
    check(all(counted[name] > 0 for name in
              ("lab_n", "clahe_tile_luts", "clahe_interp"))
          and counted["gem_l2n"] == 0,
          ("the chain kernels in the lab CLAHE step", counted))
    check(np.isfinite(loss) and all(torch.isfinite(v).all() for v in
                                    list(params.values())
                                    + list(stats.values())),
          ("lab CLAHE step finite", loss))
    check(len(chain_in) == 1, ("the recorded bucket", len(chain_in)))
    batch, aux = chain_in[0]
    grid = lab_clahe.clahe_params[1]
    check_equal(lab_trilinear.lab_n(batch), lab_trilinear.lab_n_plain(batch),
                ("lab_n", "joint step"))
    clahe_against_plain(clahe, lab_trilinear.lab_l_u8(batch), aux, grid,
                        ("joint step", tuple(batch.shape)))
    say("parallel", "lab CLAHE joint DP step: loss %.6f; its bucket %s: "
        "lab_n, clahe_tile_luts and clahe_interp bit-equal to plain; the "
        "whole-batch steps %.1f s" % (loss, tuple(batch.shape),
                                      time.perf_counter() - t0))
    return launches


def equal_trees(a, b):
    """Whether two nested dicts/lists of tensors and values are equal, the
    tensors bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            equal_trees(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape \
            and torch.equal(a, b.to(a.device))
    return a == b


def parallel_phase(device, db, queries, gnd, path, reference, joint, clahe,
                   lab_trilinear, pooling_kernel, gem_l2n_plain, smi):
    """Phase 17: several cards on ``torch.distributed``, at world 1 on
    NCCL (the one card): the validate stage's ``CirDatasetAp`` with
    ``parallel: {data: 1}`` on phase 7's net and images, sharded ranking,
    a single-card, a data-parallel and a ZeRO step from phase 9's weights
    on its batch (cuDNN deterministic, so that they compare bit for bit),
    the whole-batch steps of phase 15's joint N/D net on its batch
    (``whole_batch_steps``; ``joint`` is phase 15's), and
    ``dryrun_multicard(1, "cuda")`` in the same group. Returns the
    launches of its runs."""
    import shutil

    import torch.distributed as dist

    from mdir_tpu_torch import _build
    from mdir_tpu_torch.dryrun import dryrun_multicard
    from mdir_tpu_torch.ops.ranking import (compute_map, rank_database,
                                            rank_database_sharded)
    from mdir_tpu_torch.optim import scores
    from mdir_tpu_torch.parallel import extract
    from mdir_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    root = os.path.join(_build.BUILD_ROOT, "smoke", "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(root, "store"), 1), world_size=1, rank=0)
    mesh = make_mesh(1, device)
    check(mesh.collective and dist.get_backend() == "nccl",
          "a world of one on NCCL")
    mesh.all_reduce([torch.zeros(1, device=device)])  # NCCL's communicator
    torch.cuda.synchronize()
    say("parallel", "NCCL group of one and its communicator: %.2f s"
        % (time.perf_counter() - t))

    # 1. the validate stage's score over the mesh, phase 7's net
    names = {"db%02d" % i: img for i, img in enumerate(db)}
    names.update(("q%02d" % i, img) for i, img in enumerate(queries))
    PARALLEL_IMAGES.update(names)
    db_names = ["db%02d" % i for i in range(len(db))]
    with open(os.path.join(root, "db.pkl"), "wb") as handle:
        pickle.dump({"identifier": db_names}, handle)
    with open(os.path.join(root, "queries.pkl"), "wb") as handle:
        pickle.dump({"query": ["q%02d" % i for i in range(len(queries))],
                     "bbx": [None] * len(queries),
                     "ok": [[db_names[i] for i in g["ok"]] for g in gnd],
                     "junk": [[db_names[i] for i in g["junk"]]
                              for g in gnd]}, handle)
    network = path["network"]
    score = scores.initialize_score({
        "type": "cirdatasetap", "image_size": IMAGE_SIZE,
        "dataset": {"name": "smoke", "db": os.path.join(root, "db.pkl"),
                    "queries": os.path.join(root, "queries.pkl"),
                    "imgdir": root},
        "transforms": CLAHE_TRANSFORM,
        "mean_std": (network.model.meta["mean"], network.model.meta["std"]),
        "parallel": {"data": 1}, "loader": parallel_loader})
    out, ranked, chain_in, pool_in = [], [], [], []
    extract_fn, rank_fn = scores.extract_vectors_network, \
        scores.rank_database_sharded
    make_chain = extract.preprocess.make_bucketed_chain

    def recorded_extract(*args, **kwargs):
        out.append(extract_fn(*args, **kwargs))
        return out[-1]

    def recorded_rank(vecs, qvecs, on):
        ranked.append((vecs, qvecs, rank_fn(vecs, qvecs, on)))
        return ranked[-1][2]

    def first_chunk(chain_fn):
        def fn(batch, aux):
            if not chain_in:
                chain_in.append((batch.clone(),
                                 {k: v.clone() for k, v in aux.items()}))
            return chain_fn(batch, aux)
        return fn

    def recorded_pool(x, valid_hw, p, eps=1e-6):
        if not pool_in:
            pool_in.append((x.clone(), valid_hw.clone()))
        return pool_launch(x, valid_hw, p, eps=eps)

    pool_launch = pooling_kernel.gem_l2n
    torch.cuda.synchronize()
    pooling_kernel.reset_launches()
    lab_trilinear.reset_launches()
    clahe.reset_launches()
    t = time.perf_counter()
    with mock.patch.object(scores, "extract_vectors_network",
                           recorded_extract), \
            mock.patch.object(scores, "rank_database_sharded",
                              recorded_rank), \
            mock.patch.object(extract.preprocess, "make_bucketed_chain",
                              lambda chain: first_chunk(make_chain(chain))), \
            mock.patch.object(pooling_kernel, "gem_l2n", recorded_pool):
        averages = score(network)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {"validate": kernel_counts(clahe, lab_trilinear,
                                          pooling_kernel)}
    n_images = len(db) + len(queries)
    say("parallel", "CirDatasetAp, parallel {data: 1}, VGG16-GeM lab CLAHE: "
        "%d images %.2f s, %.1f images/s (phase 7: %.1f); launches %s"
        % (n_images, seconds, n_images / seconds, path["images_per_s"],
           launches["validate"]))
    # the score's descriptors against phase 7's, its ranks and mAP
    check(len(out) == 2 and len(ranked) == 1, ("recorded", len(out)))
    desc_err = max(float(np.abs(a - b).max())
                   for a, b in zip(out, path["out"]))
    check(desc_err <= 1e-6, ("sharded descriptors vs phase 7", desc_err))
    ranks = ranked[0][2].cpu().numpy()
    check((ranks[:10] == path["ranks"][:10]).all(),
          "top-10 ranks vs phase 7")
    phase7_map = compute_map(path["ranks"], gnd)[0]
    check(averages["map"] == phase7_map, ("mAP vs phase 7", averages,
                                          phase7_map))
    # phase 7's chunks (5 at its shapes): gem_l2n 15, each chain kernel 5
    check(launches["validate"] == path["launches"]
          and launches["validate"]["lab_n"] > 0,
          ("launches vs phase 7's", launches, path["launches"]))
    # 2. rank_database_sharded against rank_database on those descriptors
    vecs, qvecs, _ = ranked[0]
    check(torch.equal(rank_database_sharded(vecs, qvecs, mesh),
                      rank_database(vecs, qvecs)),
          "rank_database_sharded vs rank_database")
    say("parallel", "descriptors within %.2e of phase 7's, top-10 ranks and "
        "mAP %.4f equal; rank_database_sharded equal to rank_database"
        % (desc_err, averages["map"]))

    try:
        # 3. the four kernels at the pass's first chunk against plain
        batch, aux = chain_in[0]
        grid = tuple(path["grid"])
        check_equal(lab_trilinear.lab_n(batch),
                    lab_trilinear.lab_n_plain(batch), ("lab_n", "parallel"))
        clahe_against_plain(clahe, lab_trilinear.lab_l_u8(batch), aux, grid,
                            ("parallel", tuple(batch.shape)))
        x, valid = pool_in[0]
        pool_err = kernel_against_plain(pooling_kernel, gem_l2n_plain, x,
                                        valid)
        say("parallel", "first chunk %s: lab_n, clahe_tile_luts and "
            "clahe_interp bit-equal to plain; gem_l2n at its map %s within "
            "%.2e" % (tuple(batch.shape), tuple(x.shape), pool_err))

        # 4. a single-card, a DP and a ZeRO step at world 1 from phase 9's
        # weights on its batch, cuDNN deterministic (its backward is not
        # bit-reproducible otherwise)
        steps = {}
        cudnn = torch.backends.cudnn
        flags = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            for tag, runtime, on in (
                    ("single_step", None, None), ("dp_step", None, mesh),
                    ("zero_step", {"param_sharding": "zero"}, mesh)):
                pooling_kernel.reset_launches()
                lab_trilinear.reset_launches()
                clahe.reset_launches()
                t = time.perf_counter()
                steps[tag] = smoke_step(device, reference, runtime, on)
                launches[tag] = kernel_counts(clahe, lab_trilinear,
                                              pooling_kernel)
                say("parallel", "%s: loss %.6f, %.2f s, launches %s"
                    % (tag, steps[tag][0], time.perf_counter() - t,
                       launches[tag]))
        finally:
            cudnn.deterministic, cudnn.benchmark = flags
        check(steps["zero_step"][2].mesh is mesh, "ZeRO optimizer sharded")

        def gap(params, other):
            return max(float((params[k].detach() - other[k].detach())
                             .abs().max()) for k in other)

        for tag, against in (("dp_step", "single_step"),
                             ("zero_step", "dp_step"),
                             ("single_step", None)):
            loss, params, _ = steps[tag]
            if against is None:  # phase 9's own float32 step: printed
                ref_loss, ref_params = reference["loss"], reference["params"]
            else:
                ref_loss, ref_params = steps[against][:2]
            err = gap(params, ref_params)
            check(against is None or (abs(loss - ref_loss)
                                      <= 1e-6 * abs(ref_loss)
                                      and err <= 1e-6),
                  (tag, "vs", against, loss, ref_loss, err))
            say("parallel", "%s against the %s: loss %.6f vs %.6f, max "
                "|param diff| %.2e" % (tag, against or "phase 9 step (not "
                                       "deterministic; printed)", loss,
                                       ref_loss, err))
        states = {tag: steps[tag][2].state_dict()["torch_state"]
                  for tag in ("single_step", "zero_step")}
        single, zero = (states[tag]["state"] for tag in states)
        check(zero.keys() == single.keys()
              and states["zero_step"]["param_groups"]
              == states["single_step"]["param_groups"],
              "ZeRO state_dict's parameters and groups")
        for index, entry in single.items():
            check(zero[index].keys() == entry.keys(), ("keys", index))
            for key, value in entry.items():
                check(torch.equal(zero[index][key].to(value.device), value),
                      ("ZeRO state_dict vs single card", index, key))
        say("parallel", "ZeRO state_dict (gathered) equal to the single "
            "card's: %d parameters' moments and steps" % len(single))
        del steps
        joint_launches = whole_batch_steps(mesh, joint, clahe,
                                           lab_trilinear, pooling_kernel)
        launches.update(joint_launches)
        # 6. the dry run, sharing this process's group of one
        t = time.perf_counter()
        lines = dryrun_multicard(1, "cuda")
        losses = [float(m) for line in lines
                  for m in re.findall(r"loss (-?[0-9.]+|nan|inf)", line)]
        check(len(lines) == 4 and len(losses) == 3
              and all(np.isfinite(losses)), ("dry run", lines))
        say("parallel", "dryrun_multicard(1, 'cuda') in the group: %.2f s, "
            "losses %s" % (time.perf_counter() - t, losses))
    finally:
        dist.destroy_process_group()
        PARALLEL_IMAGES.clear()
    say("parallel", "phase 17: %.1f s | %s" % (time.perf_counter() - t_phase,
                                              smi))
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

    # 2. build. While nvcc runs, the main path's images and network are
    # made, the passes that need no kernel of the port run (the plain
    # pool's, which also warms cuDNN and the allocator for phase 4, and a
    # small input's on the CPU), and phase 9's images are made
    t = time.perf_counter()
    started = _build.start(_build.sources())
    try:
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
        transform = initialize_transforms(
            "pil2np | totensor | normalize",
            (model.meta["mean"], model.meta["std"]))

        def run_path():
            """Database and query descriptors, ranks; also the chunks."""
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

        def small_vecs(net):
            """Descriptors of two small crops through ``net``."""
            extractor = network_extractor(net, transform)
            for i, img in enumerate((db[0][:256, :192],
                                     queries[4][:192, :256])):
                extractor.add(i, img)
            return extractor.finish(2)

        with mock.patch.object(pooling_kernel, "gem_l2n", gem_l2n_plain):
            pvecs, pqvecs, pranks, _ = run_path()
        cpu_small = small_vecs(CirNetwork(
            initialize_model(MODEL, device="cpu", seed=SEED),
            CirNetwork.NetworkParams(
                model=dict(MODEL),
                runtime=dict(network.network_params.runtime)),
            frozen=True))
        train_images()  # phases 9 and 15
    except BaseException:
        _build.stop(started)
        raise
    built = _build.finish(started)
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

    # 4. the main path, on the kernel
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

    desc_err = max(np.abs(vecs - pvecs).max(), np.abs(qvecs - pqvecs).max())
    check(desc_err <= DESC_ATOL, ("descriptors vs plain pool", desc_err))
    check((ranks[:10] == pranks[:10]).all(), "top-10 ranks vs plain pool")
    say("main", "plain pool on the card: max |desc diff| %.2e, top-10 ranks "
        "equal" % desc_err)

    cross_err = np.abs(small_vecs(network) - cpu_small).max()
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
    # 13. the rest of the photometric chain and the host transforms
    photo_launches = photometric_phase(device, db, queries, path, clahe,
                                       lab_trilinear, pooling_kernel, smi)
    # 14. the rest of the eval stack: Rpool, RMAC, densenet, squeezenet
    whiten_1024 = os.path.join(whiten_dir, "whiten_1024_seed%d.pkl" % SEED)
    with open(whiten_1024 + ".tmp", "wb") as handle:
        pickle.dump({"P": np.eye(1024) + 0.01 * rng.randn(1024, 1024),
                     "m": 0.01 * rng.randn(1024, 1)}, handle)
    os.replace(whiten_1024 + ".tmp", whiten_1024)
    stack = eval_stack_phase(
        device, db, queries, gnd, {2048: whiten_path, 1024: whiten_1024,
                                   CLAHE_DIM: path["whiten_path"]},
        clahe, lab_trilinear, pooling_kernel, gem_l2n_plain, gen, smi)
    # 15. image-model training: the translator, and jointly with the
    # embedder
    image_train = image_train_phase(device, clahe, lab_trilinear,
                                    pooling_kernel, gem_l2n_plain, gen, smi)
    # 16. the branched retrieval net, the event tools on the card
    branched = branched_phase(device, db, queries, gnd, path["whiten_path"],
                              clahe, lab_trilinear, pooling_kernel,
                              gem_l2n_plain, gen, smi)
    # 17. several cards on torch.distributed, a world of one on NCCL
    parallel = parallel_phase(device, db, queries, gnd, path,
                              trained["bf16"]["first_step"],
                              image_train["joint_step"], clahe,
                              lab_trilinear, pooling_kernel, gem_l2n_plain,
                              smi)
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
        "max_abs_err": max([max_err, resnet_pool["max_abs_err"],
                            vgg_pool["max_abs_err"], trained["gem_err"],
                            unet_pool["max_abs_err"],
                            image_train["pool"]["max_abs_err"],
                            branched["pool"]["max_abs_err"]]
                           + [pool["max_abs_err"]
                              for pool in stack["pools"].values()]),
        **resnet_pool["timed"], "library_ms": None,
        "small_batch": resnet_pool["small_batch"],
        "clahe_path_launches": path["launches"]["gem_l2n"],
        "clahe_path": dict(vgg_pool["timed"],
                           small_batch=vgg_pool["small_batch"]),
        "composition_path_launches": composed["launches"],
        "composition_path": dict(unet_pool["timed"],
                                 small_batch=unet_pool["small_batch"]),
        "eval_stack_path": {tag: dict(pool["timed"],
                                      small_batch=pool["small_batch"])
                            for tag, pool in stack["pools"].items()},
        "image_train_path": dict(image_train["pool"]["timed"],
                                 small_batch=image_train["pool"][
                                     "small_batch"]),
        "branched_path": dict(branched["pool"]["timed"],
                              small_batch=branched["pool"]["small_batch"])}]
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
        entry["photometric_path_launches"] = {
            run: counted.get(entry["name"], 0)
            for run, counted in photo_launches.items()}
        entry["eval_stack_path_launches"] = {
            run: counted.get(entry["name"], 0)
            for run, counted in stack["launches"].items()}
        entry["branched_path_launches"] = branched["launches"].get(
            entry["name"], 0)
        entry["parallel_path_launches"] = {
            run: counted.get(entry["name"], 0)
            for run, counted in parallel.items()}
        entry["image_train_path_launches"] = {
            "translator": image_train["translator"][entry["name"]],
            "joint": image_train["joint"][entry["name"]],
            "loss_validation_rerun": {
                tag: n[entry["name"]]
                for tag, n in image_train["loss_validation"].items()}}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
