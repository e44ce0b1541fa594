#!/usr/bin/env python3
"""Times of the port's GeM+L2N, lab_n and CLAHE kernels on one NVIDIA card,
on inputs and launches that ``chip_smoke.py`` does not time.

    python3 kernel_times.py [--tree DIR]

``mdir_tpu_torch`` is imported from DIR (default: this file's directory),
so one run can time an older tree unpacked beside this one with the same
inputs. Times are those of ``chip_smoke.cuda_ms`` (CUDA events, the
mean of 100 launches queued behind a spin kernel):

  * lab_n at the CLAHE path's (16, 1024, 768, 3) chunk on two inputs made
    from a seed: smooth colour fields with noise (the kind of image
    ``chip_smoke.py`` makes) and uniform random RGB. Neighbouring pixels
    of near colours read the same entries of the kernel's corner table, so
    its time depends on the input's colour locality;
  * gem_l2n at GEM_SHAPES, whole valid extents, at p = 3 and p = 2.5;
  * where the tree's wrapper has ``launch_geometry`` (the clustered
    kernel): gem_l2n at every (blocks per image, threads per block) of
    SWEEP_CLUSTERS x SWEEP_THREADS at the same shapes, each launch held
    against the plain version first; the wrapper's own choice is starred;
  * clahe_tile_luts and clahe_interp at the CLAHE path's largest chunk
    (16 images of the path's first chunk extents in a (1024, 768) bucket,
    grid 8, clip 4) on three L planes made from a seed: the smooth fields'
    (``smooth_rgb`` through ``lab_l_u8``), uniform random values, and one
    constant value (every lane of a warp counts one bin). Where the tree
    has ``interp_geometry`` (the row-strip kernel): interp at every
    SWEEP_STRIP_ROWS, each launch held bit-equal to the plain version
    first, the wrapper's choice starred.

Each output is checked against its plain version. Prints one line per
reading, then the card's name and power limit. Needs a card.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (DB_SHAPES, cuda_ms, interp_bound_ms,
                        tile_luts_bound_ms)

LAB_SHAPE = (16, 1024, 768, 3)
# maps of the main paths (as chip_smoke.py lists them), for ResNet101
# (2048 channels) and VGG16 (512): the full 16-image chunk at scales 1 and
# 2^-1/2 (rows of 18 cells load as floats), and an 8-image chunk at scale 1
GEM_SHAPES = [(16, 2048, 32, 24), (16, 2048, 24, 18), (8, 2048, 24, 32),
              (16, 512, 64, 48), (16, 512, 48, 36), (8, 512, 48, 64)]
SWEEP_CLUSTERS = (4, 8, 16)
SWEEP_THREADS = (256, 512, 1024)
CLAHE_BUCKET, CLAHE_EXTENTS = (1024, 768), DB_SHAPES[:16]
CLAHE_GRID, CLAHE_CLIP = (8, 8), 4.0
SWEEP_STRIP_ROWS = (4, 8, 16, 32, 64)


def smooth_rgb(rng, shape):
    """Bilinear colour fields from 6 x 8 random nodes plus N(0, 8) noise."""
    import torch.nn.functional as F

    b, h, w, _ = shape
    fields = F.interpolate(
        torch.from_numpy(rng.rand(b, 3, 6, 8).astype(np.float32)),
        size=(h, w), mode="bilinear", align_corners=False).numpy()
    img = fields.transpose(0, 2, 3, 1) * 255 + rng.randn(*shape) * 8
    return np.clip(img, 0, 255).astype(np.uint8)


def time_lab_n(lab_trilinear, device, rng):
    inputs = {"smooth": smooth_rgb(rng, LAB_SHAPE),
              "random": rng.randint(0, 256, LAB_SHAPE).astype(np.uint8)}
    for name, array in inputs.items():
        rgb = torch.from_numpy(array).to(device)
        if not torch.equal(lab_trilinear.lab_n(rgb),
                           lab_trilinear.lab_n_plain(rgb)):
            raise RuntimeError("lab_n differs from plain on %s" % name)
        print("lab_n %s %s: %.4f ms" % (name, LAB_SHAPE,
                                        cuda_ms(lambda: lab_trilinear.lab_n(
                                            rgb))), flush=True)


def gem_inputs(shape, device, gen):
    x = torch.rand(shape, generator=gen).to(device)
    valid = torch.tensor([shape[2:]] * shape[0], dtype=torch.int32,
                         device=device)
    return x, valid


def time_gem(pooling_kernel, gem_l2n_plain, device, gen):
    for shape in GEM_SHAPES:
        x, valid = gem_inputs(shape, device, gen)
        times = []
        for value in (3.0, 2.5):
            p = torch.tensor([value], device=device)
            torch.testing.assert_close(pooling_kernel.gem_l2n(x, valid, p),
                                       gem_l2n_plain(x, valid, p),
                                       rtol=1e-5, atol=1e-6)
            times.append(cuda_ms(lambda: pooling_kernel.gem_l2n(x, valid,
                                                                p)))
        print("gem_l2n %s: %.4f ms at p = 3, %.4f ms at p = 2.5"
              % ((shape,) + tuple(times)), flush=True)


def sweep_gem(pooling_kernel, gem_l2n_plain, device, gen):
    fn = pooling_kernel._library()
    p = torch.tensor([3.0], device=device)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in GEM_SHAPES:
        n, c, h, w = shape
        x, valid = gem_inputs(shape, device, gen)
        ref = gem_l2n_plain(x, valid, p)
        chosen = pooling_kernel.launch_geometry(n, c, h, w)
        readings = []
        for cluster in SWEEP_CLUSTERS:
            group = -(-c // cluster)
            blocks = -(-c // group)
            for threads in SWEEP_THREADS:
                out = torch.empty((n, c), device=device)

                def launch():
                    return fn(x.data_ptr(), valid.data_ptr(), p.data_ptr(),
                              out.data_ptr(), n, c, h, w, blocks, group,
                              threads, chosen.load_bytes // 4, 1e-6, stream)

                star = "*" if (blocks, threads) == (chosen.cluster,
                                                   chosen.threads) else ""
                err = launch()
                if err != 0:  # a cluster the card cannot place
                    readings.append("c%d/t%d%s error %d" % (blocks, threads,
                                                            star, err))
                    continue
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
                readings.append("c%d/t%d%s %.4f" % (blocks, threads, star,
                                                    cuda_ms(launch)))
        print("gem_l2n sweep %s (blocks per image/threads, ms at p = 3): %s"
              % (shape, ", ".join(readings)), flush=True)


def l_planes(lab_trilinear, device, rng):
    """The three (16, 1024, 768) int32 L planes, zero outside each
    image's extent as the chain's buckets are."""
    shape = (len(CLAHE_EXTENTS),) + CLAHE_BUCKET
    rgb = torch.from_numpy(smooth_rgb(rng, shape + (3,))).to(device)
    planes = {"smooth": lab_trilinear.lab_l_u8(rgb),
              "random": torch.from_numpy(rng.randint(0, 256, shape).astype(
                  np.int32)).to(device),
              "constant": torch.full(shape, 128, dtype=torch.int32,
                                     device=device)}
    for vals in planes.values():
        for i, (h, w) in enumerate(CLAHE_EXTENTS):
            vals[i, h:] = 0
            vals[i, :, w:] = 0
    return planes


def time_clahe(clahe, planes, aux):
    for name, vals in planes.items():
        luts = clahe.tile_luts_bucketed_plain(vals, aux, CLAHE_GRID)
        if not torch.equal(clahe.clahe_tile_luts(vals, aux, CLAHE_GRID),
                           luts):
            raise RuntimeError("clahe_tile_luts differs from plain on %s"
                               % name)
        if not torch.equal(
                clahe.clahe_interp(vals, luts, aux, CLAHE_GRID),
                clahe.clahe_interp_bucketed_plain(vals, luts, aux,
                                                  CLAHE_GRID)):
            raise RuntimeError("clahe_interp differs from plain on %s" % name)
        lut_ms = cuda_ms(lambda: clahe.clahe_tile_luts(vals, aux, CLAHE_GRID))
        interp_ms = cuda_ms(lambda: clahe.clahe_interp(vals, luts, aux,
                                                       CLAHE_GRID))
        lut_bound = tile_luts_bound_ms(vals, aux, CLAHE_GRID)[0]
        interp_bound = interp_bound_ms(vals, CLAHE_GRID)[0]
        print("clahe %s %s: tile_luts %.4f ms (%.0f%% of bound %.4f ms), "
              "interp %.4f ms (%.0f%% of bound %.4f ms)"
              % (name, tuple(vals.shape), lut_ms, 100 * lut_bound / lut_ms,
                 lut_bound, interp_ms, 100 * interp_bound / interp_ms,
                 interp_bound), flush=True)


def sweep_interp(clahe, planes, aux):
    gh, gw = CLAHE_GRID
    stream = torch.cuda.current_stream().cuda_stream
    interp_fn = clahe._library("clahe_interp_i32")
    for name, vals in planes.items():
        b, bh, bw = vals.shape
        ref = clahe.tile_luts_bucketed_plain(vals, aux, CLAHE_GRID)
        ref_out = clahe.clahe_interp_bucketed_plain(vals, ref, aux,
                                                    CLAHE_GRID)
        chosen = clahe.interp_geometry(bh, bw, gh, gw)
        readings = []
        for rows in SWEEP_STRIP_ROWS:
            g = clahe.interp_geometry(bh, bw, gh, gw, strip_rows=rows)
            out = torch.empty_like(ref_out)

            def launch():
                return interp_fn(
                    vals.data_ptr(), ref.data_ptr(), aux["inv_th"].data_ptr(),
                    aux["inv_tw"].data_ptr(), out.data_ptr(), b, bh, bw, gh,
                    gw, g.vec, g.strip_rows, g.staged_rows, g.threads_x,
                    g.threads_y, stream)

            tag = "r%d%s" % (g.strip_rows, "*" if g == chosen else "")
            err = launch()
            if err != 0:
                readings.append("%s error %d" % (tag, err))
                continue
            if not torch.equal(out, ref_out):
                raise RuntimeError("interp %s differs from plain on %s"
                                   % (tag, name))
            readings.append("%s %.4f" % (tag, cuda_ms(launch)))
        print("clahe_interp sweep %s (rows per strip, ms): %s"
              % (name, ", ".join(readings)), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from mdir_tpu_torch.device import resolve_device
    from mdir_tpu_torch.ops import clahe, lab_trilinear, pooling_kernel
    from mdir_tpu_torch.ops.pooling import gem_l2n_plain

    device = resolve_device("cuda")
    print("tree %s" % os.path.abspath(args.tree), flush=True)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        time_lab_n(lab_trilinear, device, np.random.RandomState(0))
        time_gem(pooling_kernel, gem_l2n_plain, device, gen)
        if hasattr(pooling_kernel, "launch_geometry"):
            sweep_gem(pooling_kernel, gem_l2n_plain, device, gen)
        planes = l_planes(lab_trilinear, device, np.random.RandomState(0))
        aux = clahe.aux_to_device(clahe.clahe_bucket_aux(
            CLAHE_EXTENTS, CLAHE_BUCKET, CLAHE_CLIP, CLAHE_GRID), device)
        time_clahe(clahe, planes, aux)
        if hasattr(clahe, "interp_geometry"):
            sweep_interp(clahe, planes, aux)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip())


if __name__ == "__main__":
    main()
