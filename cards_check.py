#!/usr/bin/env python3
"""The port's sharded paths on several NVIDIA cards of one host against one
card: one process per card in an NCCL group (``parallel/mesh.py::launch``).

    python3 cards_check.py [--cards N]     # default: every visible card

Every rank builds ``chip_smoke.py``'s phase-7 net (VGG16-GeM, the lab CLAHE
chain, random weights from its seed, scales 1, 2^-1/2, 1/2, image size
1024) and images (32 database and 8 query images made from its seed), and:

  * extracts them with each chunk sharded over the N cards (a warm pass,
    then a timed one), against the same extraction on rank 0's card alone
    (largest descriptor difference, the top-10 ranks, images/s of each);
  * ranks them with ``rank_database_sharded`` against ``rank_database``;
  * takes one adam step (lr 1e-6, ``chip_smoke.smoke_step``) of the same
    net on 2 N tuples of 7 images at up to 1024 px (phase 9's training
    images), single-card on rank 0, data-parallel and ZeRO on the N cards,
    cuDNN deterministic: the loss gap, the largest parameter difference
    and s/step of each;
  * takes one step of phase 15's joint N/D net (the P2pUNet translator at
    nested 7, live BatchNorm, then the frozen VGG16-GeM; random weights
    from its seed; ``chip_smoke.joint_step``) on JOINT_TUPLES tuples of 7
    square 512 px crops of those images (28 images: on 4 cards 7 a card,
    so tuples are cut across cards), single-card on rank 0, data-parallel
    and ZeRO on the N cards, cuDNN deterministic, sgd with momentum on the
    translator through the optimizer alternation (JOINT_SGD). Gate: the
    loss, the translator's parameters and its BatchNorm running
    statistics within JOINT_RTOL relative of the single-card step (the
    largest difference over the largest value of the translator's
    parameters, of its statistics); the step's own largest update on the
    same scale beside them, and s/step of each;
  * runs ``dryrun_multicard(N, "cuda")`` in the group.

Rank 0 prints one line per reading, one JSON line of the readings and the
card's name and power limit. Needs N >= 1 cards; fails without one, or
when a gate fails.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TUPLES_PER_CARD = 2  # the steps' batch: this many tuples a card
JOINT_TUPLES = 4  # the joint step's batch: 28 images
JOINT_RTOL = 1e-6  # N cards against one: loss, translator, statistics
# the joint step's optimizer: sgd, whose update is linear in the gradient,
# so that the gradients' summation order on N cards moves the parameters
# by lr times its rounding, while a wrong scale of the summed gradient
# moves them by about the update (1.0e-4-2.4e-4 of the largest weight at
# lr 1e-4 on a cut net at 2 CPU ranks, where the rounding moved them
# 3.6e-9-3.9e-8). Adam's first step, lr * g / (|g| + 1e-8), turns the
# rounding of a gradient within 1e-8 of 0 (behind the frozen random
# embedder) into a whole step of lr. A tensor that starts at 0 (a
# BatchNorm bias) holds only its update, so the gaps are measured against
# the largest value of the group
JOINT_SGD = {"composition": {"type": "alternation",
                             "alternate_iteration": None, "order": None},
             "translate": {"algorithm": "sgd", "lr": 1e-4, "momentum": 0.9,
                           "weight_decay": 0},
             "embed": None}


def relative_gap(ours, ref):
    """The largest |ours - ref| over the tensors of two dicts, over the
    largest |ref| of them."""
    gap = max(float((ours[k].double() - v.double()).abs().max())
              for k, v in ref.items())
    return gap / max(float(v.abs().max()) for v in ref.values())


def _tuples(cs, n):
    """n (query, positive, 5 negatives) tuples of phase 9's images, each
    image of another cluster than the others of its tuple."""
    names = sorted(cs.train_images())
    clusters = len(names) // 2
    tuples = []
    for k in range(n):
        picks = [names[2 * (k % clusters)], names[2 * (k % clusters) + 1]]
        picks += [names[2 * ((k + 1 + j) % clusters)] for j in range(5)]
        tuples.append([cs.TRAIN_IMAGES[name] for name in picks])
    targets = [np.array([-1, 1, 0, 0, 0, 0, 0], np.float32)] * n
    return tuples, targets


def _joint_steps(cs, device, mesh, readings, lines):
    """The joint N/D step single-card on rank 0, DP and ZeRO on the cards
    (cuDNN deterministic): each against the single card, gated."""
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.learning.network import initialize_network
    from mdir_tpu_torch.ops.preprocess import chain_from_transform

    lead = mesh.rank == 0
    tuples, targets = _tuples(cs, JOINT_TUPLES)
    batch = ([[np.ascontiguousarray(img[:cs.JOINT_SIDE, :cs.JOINT_SIDE])
               for img in tpl] for tpl in tuples], targets)
    params = cs.joint_scenario("", "", 1)["network"]
    state = initialize_network(params, "cpu").state_dict()
    network = initialize_network(None, device, state)
    start = cs.joint_start(network)
    chain = chain_from_transform(initialize_transforms(
        cs.PLAIN_TRANSFORM, cs.UNET_DATA["mean_std"]))
    steps = {}
    for tag, sharding, on in (("joint_single", None, None),
                              ("joint_dp", None, mesh),
                              ("joint_zero", "zero", mesh)):
        if on is None and not lead:
            continue
        cs.joint_step(network, start, batch, chain, JOINT_SGD, sharding,
                      on)  # warm
        t = time.perf_counter()
        steps[tag] = cs.joint_step(network, start, batch, chain, JOINT_SGD,
                                   sharding, on)
        readings["%s_s_per_step" % tag] = time.perf_counter() - t
    if not lead:
        return
    ref_loss, ref_params, ref_stats, _ = steps["joint_single"]
    start_params = {k: start["translate"][k] for k in ref_params}
    readings["joint_update_rel"] = relative_gap(ref_params, start_params)
    for tag in ("joint_dp", "joint_zero"):
        loss, params_, stats, _ = steps[tag]
        reading = {"loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                   "translator_rel": relative_gap(params_, ref_params),
                   "batchnorm_rel": relative_gap(stats, ref_stats)}
        readings["%s_vs_single" % tag] = reading
        lines.append(
            "%s step (%d tuples of 7 at %d px, %d images a card) against "
            "the single card: loss %.6f vs %.6f, relative gaps %s (the "
            "update %.2e); %.3f s against %.3f s"
            % (tag, JOINT_TUPLES, cs.JOINT_SIDE,
               7 * JOINT_TUPLES // mesh.size, loss, ref_loss, reading,
               readings["joint_update_rel"],
               readings["%s_s_per_step" % tag],
               readings["joint_single_s_per_step"]))
        cs.check(max(reading.values()) <= JOINT_RTOL,
                 (tag, "vs single card", reading))


def check_rank(*, device):
    """One rank of the check; rank 0 returns its readings. A step's
    seconds include building its net from the state."""
    import torch.distributed as dist

    import chip_smoke as cs
    from mdir_tpu_torch.data.transforms import initialize_transforms
    from mdir_tpu_torch.dryrun import dryrun_multicard
    from mdir_tpu_torch.learning.network import CirNetwork
    from mdir_tpu_torch.models import initialize_model
    from mdir_tpu_torch.ops.preprocess import chain_from_transform
    from mdir_tpu_torch.ops.ranking import (rank_database,
                                            rank_database_sharded)
    from mdir_tpu_torch.parallel.extract import extract_vectors_network
    from mdir_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dist.get_world_size(), device)
    n, lead = mesh.size, mesh.rank == 0
    readings, lines = {"cards": n}, []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    db, queries, _ = cs.make_images(np.random.RandomState(cs.SEED))
    model = initialize_model(cs.CLAHE_MODEL, device=device, seed=cs.SEED)
    params = CirNetwork.NetworkParams(model=dict(cs.CLAHE_MODEL), runtime={
        "wrappers": {"train": None, "eval": {
            "1_cirmultiscale": {"scales": cs.SCALES}}},
        **cs.FLOAT32_RUNTIME})
    network = CirNetwork(model, params, frozen=True)
    transform = initialize_transforms(cs.CLAHE_TRANSFORM, (
        model.meta["mean"], model.meta["std"]))

    def extract(on):
        """Database and query descriptors; the pass's seconds."""
        sync()
        t = time.perf_counter()
        out = [extract_vectors_network(network, images, cs.IMAGE_SIZE,
                                       transform, mesh=on)
               for images in (db, queries)]
        sync()
        return out, time.perf_counter() - t

    images = len(db) + len(queries)
    extract(mesh)  # warm: cuDNN plans at a rank's rows
    sharded, seconds = extract(mesh)
    readings["sharded_images_per_s"] = images / seconds
    ranks = rank_database_sharded(*(torch.from_numpy(v).to(device)
                                    for v in sharded), mesh)
    if lead:
        extract(None)
        single, seconds = extract(None)
        readings["single_images_per_s"] = images / seconds
        err = max(float(np.abs(a - b).max()) for a, b in zip(sharded, single))
        single_ranks = rank_database(*(torch.from_numpy(v).to(device)
                                       for v in single))
        readings["descriptor_diff"] = err
        readings["top10_equal"] = bool(torch.equal(ranks[:10],
                                                   single_ranks[:10]))
        lines.append(
            "extraction of %d images, chunks sharded over %d cards: %.1f "
            "images/s; one card %.1f images/s; max |desc diff| %.2e, "
            "top-10 ranks %s" % (images, n, readings["sharded_images_per_s"],
                                 readings["single_images_per_s"], err,
                                 "equal" if readings["top10_equal"]
                                 else "DIFFER"))
    own = rank_database(*(torch.from_numpy(v).to(device) for v in sharded))
    readings["sharded_ranks_equal"] = bool(torch.equal(ranks, own))
    mesh.all_reduce([torch.zeros(1, device=device)])  # rank 0 caught up

    # one adam step: single card on rank 0, then DP and ZeRO on the cards
    tuples, targets = _tuples(cs, n * TUPLES_PER_CARD)
    train_params = CirNetwork.NetworkParams(
        model=dict(cs.CLAHE_MODEL), runtime=dict(cs.FLOAT32_RUNTIME))
    reference = {"state": CirNetwork(model, train_params).state_dict(),
                 "images": tuples, "targets": targets,
                 "chain": chain_from_transform(transform)}
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    steps = {}
    for tag, runtime, on in (("single", None, None), ("dp", None, mesh),
                             ("zero", {"param_sharding": "zero"}, mesh)):
        if on is None and not lead:
            continue
        cs.smoke_step(device, reference, runtime, on)  # warm
        t = time.perf_counter()
        steps[tag] = cs.smoke_step(device, reference, runtime, on)
        readings["%s_s_per_step" % tag] = time.perf_counter() - t
    if lead:
        for tag, against in (("dp", "single"), ("zero", "dp")):
            loss, params_, _ = steps[tag]
            ref_loss, ref_params, _ = steps[against]
            gap = max(float((params_[k].detach() - ref_params[k].detach())
                            .abs().max()) for k in ref_params)
            readings["%s_vs_%s" % (tag, against)] = {
                "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                "param_diff": gap}
            lines.append(
                "%s step (%d tuples, %d a card) against the %s step: loss "
                "%.6f vs %.6f, max |param diff| %.2e; %.3f s against %.3f s"
                % (tag, len(tuples), len(tuples) // n, against, loss,
                   ref_loss, gap, readings["%s_s_per_step" % tag],
                   readings["%s_s_per_step" % against]))
    steps.clear()
    _joint_steps(cs, device, mesh, readings, lines)
    cudnn.deterministic, cudnn.benchmark = False, False
    t = time.perf_counter()
    dryrun_multicard(n, device.type)  # rank 0 prints its lines
    readings["dryrun_s"] = time.perf_counter() - t
    return {"lines": lines, "readings": readings} if lead else None


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cards_check: no CUDA device; it runs on cards")
    from mdir_tpu_torch import _build
    from mdir_tpu_torch.parallel.mesh import launch

    n = args.cards or torch.cuda.device_count()
    _build.build(_build.sources())  # once, before the ranks load them
    t = time.perf_counter()
    result = launch(check_rank, n, "cuda", timeout=1500)[0]
    for line in result["lines"]:
        print(line)
    readings = dict(result["readings"], seconds=time.perf_counter() - t)
    print(json.dumps(readings))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
