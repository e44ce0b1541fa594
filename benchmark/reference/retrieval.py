"""Plain descriptors, ranking and mAP of cirtorch's evaluation.

``descriptor``: one image through the chain, then for each scale s the image
resized by ``F.interpolate(scale_factor=s, mode="bilinear",
align_corners=False)`` (cirtorch ``extract_ms``), the trunk, GeM
(``mean(clamp(x, 1e-6)^p)^(1/p)``) and L2; the scales aggregated as
``(mean of v^msp)^(1/msp)`` with msp = p, L2; then learned whitening
``P (v - m)`` and L2. ``dtype`` runs the trunk in a lower precision (the
control); the rest stays float32.

``rank_gaps``: how far a given ranking departs from the order of the scores
of the descriptors it ranked, recomputed here in float64. ``mean_ap``: the
old protocol's trapezoidal AP (cirtorch ``compute_ap``), junk left out.
"""
import numpy as np
import torch
import torch.nn.functional as F

from . import chain, nets

EPS = 1e-6


def gem_l2(x, p):
    """(1, C, h, w) -> (C,) GeM then L2."""
    v = x.clamp(min=EPS).pow(p).mean(dim=(2, 3)).pow(1.0 / p)[0]
    return v / (torch.linalg.vector_norm(v) + EPS)


@torch.no_grad()
def descriptor(rgb_u8, cfg, params, P, m, dtype=torch.float32):
    """(H, W, 3) uint8 tensor -> the (D,) float32 whitened descriptor.
    ``cfg`` is the configuration's ``reference`` section."""
    x = chain.run_chain(cfg["chain"], rgb_u8, cfg["mean"], cfg["std"],
                        **cfg.get("chain_args", {}))
    x = x.permute(2, 0, 1)[None].contiguous()
    arch, trunk = cfg["trunk"], cfg["trunk_cfg"]
    p = float(params["pool.p"][0])
    if dtype != torch.float32:
        params = {k: v.to(dtype) for k, v in params.items()}
    acc = 0.0
    for s in cfg["scales"]:
        xs = x if s == 1 else F.interpolate(
            x, scale_factor=s, mode="bilinear", align_corners=False)
        feats = nets.features(arch, trunk, params, xs.to(dtype))
        acc = acc + gem_l2(feats.to(torch.float32), p) ** p
    v = (acc / len(cfg["scales"])) ** (1.0 / p)
    v = v / torch.linalg.vector_norm(v)
    v = P @ (v - m)
    return v / (torch.linalg.vector_norm(v) + EPS)


def rank_gaps(vecs, qvecs, ranks):
    """(D, N) and (D, Q) descriptors and an (N, Q) ranking -> for each
    query the largest score by which an entry of the ranking lies below
    the score that the true order puts at its position (0 for a ranking
    by descending score, ties in any order), and whether each column is a
    permutation of the database."""
    scores = vecs.astype(np.float64).T @ qvecs.astype(np.float64)
    gaps, perms = [], []
    n = scores.shape[0]
    for q in range(scores.shape[1]):
        col = np.asarray(ranks[:, q], np.int64)
        perms.append(bool(np.array_equal(np.sort(col), np.arange(n))))
        ideal = -np.sort(-scores[:, q])
        given = scores[np.clip(col, 0, n - 1), q]
        gaps.append(float(np.max(ideal - given)))
    return np.asarray(gaps), perms


def average_precision(ranked, ok, junk):
    """cirtorch's ``compute_ap`` on one query's ranked database indices."""
    ok, junk = set(ok), set(junk)
    pos, k = [], 0
    for idx in ranked:
        if idx in junk:
            continue
        if idx in ok:
            pos.append(k)
        k += 1
    if not ok:
        return None
    ap, recall_step = 0.0, 1.0 / len(ok)
    for j, rank in enumerate(pos):
        precision_0 = 1.0 if rank == 0 else j / rank
        precision_1 = (j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def mean_ap(ranks, gnd):
    """The old protocol's mAP over the queries that have positives."""
    aps = [average_precision(ranks[:, q], g["ok"], g.get("junk", []))
           for q, g in enumerate(gnd)]
    aps = [a for a in aps if a is not None]
    return float(np.mean(aps)) if aps else 0.0
