"""Database ranking (one matrix product and a sort on the device) and the
junk-aware mAP of cirtorch ``evaluate.py``.

The mAP follows ``mdir_tpu/ops/ranking.py``: trapezoidal AP over positive
positions with junk entries removed by rank shifting, queries without
positives left out of the mean, the revisited E/M/H regrouping for
roxford5k/rparis6k, and precision@k, written as cumulative sums in numpy.
Over several cards the database's columns are split between the ranks
(``rank_database_sharded``).
"""
import numpy as np
import torch


def rank_database(vecs, qvecs):
    """vecs: (D, N) database, qvecs: (D, Q) queries -> ranks (N, Q).

    Column q lists the database indices by descending score (a stable sort,
    so ties keep index order as ``np.argsort(-scores, kind="stable")``).
    """
    scores = vecs.T @ qvecs
    return torch.argsort(-scores, dim=0, stable=True)


def rank_database_sharded(vecs, qvecs, mesh):
    """``rank_database`` with the database split over a mesh's ranks (JAX
    ``rank_database_sharded``): the (D, N) columns padded with NaN columns
    to a multiple of the world size, each rank scoring its contiguous
    share (NaN scores as -inf, so the padding ranks last), the scores
    gathered on every rank, one stable sort there, the padding's rows
    dropped. Every rank returns the (N, Q) ranks."""
    n = vecs.shape[1]
    pad = -n % mesh.size
    if pad:
        vecs = torch.cat([vecs, vecs.new_full((vecs.shape[0], pad),
                                              float("nan"))], dim=1)
    scores = vecs[:, mesh.rows(n + pad)].T @ qvecs
    scores = torch.where(torch.isnan(scores), float("-inf"), scores)
    scores = mesh.all_gather_rows(scores)
    return torch.argsort(-scores, dim=0, stable=True)[:n]


def _ap_from_masks(is_pos, is_junk, nres):
    """Trapezoidal AP of one query from rank-position masks."""
    n = is_pos.shape[0]
    junk_before = np.cumsum(is_junk) - is_junk  # exclusive cumsum
    adj = np.arange(n) - junk_before  # junk-shifted 0-based rank
    order = np.cumsum(is_pos) - 1  # 0-based index among positives
    prec0 = np.where(adj == 0, 1.0, order / np.maximum(adj, 1))
    prec1 = (order + 1) / (adj + 1)
    contrib = np.where(is_pos, (prec0 + prec1) / 2.0, 0.0)
    return contrib.sum() / nres


def _precision_at_k(is_pos, is_junk, kappas):
    """Precision@k on junk-shifted 1-based positions."""
    n = is_pos.shape[0]
    junk_before = np.cumsum(is_junk) - is_junk
    pos1 = np.arange(n) - junk_before + 1
    max_pos = np.max(np.where(is_pos, pos1, 0))
    prs = []
    for kappa in kappas:
        kq = np.minimum(max_pos, kappa)
        prs.append(np.sum(is_pos & (pos1 <= kq)) / np.maximum(kq, 1))
    return np.stack(prs) if prs else np.zeros((0,))


def compute_map(ranks, gnd, kappas=()):
    """mAP over queries with junk handling.

    ranks: (db_size, nq) integer array; gnd: list of dicts with 'ok' and
    optional 'junk' arrays of db indices. Returns (map, aps, pr, prs).
    """
    ranks = np.asarray(ranks)
    db_size, nq = ranks.shape
    aps = np.full(nq, np.nan)
    prs = np.full((nq, len(kappas)), np.nan)
    nempty = 0

    for i in range(nq):
        ok = np.asarray(gnd[i]["ok"], dtype=np.int64).ravel()
        if ok.size == 0:
            nempty += 1
            continue
        junk = np.asarray(gnd[i].get("junk", []), dtype=np.int64).ravel()
        ok_mask = np.zeros(db_size, dtype=bool)
        ok_mask[ok] = True
        junk_mask = np.zeros(db_size, dtype=bool)
        if junk.size:
            junk_mask[junk] = True
        is_pos = ok_mask[ranks[:, i]]
        is_junk = junk_mask[ranks[:, i]]
        aps[i] = _ap_from_masks(is_pos, is_junk, ok.size)
        if kappas:
            prs[i] = _precision_at_k(is_pos, is_junk, list(kappas))

    denom = max(nq - nempty, 1)
    mean_ap = np.nansum(aps) / denom if nq > nempty else 0.0
    pr = np.nansum(prs, axis=0) / denom if kappas else np.zeros(0)
    return mean_ap, aps, pr, prs


def compute_map_and_print(dataset, ranks, gnd, kappas=(1, 5, 10),
                          printer=print):
    """Old ('ok') or revisited (E/M/H) protocol, by the ground truth's keys."""
    if "ok" in gnd[0]:
        mean_ap, aps, _, _ = compute_map(ranks, gnd)
        printer(">> {}: mAP {:.2f}".format(dataset,
                                           np.around(mean_ap * 100, 2)))
        return {"map": mean_ap}, {"ap": aps}

    if dataset.startswith("roxford5k") or dataset.startswith("rparis6k"):
        def regroup(ok_keys, junk_keys):
            return [{"ok": np.concatenate([np.asarray(g[k]).ravel()
                                           for k in ok_keys]),
                     "junk": np.concatenate([np.asarray(g[k]).ravel()
                                             for k in junk_keys])}
                    for g in gnd]

        map_e, aps_e, pr_e, _ = compute_map(
            ranks, regroup(["easy"], ["junk", "hard"]), kappas)
        map_m, aps_m, pr_m, _ = compute_map(
            ranks, regroup(["easy", "hard"], ["junk"]), kappas)
        map_h, aps_h, pr_h, _ = compute_map(
            ranks, regroup(["hard"], ["junk", "easy"]), kappas)

        printer(">> {}: mAP E: {}, M: {}, H: {}".format(
            dataset, np.around(map_e * 100, 2), np.around(map_m * 100, 2),
            np.around(map_h * 100, 2)))
        printer(">> {}: mP@k{} E: {}, M: {}, H: {}".format(
            dataset, list(kappas), np.around(pr_e * 100, 2),
            np.around(pr_m * 100, 2), np.around(pr_h * 100, 2)))
        return ({"map_easy": map_e, "map_medium": map_m, "map_hard": map_h},
                {"ap_easy": aps_e, "ap_medium": aps_m, "ap_hard": aps_h})

    raise ValueError("Unknown evaluation protocol for dataset %s" % dataset)
