"""Whether the window's passes produced what the plain reference gives.

Every pass of the window is judged:

* ``desc_gap``: a sample of the pass's images, drawn from the seed, is
  described by the reference (``reference/retrieval.py``: the chain, each
  scale resized by ``F.interpolate``, the trunk at the image's own size,
  GeM, the multi-scale aggregation and the whitening), from the same
  pixels, weights and whitening the program was given; the number is the
  largest absolute difference of a descriptor entry (descriptors have unit
  norm) over the sample and the passes.
* ``rank_gap``: the ranking stage, followed from the program's own
  descriptors (the stage before it is judged by ``desc_gap``): the largest
  score by which an entry lies below the one the true order puts at its
  place, scores recomputed in float64.
* ``bad_rankings``: columns of the ranking that are no permutation of the
  database.
* ``map_gap``: the program's mAP against the reference's mAP of the
  program's ranking.
* ``nonfinite``: descriptors with a NaN or an infinity.

A number at or below its limit (the configuration's ``limits``) passes.
``control`` puts the reference in a lower precision in the program's place
and judges its numbers by the same limits, for the check that they fail
it.
"""
import numpy as np
import torch

from harness.runner import compare
from reference import retrieval


def sample(traffic, seed, n_db, n_q):
    """(database indices, query indices) of the sample drawn from the
    seed."""
    rng = np.random.default_rng([seed, 1])
    n = len(traffic["database"])
    q = len(traffic["queries"])
    return (sorted(rng.choice(n, min(n_db, n), replace=False).tolist()),
            sorted(rng.choice(q, min(n_q, q), replace=False).tolist()))


def served(traffic, pixels, kind, index):
    """The uint8 pixels the score serves for an image: a query cut to its
    box."""
    if kind == "db":
        return pixels[traffic["database"][index]["name"]]
    spec = traffic["queries"][index]
    x0, y0, x1, y1 = spec["bbx"]
    return pixels[spec["name"]][y0:y1, x0:x1]


def reference_vectors(traffic, pixels, picks, params, P, m, ref, device,
                      dtype=torch.float32):
    """{(kind, index): reference descriptor (numpy)} of the picked images."""
    out = {}
    for kind, indices in zip(("db", "q"), picks):
        for i in indices:
            img = torch.from_numpy(np.ascontiguousarray(
                served(traffic, pixels, kind, i))).to(device)
            out[kind, i] = retrieval.descriptor(img, ref, params, P, m,
                                                dtype).cpu().numpy()
    return out


def judge(results, traffic, pixels, params, P, m, ref, limits, seed, device):
    """The comparison of every pass; returns ``correct``, ``failed`` and
    ``compared`` {name: (value, limit)}."""
    picks = sample(traffic, seed, ref["sample_db"], ref["sample_queries"])
    expected = reference_vectors(traffic, pixels, picks, params, P, m, ref,
                                 device)
    desc_gap = rank_gap = map_gap = 0.0
    bad_rankings = nonfinite = 0
    failed = 0
    for res in results:
        nonfinite += int((~np.isfinite(res["vecs"])).any(0).sum()
                         + (~np.isfinite(res["qvecs"])).any(0).sum())
        for (kind, i), vec in expected.items():
            got = (res["vecs"] if kind == "db" else res["qvecs"])[:, i]
            gap = float(np.max(np.abs(got - vec)))
            if not gap <= limits["desc_gap"]:
                failed += 1
            desc_gap = max(desc_gap, gap) if np.isfinite(gap) else np.inf
        gaps, perms = retrieval.rank_gaps(res["vecs"], res["qvecs"],
                                          res["ranks"])
        rank_gap = max(rank_gap, float(np.max(gaps)))
        bad_rankings += perms.count(False)
        failed += int(np.sum(~(gaps <= limits["rank_gap"]))) \
            + perms.count(False)
        ranks = np.clip(res["ranks"], 0, res["vecs"].shape[1] - 1)
        gap = abs(float(res["map"]) - retrieval.mean_ap(ranks,
                                                        traffic["gnd"]))
        failed += int(not gap <= limits["map_gap"])
        map_gap = max(map_gap, gap)
    compared = {"desc_gap": (desc_gap, limits["desc_gap"]),
                "rank_gap": (rank_gap, limits["rank_gap"]),
                "map_gap": (map_gap, limits["map_gap"]),
                "bad_rankings": (bad_rankings, 0),
                "nonfinite": (nonfinite, 0)}
    correct = bool(results) and all(v <= lim
                                    for v, lim in compared.values())
    return {"correct": correct, "failed": failed + nonfinite,
            "compared": compared}


def control_numbers(inputs):
    """The control's readings of a run's inputs, by number: ``desc_gap`` of
    the reference with its trunk in bfloat16, put in the program's place,
    against the float32 reference."""
    args = [inputs[k] for k in ("traffic", "pixels")]
    picks = sample(inputs["traffic"], inputs["seed"],
                   inputs["ref"]["sample_db"], inputs["ref"]["sample_queries"])
    exact, low = (reference_vectors(
        *args, picks, inputs["params"], inputs["P"], inputs["m"],
        inputs["ref"], inputs["device"], dtype)
        for dtype in (torch.float32, torch.bfloat16))
    return {"desc_gap": max(float(np.max(np.abs(exact[k] - low[k])))
                            for k in exact)}


def control(inputs):
    """The control judged by the run's limits: ``correct`` has to come out
    false."""
    return compare(control_numbers(inputs), inputs["limits"])
