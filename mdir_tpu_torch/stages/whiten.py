"""Whitening stages: apply, learn Lw (with subset retry), learn PCA, paste --
``mdir_tpu/stages/whiten.py`` on the port.

Each stage is ``stage(params, data) -> (metadata, *outputs)`` with the JAX
package's metadata keys. Learning runs on the host in float64; when the
difference covariance is not positive definite, Lw retries on random query
subsets that shrink linearly toward 5 % of the pairs, drawn from numpy's
global RNG in the JAX package's order. ``whiten`` applies a learned
whitening on ``device`` (the card by default) in float32, as the JAX
package applies it on its device.
"""
import contextlib
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.whitening import pcawhitenlearn, whitenapply, whitenlearn
from ..tools import stats

LW_MAX_TRIALS = 100
LW_MAX_EXCLUDED = 0.95


@contextlib.contextmanager
def _timed(metadata, timing_key):
    """Fill ``metadata`` with {timings: {key}, resource_usage} around a block."""
    resources = stats.ResourceUsage()
    start = time.time()
    yield
    metadata["timings"] = {timing_key: round(time.time() - start, 2)}
    metadata["resource_usage"] = \
        resources.take_current_stats().get_resources()


def whiten(params, data, device="cuda"):
    """Apply pre-computed whitening to (N, D) rows on ``device``."""
    dimensions = params.pop("dimensions", None) or None
    if params:
        raise ValueError("unknown whiten keys: %s" % sorted(params))
    whitening, names, values = data
    if len(names) != len(values):
        raise ValueError("%d names for %d rows" % (len(names), len(values)))
    device = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    metadata = {}
    with _timed(metadata, "whitening_apply"):
        whitened = whitenapply(tensor(values).T, tensor(whitening["m"]),
                               tensor(whitening["P"]), dimensions)
        whitened = whitened.T.cpu().numpy()
    return metadata, names, whitened


def _lw_subset(qidxs, pidxs, trial):
    """Query/positive pairs for one Lw attempt: everything on trial 0, then
    random subsets shrinking linearly toward (1 - LW_MAX_EXCLUDED)."""
    if trial == 0:
        return qidxs, pidxs
    keep = int(len(qidxs) * (1 - trial / LW_MAX_TRIALS * LW_MAX_EXCLUDED))
    picked = np.random.permutation(len(qidxs))[:keep]
    print("Using subset of queries (%s/%s) trial %s"
          % (len(picked), len(qidxs), trial), file=sys.stderr)
    return qidxs[picked], pidxs[picked]


def learn_lw_whitening(params, data):
    """Learn Lw whitening, retrying on subsets when not positive definite."""
    if params:
        raise ValueError("learn_lw_whitening takes no params: %s"
                         % sorted(params))
    names, values, queries, positives = data
    if len(names) != len(values) or len(queries) != len(positives):
        raise ValueError("%d names for %d rows, %d queries for %d positives"
                         % (len(names), len(values), len(queries),
                            len(positives)))

    values = values.astype(np.float64).T
    name_index = {x: i for i, x in enumerate(names)}
    qidxs = np.array([name_index[x] for x in queries])
    pidxs = np.array([name_index[x] for x in positives])

    metadata = {}
    with _timed(metadata, "whitening_learn"):
        for trial in range(LW_MAX_TRIALS):
            qwhit, pwhit = _lw_subset(qidxs, pidxs, trial)
            try:
                whit_m, whit_p = whitenlearn(values, qwhit, pwhit)
                break
            except np.linalg.LinAlgError as exc:
                if "positive definite" not in str(exc) \
                        or trial >= LW_MAX_TRIALS - 1:
                    raise

    metadata["stats"] = {
        "failed_times": trial,
        "vectors_used": round(len(qwhit) / float(len(qidxs)), 2),
        "vectors_total": len(qidxs),
    }
    return metadata, {"m": whit_m, "P": whit_p}


def learn_pca_whitening(params, data):
    """Learn PCA whitening of (N, D) rows."""
    shrink = params.pop("shrink", None) or None
    if params:
        raise ValueError("unknown learn_pca_whitening keys: %s"
                         % sorted(params))
    values, = data

    metadata = {}
    with _timed(metadata, "whitening_learn"):
        whit_m, whit_p = pcawhitenlearn(values.astype(np.float64).T, shrink)
    return metadata, {"m": whit_m, "P": whit_p}


def _pca_project(value, dimensions):
    """Project onto the top eigenvectors of the (centered) gram matrix."""
    centered = value - np.mean(value)
    eigval, eigvec = np.linalg.eig(centered.T.dot(centered))
    top = eigvec[:, np.argsort(eigval)[-dimensions:]]
    return centered.dot(top.dot(top.T))


def paste_pca_normalize(params, data):
    """Concatenate vectors horizontally, optional PCA reduction, L2 normalize."""
    dimensions = params.pop("dimensions") or None
    if params:
        raise ValueError("unknown paste_pca_normalize keys: %s"
                         % sorted(params))
    if len(set(len(x) for x in data)) != 1:
        raise ValueError("the pasted matrices have different row counts")

    if data[0].shape == (0,):
        return {}, data[0]

    value = np.concatenate(data, axis=1)
    metadata = {}
    if dimensions:
        with _timed(metadata, "pca_compute"):
            value = _pca_project(value, dimensions)

    value = value / np.expand_dims(np.linalg.norm(value, axis=1), axis=1)
    return metadata, value
