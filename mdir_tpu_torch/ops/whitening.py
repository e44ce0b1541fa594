"""Descriptor whitening, cirtorch ``whiten.py`` semantics: apply on the
device (torch), learn on the host (float64 numpy).

Descriptors are D x N column matrices: ``whitenapply`` projects
P[:dims] (X - m) and L2-normalises the columns with eps 1e-6. The product
runs in full float32 (``device.resolve_device`` turns TF32 off), as the
JAX package computes it at ``Precision.HIGHEST``. ``whitenlearn`` (Lw)
whitens by the covariance of query - positive difference vectors (the
inverse of its Cholesky factor), then rotates by the eigenbasis of the
projected data; ``pcawhitenlearn`` is PCA whitening with optional Arun
shrinkage. Learning returns numpy ``(m, P)``, a whitening pkl's contents
(``models.load_whitening_pkl``), as ``mdir_tpu/ops/whitening.py`` learns
them.
"""
import numpy as np
import torch


def whitenapply(X, m, P, dimensions=None):
    """Whiten D x N columns: P[:dims] (X - m), then column L2 norm (+1e-6)."""
    if not dimensions:
        dimensions = P.shape[0]
    X = P[:dimensions, :] @ (X - m.reshape(-1, 1))
    norms = torch.linalg.vector_norm(X, 2, dim=0, keepdim=True)
    return X / (norms + 1e-6)


def whitenapply_rows(vecs, m, P, dimensions=None):
    """Row-major convenience: (N, D) in, (N, dims) out."""
    return whitenapply(vecs.T, m, P, dimensions).T


def robust_cholesky(S):
    """Cholesky with a diagonal jitter that grows from 1e-10 by 10x until
    ``S`` is positive definite; raises once the jitter passes 1e6."""
    alpha = 0.0
    while True:
        try:
            return np.linalg.cholesky(S + alpha * np.eye(*S.shape))
        except np.linalg.LinAlgError:
            alpha = 1e-10 if alpha == 0 else alpha * 10
            if alpha > 1e6:
                raise


def whitenlearn(X, qidxs, pidxs):
    """Learn Lw whitening from D x N data and query/positive index pairs."""
    X = np.asarray(X, dtype=np.float64)
    m = X[:, qidxs].mean(axis=1, keepdims=True)
    df = X[:, qidxs] - X[:, pidxs]
    S = np.dot(df, df.T) / df.shape[1]
    P = np.linalg.inv(robust_cholesky(S))
    df = np.dot(P, X - m)
    D = np.dot(df, df.T)
    eigval, eigvec = np.linalg.eig(D)
    order = eigval.argsort()[::-1]
    eigvec = eigvec[:, order]
    P = np.dot(eigvec.T, P)
    return m, P


def pcawhitenlearn(X, shrink=None):
    """Learn PCA whitening from D x N data (optional Arun shrinkage)."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[1]
    m = X.mean(axis=1, keepdims=True)
    Xc = X - m
    cov = np.dot(Xc, Xc.T)
    cov = (cov + cov.T) / (2 * n)
    eigval, eigvec = np.linalg.eig(cov)
    order = eigval.argsort()[::-1]
    eigval = eigval[order]
    eigvec = eigvec[:, order]
    if shrink:
        b = eigval[shrink - 1]
        eigval = (1 - b) * eigval + b
    P = np.dot(np.linalg.inv(np.sqrt(np.diag(eigval))), eigvec.T)
    return m, P
