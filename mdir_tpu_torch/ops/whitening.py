"""Descriptor whitening (apply), cirtorch ``whiten.py`` semantics.

Descriptors are D x N column matrices: ``whitenapply`` projects
P[:dims] (X - m) and L2-normalises the columns with eps 1e-6. The product
runs in full float32 (``device.resolve_device`` turns TF32 off), as the
JAX package computes it at ``Precision.HIGHEST``. Learning Lw comes with the
whiten stage.
"""
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
