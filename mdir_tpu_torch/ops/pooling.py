"""Global descriptor pooling and normalisation in PyTorch (NCHW layout).

The same formulas as ``mdir_tpu/ops/pooling.py`` (cirtorch's functional
layers): MAC = global max, SPoC = global mean, GeM =
(mean(clamp(x, eps)^p))^(1/p), L2N with eps added to the norm. Every pool
takes an optional (N, H, W) validity mask so that images padded into shape
buckets pool as they would at their own size. RMAC comes with a later slice.

These are also the plain versions of the GeM+L2N kernel
(``pooling_kernel.gem_l2n``): ``gem_l2n_plain`` is what the kernel computes.
"""
import torch


def feature_mask(shape_hw, valid_hw, dtype=torch.float32):
    """(N, H, W) mask of the cells inside each image's valid extent.

    valid_hw: (N, 2) integer tensor of per-image (rows, cols).
    """
    h, w = shape_hw
    rows = torch.arange(h, device=valid_hw.device)[None, :, None]
    cols = torch.arange(w, device=valid_hw.device)[None, None, :]
    mask = (rows < valid_hw[:, 0, None, None]) \
        & (cols < valid_hw[:, 1, None, None])
    return mask.to(dtype)


def l2n(x, eps=1e-6, dim=-1):
    """x / (||x||_2 + eps) along ``dim``."""
    return x / (torch.linalg.vector_norm(x, 2, dim=dim, keepdim=True) + eps)


def mac(x, mask=None):
    """Global max pool: (N, C, H, W) -> (N, C)."""
    if mask is not None:
        x = torch.where(mask[:, None] > 0, x,
                        torch.finfo(x.dtype).min)
    return x.amax(dim=(-2, -1))


def spoc(x, mask=None):
    """Global average pool: (N, C, H, W) -> (N, C)."""
    if mask is None:
        return x.mean(dim=(-2, -1))
    m = mask[:, None].to(x.dtype)
    total = (x * m).sum(dim=(-2, -1))
    count = m.sum(dim=(-2, -1)).clamp(min=1.0)
    return total / count


def gem(x, p=3.0, eps=1e-6, mask=None):
    """Generalized-mean pool (mean(clamp(x, eps)^p))^(1/p): (N,C,H,W)->(N,C).

    ``p`` is a float or a one-element tensor (the learnable GeM parameter).
    """
    if torch.is_tensor(p):
        p = p.reshape(())
    pooled = spoc(x.clamp(min=eps) ** p, mask=mask)
    return pooled ** (1.0 / p)


def gem_l2n_plain(x, valid_hw, p, eps=1e-6):
    """Masked GeM then L2N: (N, C, H, W), (N, 2) valid extents -> (N, C).

    The plain PyTorch version of the CUDA kernel in ``pooling_kernel``.
    """
    mask = feature_mask(x.shape[-2:], valid_hw, dtype=x.dtype)
    return l2n(gem(x, p=p, eps=eps, mask=mask), eps=eps)


POOLING = {
    "mac": mac,
    "spoc": spoc,
    "gem": gem,
}
