"""ImageRetrievalNet: trunk -> (lwhiten) -> pool -> L2N -> (whiten) -> L2N.

The component order of cirtorch's ``imageretrievalnet.py`` and of
``mdir_tpu/models/retrievalnet.py``, in NCHW. Output is (N, D) rows. GeM's
``p`` is a learnable parameter (``pool.p``). The GeM head is the masked
GeM+L2N kernel wrapper (``ops/pooling_kernel.gem_l2n``): on the card it is
the CUDA kernel, on the CPU its plain version. The kernel is eval-only, so
where a gradient is wanted the head runs the plain version on either, as the
JAX package trains through its XLA GeM. MAC and SPoC heads are plain
PyTorch, and so are the regional heads, RMAC (``pooling: rmac``) and Rpool
(``regional: true``): the JAX package pools regions with plain XLA too.
Their regions are cirtorch's grid of an unpadded map (``valid_hw`` None),
or, in a padded batch, the host-computed ``region_boxes`` (N, R, 4) of each
image's valid feature extent (``parallel/extract.py``).

Mixed precision (``ops/dtypes.py``): a bfloat16 copy of the net feeds its
head the trunk's bf16 map (the GeM kernel reads it at half the bytes and
pools in float32); the training step passes ``head_dtype=torch.float32``,
the JAX module's ``head_dtype`` seam, so a bf16 trunk feeds a float32 head
and the loss's arithmetic stays in float32.
"""
import torch
import torch.nn as nn

from ..ops import pooling as pool_ops
from ..ops import pooling_kernel
from .trunks import OUTPUT_DIM, make_trunk


class GeMPoolL2N(nn.Module):
    """Masked GeM + L2N with learnable ``p`` (state name ``pool.p``)."""

    def __init__(self, p_init=3.0, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.full((1,), float(p_init)))

    def forward(self, x, valid_hw):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.p.requires_grad):
            return pool_ops.gem_l2n_plain(x, valid_hw, self.p, eps=self.eps)
        return pooling_kernel.gem_l2n(x, valid_hw, self.p, eps=self.eps)


class GeMPool(nn.Module):
    """Plain GeM with learnable ``p`` under an optional mask: Rpool's region
    pool (cirtorch ``GeM``, state name ``pool.rpool.p``)."""

    def __init__(self, p_init=3.0, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.full((1,), float(p_init)))

    def forward(self, x, mask=None):
        return pool_ops.gem(x, p=self.p, eps=self.eps, mask=mask)


class Rpool(nn.Module):
    """Regional pooling (cirtorch ``pooling.py:64-100``): region vectors,
    L2N, the regional whitening ``whiten``, L2N, padded slots zeroed, sum,
    L2N. Module names are cirtorch's (``pool.rpool``, ``pool.whiten``)."""

    def __init__(self, pooling, dim, p_init=3.0):
        super().__init__()
        self.pooling = pooling
        self.rpool = GeMPool(p_init) if pooling == "gem" else None
        self.whiten = nn.Linear(dim, dim)

    def region_fn(self, x, mask=None):
        if self.rpool is not None:
            return self.rpool(x, mask=mask)
        return pool_ops.POOLING[self.pooling](x, mask=mask)

    def forward(self, x, region_boxes=None):
        if region_boxes is not None:
            vecs = pool_ops.region_vectors(x, region_boxes, self.region_fn)
        else:
            vecs = pool_ops.roipool(x, self.region_fn)  # (N, R, D)
        vecs = pool_ops.l2n(self.whiten(pool_ops.l2n(vecs)))
        if region_boxes is not None:
            # the whitening's bias makes padded slots nonzero otherwise
            vecs = vecs * (region_boxes[..., 2] > 0)[..., None].to(
                vecs.dtype)
        return pool_ops.l2n(vecs.sum(dim=-2))


class ImageRetrievalNet(nn.Module):

    def __init__(self, architecture="resnet101", local_whitening=False,
                 pooling="gem", regional=False, whitening=False, p_init=3.0):
        super().__init__()
        if pooling not in ("gem", "mac", "spoc", "rmac") \
                or (regional and pooling == "rmac"):
            raise ValueError("unsupported pooling %r (regional=%s)"
                             % (pooling, regional))
        dim = OUTPUT_DIM[architecture]
        self.architecture = architecture
        self.pooling = pooling
        self.regional = bool(regional)
        self.features = make_trunk(architecture)
        self.lwhiten = nn.Linear(dim, dim) if local_whitening else None
        if regional:
            self.pool = Rpool(pooling, dim, p_init)
        else:
            self.pool = GeMPoolL2N(p_init) if pooling == "gem" else None
        self.whiten = nn.Linear(dim, dim) if whitening else None
        self.meta = {
            "architecture": architecture,
            "local_whitening": bool(local_whitening),
            "pooling": pooling,
            "regional": bool(regional),
            "whitening": whitening,
            "mean": [0.485, 0.456, 0.406],
            "std": [0.229, 0.224, 0.225],
            "outputdim": dim,
            "in_channels": 3,
            "out_channels": dim,
        }

    @property
    def pool_p(self):
        """GeM p as a float (cirtorch ``model.pool.p.item()``; Rpool's
        region GeM's for a regional net)."""
        pool = self.pool.rpool if self.regional else self.pool
        return float(pool.p.detach()[0])

    @property
    def needs_region_boxes(self):
        """Whether a padded batch needs ``region_boxes`` (RMAC, Rpool)."""
        return self.regional or self.pooling == "rmac"

    @property
    def device(self):
        return next(self.parameters()).device

    def forward(self, x, valid_hw=None, head_dtype=None, region_boxes=None):
        """x: (N, 3, H, W) -> (N, D) L2-normalised descriptors.

        ``valid_hw`` (N, 2) int32 gives each image's true size inside a
        padded bucket; None means every image fills the tensor.
        ``head_dtype`` casts the trunk's output before lwhiten, pool, L2N
        and whiten. ``region_boxes`` (N, R, 4) int32 [y0, x0, bh, bw] are
        the RMAC/Rpool regions of each image's valid feature extent
        (zero-size boxes are padding); a padded batch of such a net needs
        them, where the JAX package asserts.
        """
        if self.needs_region_boxes and valid_hw is not None \
                and region_boxes is None:
            raise ValueError(
                "a padded batch (valid_hw) of a %s net needs region_boxes "
                "(the batched extractor computes them); the JAX package "
                "asserts the same" % ("regional" if self.regional
                                      else self.pooling))
        o, valid_hw = self.features(x, valid_hw)
        if head_dtype is not None:
            o = o.to(head_dtype)

        if self.lwhiten is not None:  # per-cell linear map on channels
            o = self.lwhiten(o.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            o = o.contiguous()

        if self.needs_region_boxes:
            o = self._regional_pool(o, region_boxes)
        else:
            if valid_hw is None:
                valid_hw = torch.tensor(
                    o.shape[-2:], dtype=torch.int32,
                    device=o.device).expand(o.shape[0], 2)
            valid_hw = valid_hw.to(torch.int32).contiguous()
            if self.pool is not None:
                o = self.pool(o, valid_hw)
            else:
                mask = pool_ops.feature_mask(o.shape[-2:], valid_hw,
                                             o.dtype)
                o = pool_ops.l2n(pool_ops.POOLING[self.pooling](o,
                                                                mask=mask))

        if self.whiten is not None:
            # in the layer's dtype: the GeM kernel gives float32 for bf16
            o = pool_ops.l2n(self.whiten(o.to(self.whiten.weight.dtype)))
        return o

    def _regional_pool(self, o, region_boxes):
        """RMAC or Rpool, then L2N: over ``region_boxes`` in a padded
        batch, else over cirtorch's grid of the whole map. Rpool's output is
        L2-normalised twice, as in the reference (Rpool norms its sum and
        the net norms the pool's output): one norm is off by about 1e-6
        relative, a systematic deviation from published ``-r``
        descriptors."""
        if self.regional:
            o = self.pool(o, region_boxes)
        elif region_boxes is not None:
            o = pool_ops.rmac_masked(o, region_boxes)
        else:
            o = pool_ops.rmac(o)
        return pool_ops.l2n(o)
