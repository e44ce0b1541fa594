"""ImageRetrievalNet: trunk -> (lwhiten) -> pool -> L2N -> (whiten) -> L2N.

The component order of cirtorch's ``imageretrievalnet.py`` and of
``mdir_tpu/models/retrievalnet.py``, in NCHW. Output is (N, D) rows. GeM's
``p`` is a learnable parameter (``pool.p``). The GeM head is the masked
GeM+L2N kernel wrapper (``ops/pooling_kernel.gem_l2n``): on the card it is
the CUDA kernel, on the CPU its plain version. The kernel is eval-only, so
where a gradient is wanted the head runs the plain version on either, as the
JAX package trains through its XLA GeM. MAC and SPoC heads are plain
PyTorch. Regional pooling (RMAC, Rpool) comes with a later slice.

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


class ImageRetrievalNet(nn.Module):

    def __init__(self, architecture="resnet101", local_whitening=False,
                 pooling="gem", regional=False, whitening=False, p_init=3.0):
        super().__init__()
        if regional or pooling not in ("gem", "mac", "spoc"):
            raise NotImplementedError(
                "pooling %r (regional=%s) is not ported yet"
                % (pooling, regional))
        dim = OUTPUT_DIM[architecture]
        self.architecture = architecture
        self.pooling = pooling
        self.features = make_trunk(architecture)
        self.lwhiten = nn.Linear(dim, dim) if local_whitening else None
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
        """GeM p as a float (cirtorch ``model.pool.p.item()``)."""
        return float(self.pool.p.detach()[0])

    @property
    def device(self):
        return next(self.parameters()).device

    def forward(self, x, valid_hw=None, head_dtype=None):
        """x: (N, 3, H, W) -> (N, D) L2-normalised descriptors.

        ``valid_hw`` (N, 2) int32 gives each image's true size inside a
        padded bucket; None means every image fills the tensor.
        ``head_dtype`` casts the trunk's output before lwhiten, pool, L2N
        and whiten.
        """
        o, valid_hw = self.features(x, valid_hw)
        if head_dtype is not None:
            o = o.to(head_dtype)
        if valid_hw is None:
            valid_hw = torch.tensor(o.shape[-2:], dtype=torch.int32,
                                    device=o.device).expand(o.shape[0], 2)
        valid_hw = valid_hw.to(torch.int32).contiguous()

        if self.lwhiten is not None:  # per-cell linear map on channels
            o = self.lwhiten(o.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            o = o.contiguous()

        if self.pool is not None:
            o = self.pool(o, valid_hw)
        else:
            mask = pool_ops.feature_mask(o.shape[-2:], valid_hw, o.dtype)
            o = pool_ops.l2n(pool_ops.POOLING[self.pooling](o, mask=mask))

        if self.whiten is not None:
            # in the layer's dtype: the GeM kernel gives float32 for bf16
            o = pool_ops.l2n(self.whiten(o.to(self.whiten.weight.dtype)))
        return o
