"""Loss criteria on tensors, as ``mdir_tpu/optim/criteria.py`` has them.

L1 and MSE are mean-reduced; the cirtorch contrastive and triplet losses are
sum-reduced over D x N descriptor columns packed as ``[q, p, n1..nN, q2,
...]`` with labels -1 / 1 / 0, including the reference's ``(dif + eps)^2``
in the contrastive distance. Each column's query (and positive) column is
found by a forward fill over the labels, so any tuple layout works.
"""
import numpy as np
import torch


class L1Loss:
    reduction = "mean"

    def __call__(self, x, target):
        return torch.mean(torch.abs(x - target))


class MSELoss:
    reduction = "mean"

    def __call__(self, x, target):
        return torch.mean((x - target) ** 2)


def _forward_fill_positions(marker):
    """For each column j, the index of the last marked column at or before
    j (-1 before the first)."""
    idx = torch.where(marker, torch.arange(marker.shape[0],
                                           device=marker.device), -1)
    return torch.cummax(idx, 0).values


def _labels(label, device):
    if not torch.is_tensor(label):
        label = torch.from_numpy(np.asarray(label, np.float32))
    return label.reshape(-1).to(device)


def contrastive_loss(x, label, margin=0.7, eps=1e-6):
    """Sum-reduced contrastive loss on D x N columns."""
    label = _labels(label, x.device)
    is_query = label == -1
    dif = x[:, _forward_fill_positions(is_query)] - x
    dist = torch.sqrt(torch.sum((dif + eps) ** 2, dim=0))
    lbl = torch.clamp(label, 0.0, 1.0)
    y = 0.5 * lbl * dist ** 2 \
        + 0.5 * (1 - lbl) * torch.clamp(margin - dist, min=0) ** 2
    return torch.sum(torch.where(is_query, torch.zeros_like(y), y))


def triplet_loss(x, label, margin=0.1):
    """Sum-reduced triplet loss on D x N columns."""
    label = _labels(label, x.device)
    xa = x[:, _forward_fill_positions(label == -1)]
    xp = x[:, _forward_fill_positions(label == 1)]
    dist_pos = torch.sum((xa - xp) ** 2, dim=0)
    dist_neg = torch.sum((xa - x) ** 2, dim=0)
    y = torch.clamp(dist_pos - dist_neg + margin, min=0)
    return torch.sum(torch.where(label == 0, y, torch.zeros_like(y)))


def _concat(label):
    if isinstance(label, (list, tuple)):
        return np.concatenate([np.asarray(l).reshape(-1) for l in label])
    return label


class ContrastiveLoss:
    reduction = "sum"

    def __init__(self, margin=0.7, eps=1e-6):
        self.margin = margin
        self.eps = eps

    def __call__(self, x, label):
        return contrastive_loss(x, _concat(label), self.margin, self.eps)

    def __repr__(self):
        return "ContrastiveLoss(margin=%.4f)" % self.margin


class TripletLoss:
    reduction = "sum"

    def __init__(self, margin=0.1):
        self.margin = margin

    def __call__(self, x, label):
        return triplet_loss(x, _concat(label), self.margin)

    def __repr__(self):
        return "TripletLoss(margin=%s)" % self.margin


CRITERIA = {
    "l1": L1Loss,
    "mse": MSELoss,
    "contrastive": ContrastiveLoss,
    "triplet": TripletLoss,
}


def initialize_criterion(params):
    if not params:
        return None
    params = dict(params)
    return CRITERIA[params.pop("loss")](**params)
