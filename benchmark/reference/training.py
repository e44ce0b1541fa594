"""Plain PyTorch steps of cirtorch's contrastive training.

Each step takes a batch of tuples (query, positive, negatives), describes
every image alone at its own size (the chain, the trunk, GeM with the
learnable p, L2), sums cirtorch's contrastive loss over the tuples
(``0.5 d^2`` for the positive, ``0.5 max(margin - d, 0)^2`` for each
negative, ``d = ||q - x + eps||``), back-propagates and steps
``torch.optim.Adam`` (betas 0.9 and 0.999, eps 1e-8, weight decay added to
the gradient) with GeM's p in a group of its own at ten times the rate and
no weight decay, as cirtorch's ``train.py`` sets it up.
"""
import numpy as np
import torch

from . import chain, nets

EPS = 1e-6


def gem_l2(x, p):
    """(1, C, h, w), p (1,) -> (C,) GeM then L2, differentiable in p."""
    v = x.clamp(min=EPS).pow(p).mean(dim=(2, 3)).pow(1.0 / p)[0]
    return v / (torch.linalg.vector_norm(v) + EPS)


def describe(rgb_u8, ref, params, dtype=torch.float32):
    """One image's single-scale descriptor (D,), float32, with its
    graph."""
    x = chain.run_chain(ref["chain"], rgb_u8, ref["mean"], ref["std"],
                        **ref.get("chain_args", {}))
    x = x.permute(2, 0, 1)[None].contiguous()
    if dtype != torch.float32:
        params = {k: v.to(dtype) for k, v in params.items()}
    feats = nets.features(ref["trunk"], ref["trunk_cfg"], params,
                          x.to(dtype))
    return gem_l2(feats.to(torch.float32),
                  params["pool.p"].to(torch.float32))


def contrastive(x, margin, eps=EPS):
    """cirtorch's contrastive loss of one tuple's (D, 2 + n) columns
    [q, p, n1..]: summed."""
    dist = torch.linalg.vector_norm(x[:, :1] - x[:, 1:] + eps, dim=0)
    pos = 0.5 * dist[0] ** 2
    neg = 0.5 * torch.clamp(margin - dist[1:], min=0) ** 2
    return pos + neg.sum()


def make_optimizer(params, lr, weight_decay):
    rest = [v for k, v in params.items()
            if k != "pool.p" and v.requires_grad]
    return torch.optim.Adam(
        [{"params": rest, "lr": lr, "weight_decay": weight_decay},
         {"params": [params["pool.p"]], "lr": 10 * lr, "weight_decay": 0.0}],
        betas=(0.9, 0.999), eps=1e-8)


def steps(batches, params0, ref, train_cfg, device, dtype=torch.float32,
          state0=None):
    """Run the batches (each a list of tuples, each a list of uint8 (H, W,
    3) numpy images) from ``params0`` and, if given, Adam's state
    ``state0`` ({name: {"step", "exp_avg", "exp_avg_sq"}}; a fresh
    optimizer without it). Returns the losses (each the summed loss over
    the batch's tuples, over the batch size), the first gradients as the
    optimizer gets them ({name: tensor}, weight decay included, read back
    from the change of Adam's first moment) and the parameters after the
    last step."""
    stats = nets.buffer_names(ref["trunk"], ref["trunk_cfg"])
    params = {k: v.detach().clone().requires_grad_(k not in stats)
              for k, v in params0.items()}
    opt = make_optimizer(params, train_cfg["lr"], train_cfg["weight_decay"])
    for k, state in (state0 or {}).items():
        opt.state[params[k]] = {
            "step": torch.tensor(float(state["step"])),
            "exp_avg": state["exp_avg"].clone(),
            "exp_avg_sq": state["exp_avg_sq"].clone()}
    moment0 = {k: s["exp_avg"] for k, s in (state0 or {}).items()}
    losses, first = [], None
    for batch in batches:
        opt.zero_grad()
        total = 0.0
        for images in batch:
            cols = torch.stack([describe(torch.from_numpy(
                np.ascontiguousarray(img)).to(device), ref, params, dtype)
                for img in images], dim=1)
            loss = contrastive(cols, train_cfg["margin"])
            loss.backward()
            total += float(loss.detach())
        opt.step()
        losses.append(total / len(batch))
        if first is None:
            first = {k: first_gradient(opt.state[v]["exp_avg"],
                                       moment0.get(k))
                     for k, v in params.items() if v.requires_grad}
    return losses, first, {k: v.detach() for k, v in params.items()}


def first_gradient(moment, moment0=None, beta1=0.9):
    """The gradient an Adam step took in, from its first moment after the
    step and (None for a fresh optimizer) before it."""
    if moment0 is None:
        return moment / (1 - beta1)
    return (moment - beta1 * moment0) / (1 - beta1)
