"""The single-card forward check and the multi-card dry run: the port's
counterpart of ``__graft_entry__.py``.

    from mdir_tpu_torch.dryrun import dryrun_multicard, entry
    forward, args = entry("cuda"); forward(*args)
    dryrun_multicard(n, "cuda")   # n cards, one process each (NCCL)
    dryrun_multicard(2, "cpu")    # two CPU processes (gloo)

``dryrun_multicard`` runs ``dryrun_rank`` on n fresh processes
(``parallel/mesh.py::launch``), or in place when the calling process is
already a rank of a group of n, as ``dryrun_multichip`` runs one mesh: a
data-parallel contrastive step of a ``<architecture>``-GeM, ranking over
a database whose size n does not divide, a data-parallel step through the
lab CLAHE device chain, and a ZeRO step of an AlexNet-GeM. The other
functions here are parts a launched rank can run alone: sharded
descriptors of a network's state, sharded ranks, and steps of a network's
state under data parallelism or ZeRO (a per-tuple net, or a whole-batch one:
a composition under an optimizer alternation, a U-Net on image pairs);
``in_turn`` runs several
parts (or stages, which take ``device`` too) in one launch. Every part
takes the rank's ``device`` as a keyword.
"""
import copy

import numpy as np
import torch
import torch.distributed as dist

from .data.transforms import initialize_transforms
from .device import resolve_device
from .learning.network import CirNetwork, initialize_network
from .learning.train_step import TrainStep
from .models import initialize_model
from .ops.preprocess import RawChainInput, chain_from_transform
from .ops.ranking import rank_database, rank_database_sharded
from .optim.criteria import initialize_criterion
from .optim.optimizers import initialize_optimizer, init_adam, init_sgd
from .parallel.extract import MAX_BATCH, extract_vectors_network
from .parallel.mesh import from_rank0, launch, make_mesh, writes_files

CRITERION = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}
CHAIN = "pil2np | apply_clahe:4:lab:8 | totensor | normalize"
DRYRUN_TIMEOUT_S = 900


def _model_params(architecture):
    return {"architecture": "cirnet", "cir_architecture": architecture,
            "local_whitening": False, "pooling": "gem", "regional": False,
            "whitening": False, "pretrained": False}


def _network(architecture, device, **runtime):
    """A float32 ``<architecture>``-GeM CirNetwork from seed 0."""
    params = _model_params(architecture)
    return CirNetwork(initialize_model(params, device=device, seed=0),
                      CirNetwork.NetworkParams(
                          model=params,
                          runtime={"wrappers": "", "compute_dtype": "float32",
                                   **runtime}))


def entry(device="cuda"):
    """(forward, example_args): the ResNet101-GeM forward on a padded batch
    of two images with their valid extents (``__graft_entry__.entry``)."""
    device = resolve_device(device)
    model = initialize_model(_model_params("resnet101"), device=device,
                             seed=0).eval()

    @torch.no_grad()
    def forward(batch, valid_hw):
        return model(batch, valid_hw)

    batch = torch.zeros((2, 3, 224, 224), device=device)
    valid = torch.tensor([[224, 224], [160, 200]], dtype=torch.int32,
                         device=device)
    return forward, (batch, valid)


def _world_mesh(device):
    return make_mesh(dist.get_world_size() if dist.is_initialized() else 1,
                     device)


def sharded_descriptors(state, images, image_size, transform, mean_std,
                        max_batch=MAX_BATCH, *, device):
    """(D, N) descriptors of ``images`` (paths or uint8 arrays) through the
    network of checkpoint ``state``, each chunk sharded over the world."""
    network = initialize_network(None, device, state)
    return extract_vectors_network(
        network, images, image_size,
        initialize_transforms(transform, mean_std), batch_size=max_batch,
        mesh=_world_mesh(device))


def sharded_ranks(vecs, qvecs, *, device):
    """``rank_database_sharded`` of (D, N) and (D, Q) arrays over the
    world, as numpy."""
    vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for v in (vecs, qvecs))
    return rank_database_sharded(vecs, qvecs,
                                 _world_mesh(device)).cpu().numpy()


def in_turn(calls, *, device):
    """``fn(*args, device=device)`` of each ``(fn, args)``, in order: what
    each returned."""
    return [fn(*args, device=device) for fn, args in calls]


def _named_models(network):
    """(prefix, model) of each member: a composition's under
    ``<member>.``, a single net's bare."""
    if hasattr(network, "sequence"):
        return [(name + ".", network.networks[name].model)
                for name in network.sequence]
    return [("", network.model)]


def train_steps(state, batches, optimizer, optimizer_state=None, *,
                device, criterion=CRITERION, chain=None):
    """Steps of the network of checkpoint ``state`` over the world, one a
    ``(images, targets)`` batch (tuples, or image pairs), with the
    optimizer section ``optimizer`` (ZeRO when the network's runtime says
    ``param_sharding: zero``; a composition's ``composition`` section
    freezes a member whose section is null) and the criterion section
    ``criterion``, uint8 images through the device chain ``chain`` when
    given, started from ``optimizer_state`` if given. The gradients are
    the batch's sums. Returns the losses, the first batch's gradients
    summed over the world, the model's state dict (with live BatchNorm's
    running statistics; a composition's members' under ``<member>.``) and
    the optimizer's, on the CPU."""
    network = initialize_network(None, device, state).train()
    mesh = _world_mesh(device)
    step = TrainStep(network, initialize_criterion(dict(criterion)),
                     device_chain=chain, mesh=mesh)
    opt = initialize_optimizer(network, copy.deepcopy(optimizer))
    if optimizer_state is not None:
        opt.load_state_dict(optimizer_state)
    if step.param_sharding == "zero":
        opt.shard_state(mesh)
    models = _named_models(network)
    losses, grads = [], None
    for images, targets in batches:
        opt.zero_grad()
        loss, _ = step.gradients(images, targets)
        if grads is None:
            grads = {prefix + name: p.grad.detach().clone()
                     for prefix, model in models
                     for name, p in model.named_parameters()
                     if p.grad is not None}
            if step.param_sharding == "zero":  # the optimizer sums them
                mesh.all_reduce(list(grads.values()))
        opt.step()
        losses.append(float(loss))
    return {"losses": losses, "grads": _to_cpu(grads),
            "model": {prefix + k: v.cpu() for prefix, model in models
                      for k, v in model.state_dict().items()},
            "optimizer": _to_cpu(opt.state_dict()),
            "moment_shapes": [tuple(entry["exp_avg"].shape)
                              for member in getattr(opt, "optimizers", [opt])
                              for entry in member.optimizer.state.values()
                              if "exp_avg" in entry]}


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree


def _same_on_every_rank(mesh, network):
    """Whether every rank holds the same parameters (bit for bit)."""
    flat = torch.cat([p.detach().reshape(-1).to(torch.float64)
                      for p in network.model.parameters()])
    sums = mesh.all_gather_rows(torch.stack([flat.sum(),
                                             (flat * flat).sum()])[None])
    return bool((sums == sums[0]).all())


def dryrun_rank(architecture, *, device):
    """One rank of the dry run; returns its lines (checks raise)."""
    mesh = _world_mesh(device)
    n = mesh.size
    criterion = initialize_criterion(dict(CRITERION))
    lines = []

    # 1. a data-parallel contrastive step: one (q, p) tuple a rank, sgd with
    # the pool's 10x learning rate
    network = _network(architecture, device).train()
    rng = np.random.RandomState(0)
    images = [[rng.rand(48, 48, 3).astype(np.float32) for _ in range(2)]
              for _ in range(n)]
    targets = [np.array([-1.0, 1.0], np.float32)] * n
    optimizer = init_sgd(network.parameters({}), lr=1e-6, momentum=0.0,
                         weight_decay=1e-6)
    step = TrainStep(network, criterion, mesh=mesh)
    optimizer.zero_grad()
    loss, _ = step.gradients(images, targets)
    optimizer.step()
    loss = float(loss)
    assert np.isfinite(loss), loss
    assert _same_on_every_rank(mesh, network), "DP replicas differ"
    lines.append("dryrun_multicard(%d): %s-GeM data-parallel contrastive "
                 "step, loss %.4f" % (n, architecture, loss))

    # 2. ranking over a database split between the ranks, n not dividing it
    rng = np.random.RandomState(1)
    db = rng.randn(32, 4 * n + 3).astype(np.float32)
    queries = rng.randn(32, 3).astype(np.float32)
    single = rank_database(*(torch.from_numpy(v).to(device)
                             for v in (db, queries)))
    assert (sharded_ranks(db, queries, device=device)
            == single.cpu().numpy()).all(), "sharded ranks differ"
    lines.append("dryrun_multicard(%d): sharded ranking of %d columns "
                 "equals one card's" % (n, db.shape[1]))

    # 3. a data-parallel step through the lab CLAHE device chain
    chain = chain_from_transform(initialize_transforms(
        CHAIN, [network.model.meta["mean"], network.model.meta["std"]]))
    assert chain is not None
    rng = np.random.RandomState(2)
    raw = [RawChainInput()(*[(rng.rand(32, 32, 3) * 255).astype(np.uint8)
                             for _ in range(2)]) for _ in range(n)]
    step = TrainStep(network, criterion, device_chain=chain, mesh=mesh)
    loss, _ = step.gradients(raw, targets)
    loss = float(loss)
    assert np.isfinite(loss), loss
    assert all(torch.isfinite(p.grad).all() for p in
               network.model.parameters() if p.grad is not None)
    lines.append("dryrun_multicard(%d): sharded lab CLAHE device-chain "
                 "step, loss %.4f" % (n, loss))

    # 4. a ZeRO step of an AlexNet-GeM: adam, its moments split n ways
    znet = _network("alexnet", device, param_sharding="zero").train()
    zstep = TrainStep(znet, criterion, mesh=mesh)
    assert zstep.param_sharding == "zero"
    zopt = init_adam(znet.parameters({}), lr=1e-4, weight_decay=0)
    zopt.shard_state(mesh)
    rng = np.random.RandomState(3)
    zimages = [[rng.rand(64, 64, 3).astype(np.float32) for _ in range(2)]
               for _ in range(n)]
    zopt.zero_grad()
    zloss, _ = zstep.gradients(zimages, targets)
    zopt.step()
    zloss = float(zloss)
    assert np.isfinite(zloss), zloss
    assert all(torch.isfinite(p).all() for p in znet.model.parameters())
    assert _same_on_every_rank(mesh, znet), "ZeRO replicas differ"
    split = [(param, dim, piece) for param, dim, piece in zopt.zero
             if dim is not None]
    assert split and all(piece.shape[dim] * n == param.shape[dim]
                         for param, dim, piece in split)
    lines.append("dryrun_multicard(%d): ZeRO step, loss %.4f, %d of %d "
                 "tensors' moments split %d ways"
                 % (n, zloss, len(split), len(zopt.zero), n))
    return lines


def dryrun_multicard(n, device="cuda", architecture="resnet101",
                     timeout=DRYRUN_TIMEOUT_S):
    """The dry run on n processes (n cards, or n CPU processes), or on the
    group this process is a rank of when its world size is n; prints and
    returns rank 0's lines."""
    if dist.is_initialized() and dist.get_world_size() == n:
        lines = from_rank0(dryrun_rank(architecture, device=device))
    else:
        lines = launch(dryrun_rank, n, device, args=(architecture,),
                       timeout=timeout)[0]
    if writes_files():
        for line in lines:
            print(line)
    return lines
