"""Parts a launched rank runs for ``test_torch_whole_batch_parallel.py``.
They import torch and the port only, never JAX, as ``dryrun.py``'s parts."""
import contextlib
import copy
import types
from unittest import mock

import torch
import torch.distributed as dist

from mdir_tpu_torch.learning import train_step
from mdir_tpu_torch.learning.epoch_iteration import SupervisedEpoch
from mdir_tpu_torch.learning.network import initialize_network
from mdir_tpu_torch.models.layers import (BatchNorm2d, Dropout,
                                          set_batchnorm_mesh)
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.optim.optimizers import initialize_optimizer
from mdir_tpu_torch.parallel.mesh import make_mesh


def _mesh(device):
    return make_mesh(dist.get_world_size() if dist.is_initialized() else 1,
                     device)


@contextlib.contextmanager
def float64():
    """Networks built in float64, and a device chain's float32 output
    widened at the valid mask, as ``tests/test_torch_joint_train.py``
    widens it."""
    old, mask = torch.get_default_dtype(), train_step.apply_valid_mask
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(train_step, "apply_valid_mask",
                               lambda x, v: mask(x.double(), v)):
            yield
    finally:
        torch.set_default_dtype(old)


def in_float64(fn, *args, device, **kwargs):
    """``fn(*args, device=device, **kwargs)`` under ``float64``."""
    with float64():
        return fn(*args, device=device, **kwargs)


def batchnorm_rank(state, x, upstream, *, device):
    """A live ``BatchNorm2d`` of ``state`` on this rank's rows of ``x``
    (N, C, H, W) in train mode, pointed at the world's mesh, and the
    backward of ``sum(out * upstream)``: this rank's outputs and input
    gradients, its share of the affine gradients, and the running
    statistics, as numpy; and whether a deep copy of the layer (as
    ``ops/dtypes.py`` makes a bf16 copy) shares its mesh."""
    mesh = _mesh(device)
    bn = BatchNorm2d(x.shape[1]).to(device)
    bn.load_state_dict(state)
    set_batchnorm_mesh(bn, mesh)
    rows = mesh.rows(len(x))
    local = torch.from_numpy(x[rows]).to(device).requires_grad_()
    out = bn.train()(local)
    (out * torch.from_numpy(upstream[rows]).to(device)).sum().backward()
    out = {name: t.detach().cpu().numpy() for name, t in (
        ("out", out), ("x_grad", local.grad), ("weight_grad", bn.weight.grad),
        ("bias_grad", bn.bias.grad), ("running_mean", bn.running_mean),
        ("running_var", bn.running_var))}
    out["copy_shares_mesh"] = copy.deepcopy(bn).mesh is mesh
    return out


def dropout_step(state, images, targets, optimizer, *, device):
    """One step of the train stage's epoch (``SupervisedEpoch``, parallel
    over the world) of the image network of checkpoint ``state`` on an
    image-pair batch under L1: the cells its first Dropout kept in the
    step's forward (beside its input's nonzero cells), the Dropout
    generator's seed, and the model's state after the step."""
    mesh = _mesh(device)
    network = initialize_network(None, device, state).train()
    seen = []
    drop = next(m for m in network.model.modules() if isinstance(m, Dropout))
    hook = drop.register_forward_hook(lambda module, args, out: seen.append(
        ((out != 0).cpu().numpy(), (args[0] != 0).cpu().numpy())))
    epoch = SupervisedEpoch(types.SimpleNamespace(dataset=None),
                            initialize_criterion({"loss": "l1"}),
                            batch_average=True, fakebatch=False,
                            parallel={"data": mesh.size}
                            if mesh.size > 1 else None).steps(0)
    opt = initialize_optimizer(network, dict(optimizer))
    epoch._optimization_step(network, opt, images, targets)
    hook.remove()
    (kept, nonzero), = seen
    return {"kept": kept, "nonzero": nonzero,
            "seed": epoch._generator.initial_seed(),
            "model": {k: v.cpu() for k, v
                      in network.model.state_dict().items()}}
