"""Several cards on ``torch.distributed``: the 1-D data mesh of
``mdir_tpu/parallel/mesh.py``, one process per card.

The JAX package shards one program over an ICI mesh and lets XLA insert the
collectives; the port runs one process per rank (NCCL between cards, gloo
between CPU processes) and calls them itself:

* a ``Mesh`` is the world size, this rank, this rank's device and the
  process group (None for a world of one without a group: then every
  collective is the identity and the path is the single-card path);
* batch sharding is a contiguous slice of rows per rank (``rows``), and a
  sharded result comes back whole on every rank (``all_gather_rows``), as
  JAX's global array does;
* inside a differentiated forward pass, ``sum_over_ranks`` sums one flat
  tensor over the ranks with the sum over ranks again as its backward (a
  synchronised BatchNorm's statistics), and ``gather_live_rows`` stacks
  every rank's rows with only this rank's own slice carrying the graph
  (a criterion of the whole batch on every rank: summing the ranks'
  gradients then counts each row once);
* ``zero_dim`` is JAX's ``zero_shardings`` rule for one tensor: its largest
  dimension divisible by the world size (the first of equal ones), or None
  when none divides (the tensor is then replicated);
* ``launch`` starts n fresh processes on one host, each in a group of n
  (a ``FileStore`` in a temporary directory), and returns what ``fn``
  returned on each rank. The dry run and the CPU tests use it.

Nothing falls back: a mesh wider than the group or than the visible cards
raises, a card's mesh needs NCCL and a CPU mesh gloo.
"""
import datetime
import multiprocessing
import os
import pickle
import queue as queue_module
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# torch 2.13 renamed the single-tensor collectives; older ones have only
# the first names
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
LAUNCH_TIMEOUT_S = 600


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward is the all-reduce (sum) of the
    incoming gradient: each rank's objective depends on the sum, so the
    gradient of the sum of the ranks' objectives is the sum of theirs."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        out = flat.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class Mesh:
    """A 1-D data mesh: ``size`` ranks of ``group`` (None: a world of one
    without a group), this process's ``rank`` and ``device``."""

    def __init__(self, size, rank, device, group=None):
        self.size = size
        self.rank = rank
        self.device = torch.device(device)
        self.group = group

    @property
    def collective(self):
        """Whether collectives run (a group is set), at any size."""
        return self.group is not None

    def rows(self, n):
        """This rank's contiguous share of ``n`` rows (n divisible)."""
        if n % self.size:
            raise ValueError("%d rows do not split over %d ranks"
                             % (n, self.size))
        share = n // self.size
        return slice(self.rank * share, (self.rank + 1) * share)

    def all_gather_rows(self, local):
        """Every rank's equal-sized ``local`` rows stacked in rank order."""
        if not self.collective:
            return local
        local = local.contiguous()
        out = local.new_empty((self.size * local.shape[0],)
                              + tuple(local.shape[1:]))
        _all_gather(out, local, group=self.group)
        return out

    def reduce_scatter_rows(self, full):
        """The sum over ranks of ``full``, this rank's share of its rows."""
        if not self.collective:
            return full
        full = full.contiguous()
        out = full.new_empty((full.shape[0] // self.size,)
                             + tuple(full.shape[1:]))
        _reduce_scatter(out, full, group=self.group)
        return out

    def sum_over_ranks(self, flat):
        """The sum over ranks of one flat tensor, differentiable: the
        backward sums the gradient over the ranks too (the identity
        without a group)."""
        if not self.collective:
            return flat
        return _SumOverRanks.apply(flat.contiguous(), self.group)

    def gather_live_rows(self, local):
        """Every rank's equal-sized ``local`` rows in rank order, only this
        rank's slice carrying ``local``'s graph (the identity without a
        group)."""
        if not self.collective:
            return local
        full = self.all_gather_rows(local.detach())
        share = local.shape[0]
        return torch.cat([full[:self.rank * share], local,
                          full[(self.rank + 1) * share:]])

    def __deepcopy__(self, memo):
        # a communicator handle, which cannot be copied: a copy of a model
        # whose BatchNorm points at the mesh (a bf16 copy, ops/dtypes.py)
        # shares it
        return self

    def all_reduce(self, tensors):
        """Sum ``tensors`` over ranks in place, in one flat collective."""
        if not self.collective or not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        return tensors

    def broadcast(self, obj, src=0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if not self.collective:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group,
                                   device=self.device
                                   if self.device.type == "cuda" else None)
        return box[0]


def make_mesh(n, device):
    """The mesh of ``n`` ranks for a network on ``device``.

    With n = 1 and no group (or a group of other size) it is a world of one:
    no collectives. A group of world size n gives its ranks; a card's
    mesh needs NCCL, a CPU mesh gloo. Raises for n above the world size or
    the visible cards (JAX ``make_mesh``: a hard error, not a truncation).
    """
    device = torch.device(device)
    n = int(n)
    if n < 1:
        raise ValueError("a mesh needs at least one rank, not %d" % n)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError("parallel mesh wants %d cards but only %d are "
                         "visible" % (n, torch.cuda.device_count()))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dist.is_initialized() and world == n:
        backend = dist.get_backend()
        if backend != BACKENDS.get(device.type):
            raise ValueError("a mesh on %s needs the %s backend, the group "
                             "has %s" % (device.type,
                                         BACKENDS.get(device.type), backend))
        return Mesh(n, dist.get_rank(), device, dist.group.WORLD)
    if n == 1:
        return Mesh(1, 0, device)
    raise ValueError("parallel mesh wants %d ranks but the process group "
                     "has %d (start one process per card, e.g. torchrun "
                     "--nproc_per_node %d)" % (n, world, n))


def join_torchrun(device):
    """Under ``torchrun``: initialise the group through torch's ``env://``
    rendezvous (NCCL for a card, gloo for the CPU) and return this rank's
    device, ``cuda:<LOCAL_RANK>`` for a card, and True; else ``device``
    and False."""
    device = torch.device(device)
    if not dist.is_torchelastic_launched() or dist.is_initialized():
        return device, False
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group(BACKENDS[device.type], init_method="env://")
    return device, True


def writes_files():
    """Whether this process writes checkpoints, events and outputs: rank 0
    of a group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def from_rank0(obj):
    """Rank 0's picklable ``obj`` on every rank of the initialised group
    (``obj`` itself without one): a stage's result, the same everywhere."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def zero_dim(shape, n):
    """The dimension a tensor of ``shape`` splits over n ranks under ZeRO
    (JAX ``zero_shardings``): its largest dimension divisible by n, the
    first of equal ones; None when none divides."""
    best, size = None, 0
    for i, d in enumerate(shape):
        if d % n == 0 and d > size:
            best, size = i, d
    return best


def zero_dims(named_tensors, n):
    """``{name: zero_dim(shape, n)}`` of (name, tensor) pairs."""
    return {name: zero_dim(tuple(t.shape), n) for name, t in named_tensors}


def _rank_main(fn, rank, n, device_type, store_path, args, timeout, results):
    """One launched rank: its group, ``fn(*args, device=...)``, and the
    result (or the traceback) on ``results``."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)  # n ranks share the host's cores
            device = torch.device("cpu")
        dist.init_process_group(
            BACKENDS[device_type], store=dist.FileStore(store_path, n),
            world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            value = fn(*args, device=device)
        finally:
            dist.destroy_process_group()
        # pickled by value: tensors shared by handle die with the process
        results.put((rank, True, pickle.dumps(value)))
    except Exception:  # the parent raises it, with this traceback
        results.put((rank, False, traceback.format_exc()))


def launch(fn, n, device, args=(), timeout=LAUNCH_TIMEOUT_S):
    """``fn(*args, device=<this rank's device>)`` on n fresh processes in
    one group: NCCL on ``cuda:<rank>`` for a card, gloo for the CPU (one
    intra-op thread a rank). Returns the ranks' results in rank order.
    Raises if a rank raises or dies, or when ``timeout`` seconds pass (the
    collectives' timeout too); the processes left are killed."""
    device_type = torch.device(device).type
    if device_type not in BACKENDS:
        raise ValueError("no backend for device %r" % (device,))
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise ValueError("launch wants %d cards but only %d are visible"
                         % (n, torch.cuda.device_count()))
    context = multiprocessing.get_context("spawn")
    results = context.Queue()
    done = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [context.Process(
            target=_rank_main, daemon=True,
            args=(fn, rank, n, device_type, os.path.join(tmp, "store"),
                  args, timeout, results)) for rank in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for proc in procs:
                proc.start()
            while len(done) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("launch: %d of %d ranks finished in "
                                       "%d s" % (len(done), n, timeout))
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_module.Empty:
                    dead = [r for r, proc in enumerate(procs)
                            if r not in done and proc.exitcode not in
                            (None, 0)]
                    if dead:
                        raise RuntimeError(
                            "launch: rank %d exited with code %s"
                            % (dead[0], procs[dead[0]].exitcode))
                    continue
                if not ok:
                    raise RuntimeError("launch: rank %d raised:\n%s"
                                       % (rank, value))
                done[rank] = pickle.loads(value)
            for proc in procs:
                proc.join(max(deadline - time.monotonic(), 0))
        finally:
            for proc in procs:
                if proc.pid is None:  # never started
                    continue
                if proc.is_alive():
                    proc.kill()
                proc.join()
            results.close()
    return [done[rank] for rank in range(n)]
