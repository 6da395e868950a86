"""Rank layout and collectives for data-parallel ray training (port of
``satnerf_tpu/parallel/mesh.py``).

The JAX package shards the ray batch over a 1-D ``data`` mesh and lets XLA
insert the collectives of one SPMD program. Here one process per rank runs
the same step, and the collectives are explicit:

* the parameters are replicated: rank 0's are broadcast at start
  (``replicated``);
* the ray store is replicated and only the batch rows are sharded: every
  rank reads the global batch's index vector from the same sampler, renders
  its contiguous rows of it (``DataParallel.rows``, ``shard_batch``) and
  gathers the per-ray quantities the losses read from every rank
  (``gather_rows``), so every rank computes the same global loss;
* the gather's backward is the rank's slice of the incoming gradient, so
  each rank's parameter gradients are its rows' share of the global
  gradient; one all-reduce (sum) of the flattened gradients per step
  (``all_reduce_grads``) completes them.

Tensors of the data plane (gradients, gathers, the parameter broadcast) stay
on the rank's device; under gloo a CUDA tensor is staged through the host.
Host values (stop votes, the validation MAE, the run directory) travel on a
gloo group of their own, so they never wait for the device.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
import torch.distributed as dist

from satnerf_torch.parallel.multihost import rank_device
from satnerf_torch.train.state import trainable


class DataParallel:
    """This process's place in the data-parallel run, and its collectives.

    ``seconds`` and ``calls`` count the host-clock time and number of the
    data-plane collectives by kind ("gather", "grads", "broadcast",
    "render"). A CUDA tensor under gloo is staged through the host between
    two synchronisations of the device, so its time is the collective's,
    copies included; under nccl it is the host's issue time only.
    """

    def __init__(self, device: torch.device) -> None:
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = device
        self.ctrl = None if self.backend == "gloo" else dist.new_group(backend="gloo")
        self.seconds: dict = defaultdict(float)
        self.calls: dict = defaultdict(int)

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of an ``n``-row global batch."""
        lo, hi = self.rank * n // self.world, (self.rank + 1) * n // self.world
        if hi <= lo:
            raise ValueError(f"{n} rows cannot give each of {self.world} ranks one")
        return slice(lo, hi)

    # -- data plane ---------------------------------------------------------
    def _run(self, kind: str, buf: torch.Tensor, op) -> torch.Tensor:
        """``op(tensor)`` on ``buf`` in place (staged through the host under
        gloo), timed -> ``buf``."""
        staged = self.backend == "gloo" and buf.is_cuda
        if staged:
            torch.cuda.synchronize(buf.device)
        t0 = time.perf_counter()
        if staged:
            host = buf.cpu()
            op(host)
            buf.copy_(host)
            torch.cuda.synchronize(buf.device)
        else:
            op(buf)
        self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        return buf

    def all_reduce(self, buf: torch.Tensor, kind: str) -> torch.Tensor:
        return self._run(kind, buf, lambda t: dist.all_reduce(t, op=dist.ReduceOp.SUM))

    def broadcast(self, buf: torch.Tensor, kind: str = "broadcast") -> torch.Tensor:
        return self._run(kind, buf, lambda t: dist.broadcast(t, src=0))

    # -- control plane (host values) --------------------------------------------
    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on one."""
        t = torch.tensor([1.0 if flag else 0.0])
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.ctrl)
        return bool(t.item() > 0)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.ctrl)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.ctrl)


def make_mesh(n_devices: int | None = None, device=None) -> DataParallel:
    """The rank layout of the running process group (the ``data`` axis is
    the ranks). ``n_devices``, when given, must be the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("data parallelism needs a torch.distributed process group "
                           "(parallel.multihost.initialize_multihost)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"data_parallel = {n_devices} but the process group has "
                         f"{world} rank(s)")
    return DataParallel(rank_device("cpu" if device is None else device,
                                    dist.get_backend()))


def shard_batch(batch: dict, layout: DataParallel) -> dict:
    """This rank's rows of every leaf of a global batch."""
    return {k: v[layout.rows(v.shape[0])] for k, v in batch.items()}


@torch.no_grad()
def replicated(params: dict, layout: DataParallel) -> dict:
    """Broadcast rank 0's trainable parameters to every rank, in place (one
    flat buffer)."""
    leaves = trainable(params)
    flat = torch.cat([p.detach().reshape(-1) for p in leaves])
    layout.broadcast(flat)
    off = 0
    for p in leaves:
        p.copy_(flat[off : off + p.numel()].view_as(p))
        off += p.numel()
    return params


@torch.no_grad()
def all_reduce_grads(params: dict, layout: DataParallel) -> None:
    """Sum every trainable parameter's gradient over the ranks: one
    all-reduce of the flattened gradients. A missing gradient counts 0."""
    leaves = trainable(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in leaves])
    layout.all_reduce(flat, "grads")
    off = 0
    for p in leaves:
        g = flat[off : off + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        off += p.numel()


def gather_flat(layout: DataParallel, tensors: list, spans: list, kind: str) -> list:
    """Every rank's rows of each tensor -> the global tensors. ``spans``
    gives each tensor's (first row, global rows); the local rows land in a
    zero buffer of the global size, and one all-reduce (sum) fills in the
    other ranks' rows exactly."""
    row_sizes = [int(torch.Size(t.shape[1:]).numel()) for t in tensors]
    buf = torch.zeros(sum(n * r for (_, n), r in zip(spans, row_sizes)),
                      dtype=torch.float32, device=tensors[0].device)
    off = 0
    for t, (lo, n), r in zip(tensors, spans, row_sizes):
        buf[off + lo * r : off + (lo + t.shape[0]) * r] = t.detach().reshape(-1).float()
        off += n * r
    layout.all_reduce(buf, kind)
    out, off = [], 0
    for t, (_, n), r in zip(tensors, spans, row_sizes):
        out.append(buf[off : off + n * r].view(n, *t.shape[1:]).to(t.dtype).clone())
        off += n * r
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: ``gather_flat``. Backward: each input's own rows of the
    incoming gradient, which is the same on every rank (every rank computes
    the same loss from the same gathered tensors), so no collective."""

    @staticmethod
    def forward(ctx, layout, spans, *tensors):
        ctx.set_materialize_grads(False)
        ctx.rows = [slice(lo, lo + t.shape[0]) for t, (lo, _) in zip(tensors, spans)]
        outs = gather_flat(layout, list(tensors), spans, "gather")
        for t, o in zip(tensors, outs):
            if not t.is_floating_point():
                ctx.mark_non_differentiable(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(None if g is None else g[sl]
                                    for g, sl in zip(grads, ctx.rows))


def gather_rows(layout: DataParallel, tensors: list, spans: list) -> list:
    """Differentiable ``gather_flat``: every rank gets the global tensors,
    and each rank's inputs get their rows of the gradient."""
    return list(_GatherRows.apply(layout, spans, *tensors))
