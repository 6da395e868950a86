"""Train state: params, optimizer and step (port of
``satnerf_tpu/train/state.py``).

Adam with optax's defaults (:class:`Adam`); the learning rate is the
schedule at the pre-increment step, as ``optax.inject_hyperparams`` gives it.
:meth:`TrainState.feed` writes the step and the update's scalars into the
device tensors that the step reads, so a CUDA graph can capture the step;
``TrainState.step`` is the host's mirror of the step. The update runs in
place on the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from satnerf_torch.device import resolve_device
from satnerf_torch.models.embeddings import init_embedding
from satnerf_torch.models.field import Field, FieldConfig
from satnerf_torch.train.schedule import make_lr_schedule


def init_params(generator: torch.Generator | None, fcfg: FieldConfig,
                t_vocab: int = 50, device=None, use_fine_network: bool = False) -> dict:
    """{"field": ``Field``, "fine": ``Field`` (with ``use_fine_network``),
    "t": table, "t_s": table} on ``device`` (None: the card), made from
    ``generator`` in that order; the tables are trainable leaves."""
    dev = resolve_device(device)
    params = {"field": Field(fcfg, generator=generator).to(dev)}
    if use_fine_network:
        params["fine"] = Field(fcfg, generator=generator).to(dev)
    if fcfg.has_beta:
        params["t"] = init_embedding(t_vocab, fcfg.t_embedding_tau, generator,
                                     dev, requires_grad=True)
        if fcfg.use_separate_tj_for_semantic:
            params["t_s"] = init_embedding(t_vocab, fcfg.t_embedding_tau,
                                           generator, dev, requires_grad=True)
    return params


def trainable(params: dict) -> list:
    """The parameters Adam updates, in a fixed order: the coarse field's,
    the fine field's, then the tables."""
    out = list(params["field"].parameters())
    if params.get("fine") is not None:
        out += list(params["fine"].parameters())
    out += [params[k] for k in ("t", "t_s") if params.get(k) is not None]
    return out


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay: optax's defaults) in
    the arithmetic of ``torch.optim.Adam`` on the card (its foreach form, not
    capturable: the same kernels in the same order, bit for bit), updated in
    place from the parameters' ``.grad``. The two scalars that change every
    step, the step size ``-lr / (1 - b1^t)`` and ``sqrt(1 - b2^t)``, are
    computed in f64 on the host as torch computes them and written by
    :meth:`feed` into device tensors, so the update reads nothing from the
    host and a CUDA graph can capture it. The moments, the update count
    ``count`` (int32) and the learning rate ``lr`` of the next update (f32)
    live on the device, made with the optimizer: a step allocates no state.
    ``t`` is the host's mirror of ``count`` (``TrainState.advance``), from
    which the scalars are computed."""

    def __init__(self, params: list, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = self.params[0].device
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.step_size = torch.zeros((), dtype=torch.float32, device=dev)
        self.bc2_sqrt = torch.zeros((), dtype=torch.float32, device=dev)
        self.t = 0

    def feed(self, lr: float) -> None:
        """The scalars of the next update, at ``lr``."""
        t = self.t + 1
        self.lr.fill_(lr)
        self.step_size.fill_(-(lr / (1 - self.b1 ** t)))
        self.bc2_sqrt.fill_((1 - self.b2 ** t) ** 0.5)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        torch._foreach_lerp_(self.exp_avg, grads, 1 - self.b1)
        torch._foreach_mul_(self.exp_avg_sq, self.b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, 1 - self.b2)
        self.count.add_(1)
        den = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(den, self.bc2_sqrt)
        torch._foreach_add_(den, self.eps)
        # torch's addcdiv by the step size: one rounding of p + s (m / den)
        for p, u in zip(self.params, torch._foreach_div(self.exp_avg, den)):
            p.addcmul_(u, self.step_size)

    def state_dict(self) -> dict:
        """{"state": {i: {"exp_avg", "exp_avg_sq"}}, "count", "lr"}: the live
        tensors."""
        return {"state": {i: {"exp_avg": m, "exp_avg_sq": v}
                          for i, (m, v) in enumerate(zip(self.exp_avg, self.exp_avg_sq))},
                "count": self.count, "lr": self.lr}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict`, or a ``torch.optim.Adam`` one (each
        moment's ``step`` is the count), into this optimizer's tensors in
        place (a captured step keeps reading them)."""
        moments = state.get("state", {})
        if set(moments) != set(range(len(self.params))):
            raise ValueError(f"the optimizer state holds {len(moments)} moments, this "
                             f"Adam {len(self.params)}")
        for i, (m, v) in enumerate(zip(self.exp_avg, self.exp_avg_sq)):
            m.copy_(moments[i]["exp_avg"])
            v.copy_(moments[i]["exp_avg_sq"])
        self.count.copy_(state["count"] if "count" in state else moments[0]["step"])
        self.t = int(self.count)
        if "lr" in state:
            self.lr.copy_(state["lr"])


@dataclass
class TrainState:
    params: dict
    optimizer: Adam
    schedule: object  # step -> learning rate
    step_t: torch.Tensor  # the device step that the loss gates read
    step: int = 0  # the host's mirror of the device step

    def feed(self) -> None:
        """Write the host step, and Adam's scalars at its learning rate, into
        the device tensors that the next step reads (fills, no copy from the
        host)."""
        self.step_t.fill_(self.step)
        self.optimizer.feed(self.schedule(self.step))

    def advance(self) -> None:
        """The host's side of a finished step: its step and Adam's count."""
        self.step += 1
        self.optimizer.t += 1


def create_train_state(params: dict, base_lr: float, scheduler: str = "step",
                       steps_per_epoch: int = 1, num_epochs: int = 1) -> TrainState:
    opt = Adam(trainable(params))
    sched = make_lr_schedule(base_lr, scheduler, steps_per_epoch, num_epochs)
    step_t = torch.zeros((), dtype=torch.int64, device=opt.count.device)
    return TrainState(params=params, optimizer=opt, schedule=sched, step_t=step_t)
