"""Train state: params, optimizer and step (port of
``satnerf_tpu/train/state.py``).

Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, no
weight decay); the learning rate is set before every update from the
schedule at the pre-increment step, as ``optax.inject_hyperparams`` does.
The update runs in place on the parameters.
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


@dataclass
class TrainState:
    params: dict
    optimizer: torch.optim.Adam
    schedule: object  # step -> learning rate
    step: int = 0


def create_train_state(params: dict, base_lr: float, scheduler: str = "step",
                       steps_per_epoch: int = 1, num_epochs: int = 1) -> TrainState:
    opt = torch.optim.Adam(trainable(params), lr=base_lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0)
    sched = make_lr_schedule(base_lr, scheduler, steps_per_epoch, num_epochs)
    return TrainState(params=params, optimizer=opt, schedule=sched, step=0)
