"""The training step: render + every loss term + one Adam update (port of
``satnerf_tpu/train/step.py``).

As in the reference:

* the epoch gates (beta at ``first_beta_epoch``, with an optional linear
  ramp; car-reg at ``car_reg_loss_start``) are multiplier masks computed
  from the step counter;
* depth supervision is a static flag (``StepConfig.depth``), and the depth
  rays are rendered without the solar-correction pass;
* with the hierarchical pass (``n_importance > 0``) the rgb, depth and
  semantic losses run over the fine result and, under the ``c_`` prefix,
  the coarse one; car-reg and the semantic accuracy read the fine result;
* ``grad_accum = K`` splits the batch into K micro-steps whose gradients are
  summed, then scaled by 1/K before one update; leaves with fewer than K
  rows go whole into every micro-step, others are trimmed to a multiple of K.

Randomness (the stratified jitter) comes from an explicit
``torch.Generator``; ``None`` renders the deterministic ladder. The update
runs in place on the parameters in ``state.params``.

The step reads no host value: the gates come from the device step
``state.step_t`` and Adam's learning rate from ``state.optimizer.lr``, both
written by ``TrainState.feed`` before the step, so ``train_step.update``
(the device work of one step) can be captured in a CUDA graph and replayed
(``train/dispatch.py``). ``train_step`` itself is feed, update, and the
host's ``state.advance()``.

Data parallelism (``layout``, a ``parallel.mesh.DataParallel``): every rank
holds the global batch and renders its rows of it, with its rows of the
global batch's random draws; the per-ray quantities the losses read are
gathered from every rank (``LOSS_KEYS``), so every loss term is the
reduction over the global batch that one process computes (a masked mean
divides the global masked sum by the global count). The gradients of each
rank's rows are summed over the ranks by one all-reduce before the update.
With ``grad_accum`` the micro-batches are those of the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from satnerf_torch.models.field import shared_packing
from satnerf_torch.parallel.mesh import all_reduce_grads, gather_rows, shard_batch
from satnerf_torch.render.renderer import RenderConfig, render_rays
from satnerf_torch.train import losses
from satnerf_torch.train.state import TrainState, trainable


@dataclass(frozen=True)
class StepConfig:
    """Static step configuration (the reference's fields)."""

    render: RenderConfig
    steps_per_epoch: int
    # rgb loss
    sc_lambda: float = 0.05
    first_beta_epoch: int = 2
    # 0: the step gate at first_beta_epoch; > 0: mix the uncertainty losses
    # in linearly over this many epochs from first_beta_epoch
    beta_ramp_epochs: float = 0.0
    # depth
    depth: bool = False
    ds_lambda: float = 1000.0
    ds_noweights: bool = False
    # semantic
    semantic: bool = False
    lambda_s: float = 0.04
    car_index: int = -1
    ignore_car_index: bool = True
    use_beta_for_s: bool = False
    detach_beta_for_s: bool = False
    use_car_reg_loss: bool = False
    car_reg_loss_start: int = 3
    lambda_c: float = 0.1
    grad_accum: int = 1

    @property
    def variant(self) -> str:
        return self.render.field.variant


def _f32(value: float, device) -> torch.Tensor:
    """A 0-d f32 constant made on ``device`` by a fill (no host copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def loss_gates(scfg: StepConfig, step: torch.Tensor) -> tuple:
    """(beta_active, car_active) at ``step`` (a 0-d integer tensor), f32 0-d
    tensors on its device, computed as the JAX step computes them from
    ``state.step``: beta 0/1 at ``first_beta_epoch`` or the linear ramp,
    car-reg 0/1 at ``car_reg_loss_start``. The ramp's division is a product
    by the f32 reciprocal, as XLA compiles the JAX step's division by a
    constant."""
    epoch = torch.div(step, scfg.steps_per_epoch, rounding_mode="floor")
    if scfg.beta_ramp_epochs > 0:
        ramp_steps = float(scfg.beta_ramp_epochs * scfg.steps_per_epoch)
        start = float(scfg.first_beta_epoch) * float(scfg.steps_per_epoch)
        inv = float(np.float32(1.0) / np.float32(ramp_steps))
        beta_active = torch.clamp((step.to(torch.float32) - start) * inv, 0.0, 1.0)
    else:
        beta_active = (epoch >= scfg.first_beta_epoch).to(torch.float32)
    car_active = (epoch >= scfg.car_reg_loss_start).to(torch.float32)
    return beta_active, car_active


# what the losses and metrics read of a render (gathered under data parallelism)
LOSS_KEYS = ("rgb", "depth", "weights", "beta", "beta_semantic", "semantic_logits",
             "semantic_label", "weights_sc", "transparency_sc", "sun_sc")


def _render_rows(params: dict, rcfg, rays, extras, generator, layout):
    """Render a global batch, or under ``layout`` this rank's rows of it ->
    (results, (first row, global rows) or None)."""
    if layout is None:
        return render_rays(params, rcfg, rays, extras, generator=generator), None
    n = rays.shape[0]
    mine = shard_batch({"rays": rays, "extras": extras}, layout)
    span = (layout.rows(n).start, n)
    res = render_rays(params, rcfg, mine["rays"], mine["extras"], generator=generator,
                      global_rows=span)
    return res, span


def _loss_leaves(res: dict, prefix: str = ""):
    """(path, tensor) of every LOSS_KEYS entry, the nested coarse pass's too."""
    for k in LOSS_KEYS:
        if k in res:
            yield prefix + k, res[k]
    if "coarse" in res:
        yield from _loss_leaves(res["coarse"], prefix + "coarse/")


def _gather_results(layout, passes: list) -> list:
    """Every rank's rows of the loss leaves of each (results, span) pass, in
    one collective -> the passes' global results (LOSS_KEYS only)."""
    paths, tensors, spans = [], [], []
    for i, (res, span) in enumerate(passes):
        for path, t in _loss_leaves(res):
            paths.append((i, path))
            tensors.append(t)
            spans.append(span)
    out: list = [{} for _ in passes]
    for (i, path), t in zip(paths, gather_rows(layout, tensors, spans)):
        node = out[i]
        *parents, key = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = t
    return out


def compute_losses(scfg: StepConfig, params: dict, batch: dict, step,
                   generator: torch.Generator | None = None, layout=None):
    """Render + every loss term for one batch -> (loss, loss_dict, results).
    ``step`` is an int or the device step tensor.

    Under ``layout`` the batch is the global one, each rank renders its rows
    and ``results`` holds the gathered global LOSS_KEYS."""
    dev = batch["rays"].device
    if not torch.is_tensor(step):
        step = torch.full((), int(step), dtype=torch.int64, device=dev)
    results, span = _render_rows(params, scfg.render, batch["rays"], batch["extras"],
                                 generator, layout)
    if scfg.depth:
        d_results, d_span = _render_rows(
            params, replace(scfg.render, solar_correction=False), batch["depth_rays"],
            batch["depth_extras"], generator, layout)
    if layout is not None:
        passes = [(results, span)] + ([(d_results, d_span)] if scfg.depth else [])
        gathered = _gather_results(layout, passes)
        results = gathered[0]
        if scfg.depth:
            d_results = gathered[1]
    loss_dict: dict = {}
    sc_on = scfg.sc_lambda > 0 and scfg.render.solar_correction

    beta_active, car_active = loss_gates(scfg, step)
    if scfg.variant in ("nerf", "snerf"):
        beta_active = _f32(0.0, dev)
    else:
        loss_dict["beta_loss_activated"] = beta_active

    # with the hierarchical pass the fine result is the primary one and the
    # coarse pass is supervised too, its terms under the "c_" prefix
    rgb_passes = [("", results)]
    if "coarse" in results:
        rgb_passes.append(("c_", results["coarse"]))

    gt = batch["rgbs"]
    loss = None
    for prefix, res in rgb_passes:
        if scfg.variant == "nerf":
            rgb_loss, rgb_dict = losses.nerf_loss(res, gt)
        elif scfg.variant == "snerf":
            rgb_loss, rgb_dict = losses.snerf_loss(res, gt, scfg.sc_lambda, sc_on)
        else:
            l_beta, d_beta = losses.satnerf_loss(res, gt, scfg.sc_lambda, sc_on)
            l_plain, d_plain = losses.snerf_loss(res, gt, scfg.sc_lambda, sc_on)
            rgb_loss = beta_active * l_beta + (1.0 - beta_active) * l_plain
            rgb_dict = {
                "coarse_color": beta_active * d_beta["coarse_color"]
                + (1.0 - beta_active) * d_plain["coarse_color"],
                "coarse_logbeta": beta_active * d_beta["coarse_logbeta"],
            }
            if sc_on:
                rgb_dict["coarse_sc_term2"] = d_beta["coarse_sc_term2"]
                rgb_dict["coarse_sc_term3"] = d_beta["coarse_sc_term3"]
        loss = rgb_loss if loss is None else loss + rgb_loss
        loss_dict.update({prefix + k: v for k, v in rgb_dict.items()})

    if scfg.depth:
        kp_w = 1.0 if scfg.ds_noweights else batch["depth_weights"].reshape(-1)
        depth_passes = [("", d_results)]
        if "coarse" in d_results:
            depth_passes.append(("c_", d_results["coarse"]))
        for prefix, dres in depth_passes:
            d_loss, d_dict = losses.depth_loss(
                dres, batch["depth_depths"].reshape(-1), kp_w, scfg.ds_lambda)
            loss = loss + d_loss
            loss_dict.update({prefix + k: v for k, v in d_dict.items()})
        loss_dict["depth_loss_activated"] = _f32(1.0, dev)

    if scfg.semantic:
        sem = batch["semantic"]
        sem_mask = batch.get("semantic_sparsity_mask")
        for prefix, res in rgb_passes:
            l_plain_s, d_plain_s = losses.semantic_loss(
                res, sem, sem_mask, scfg.lambda_s, scfg.car_index,
                scfg.ignore_car_index)
            if scfg.use_beta_for_s:
                l_unc_s, d_unc_s = losses.semantic_uncertainty_loss(
                    res, sem, sem_mask, scfg.lambda_s, scfg.car_index,
                    scfg.ignore_car_index, scfg.detach_beta_for_s)
                sem_loss = beta_active * l_unc_s + (1.0 - beta_active) * l_plain_s
                loss_dict[prefix + "coarse_semantic"] = (
                    beta_active * d_unc_s["coarse_semantic"]
                    + (1.0 - beta_active) * d_plain_s["coarse_semantic"])
                if "coarse_semantic_logbeta" in d_unc_s:
                    loss_dict[prefix + "coarse_semantic_logbeta"] = (
                        beta_active * d_unc_s["coarse_semantic_logbeta"])
                loss_dict["semantic_beta_loss_activated"] = beta_active
            else:
                sem_loss = l_plain_s
                loss_dict.update({prefix + k: v for k, v in d_plain_s.items()})
                loss_dict["semantic_beta_loss_activated"] = _f32(0.0, dev)
            loss = loss + sem_loss

        # car-reg and the accuracy read the fine (primary) result only
        if scfg.use_car_reg_loss:
            l_car, d_car = losses.semantic_car_reg_loss(
                results, sem, sem_mask, scfg.lambda_c, scfg.car_index)
            loss = loss + car_active * l_car
            loss_dict["coarse_car_reg_loss"] = car_active * d_car["coarse_car_reg_loss"]
            loss_dict["car_reg_loss_activated"] = car_active

        pred = results["semantic_label"]
        loss_dict["semantic_accuracy"] = torch.mean(
            (pred == sem.reshape(-1).to(pred.dtype)).to(torch.float32))

    loss_dict["psnr"] = losses.psnr(results["rgb"], batch["rgbs"])
    return loss, loss_dict, results


def _micro_batches(batch: dict, k: int) -> list:
    """K micro-batches: leaves with fewer than K rows go whole into each,
    the others are trimmed to a multiple of K and split in order."""
    def part(x, i):
        if x.shape[0] < k:
            return x
        m = x.shape[0] // k
        return x[i * m : (i + 1) * m]

    return [{key: part(v, i) for key, v in batch.items()} for i in range(k)]


def build_train_step(scfg: StepConfig, layout=None):
    """-> ``train_step(state, batch, generator=None) -> (state, metrics)``.

    ``train_step.update(state, batch, generator) -> metrics`` is the step's
    device work alone (render, losses, backward, Adam), reading the step and
    Adam's scalars that ``state.feed()`` wrote; ``train_step`` feeds,
    updates and advances the host's step. Under ``layout`` (data
    parallelism) ``batch`` is the global batch on every rank, and the
    metrics are the global ones."""

    def update(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        params = trainable(state.params)
        for p in params:
            p.grad = None
        k = max(int(scfg.grad_accum), 1)
        loss_sum, dict_sum = None, None
        for mb in (_micro_batches(batch, k) if k > 1 else [batch]):
            with shared_packing():  # each field packed once per forward + backward
                loss, loss_dict, _ = compute_losses(scfg, state.params, mb, state.step_t,
                                                    generator, layout)
                loss.backward()
            loss = loss.detach()
            loss_dict = {key: v.detach() for key, v in loss_dict.items()}
            if loss_sum is None:
                loss_sum, dict_sum = loss, loss_dict
            else:
                loss_sum = loss_sum + loss
                dict_sum = {key: dict_sum[key] + v for key, v in loss_dict.items()}
        if layout is not None:
            all_reduce_grads(state.params, layout)
        with torch.no_grad():
            for p in params:
                if p.grad is None:  # as optax: an unused parameter gets a 0 grad
                    p.grad = torch.zeros_like(p)
                elif k > 1:
                    p.grad.mul_(1.0 / k)
        if k > 1:
            loss_sum = loss_sum * (1.0 / k)
            dict_sum = {key: v * (1.0 / k) for key, v in dict_sum.items()}
        state.optimizer.step()
        return {"loss": loss_sum, **dict_sum}

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None):
        state.feed()  # the pre-increment step and its learning rate, as optax
        metrics = update(state, batch, generator)
        state.advance()
        return state, metrics

    train_step.update = update
    return train_step
