"""Checkpointing (port of ``satnerf_tpu/train/checkpoint.py``): one
``torch.save`` file per checkpoint.

Policy as in the reference: track the best ``train/mae`` (minimum), keep
``last`` always, optionally keep every-n-epochs snapshots. Files live under
``<run_dp>/ckpoints/`` as ``last.ckpt``, ``best.ckpt`` and
``epoch_<n>.ckpt``. The params are stored in the reference's Lightning
``state_dict`` layout (``model_coarse.<param>``, ``model_fine.<param>``,
``model_t.weight``, ``model_t_s.weight``; :func:`export_params`), so
``models/import_params.py:load_lightning_ckpt``, the JAX package's
``params_from_lightning_ckpt`` and ``RenderService.from_checkpoint`` all
read a port checkpoint. ``last`` adds the Adam state (moments, the update
count and the learning rate, device tensors in the file), ``step``,
``epoch`` and the best MAE so far (so a resumed run saves ``best`` where one
uninterrupted run does); ``best`` and the epoch snapshots are params-only.
A restore copies into the state's existing tensors and never replaces one,
so a step captured in a CUDA graph (``train/dispatch.py``) reads what it
restored.
"""

from __future__ import annotations

import os
import time

import torch

from satnerf_torch.logger import logger
from satnerf_torch.train.state import TrainState

SUFFIX = ".ckpt"
_FIELDS = (("coarse", "field"), ("fine", "fine"))
_TABLES = ("t", "t_s")


def export_params(params: dict) -> dict:
    """Port params -> the reference's Lightning ``state_dict`` (CPU copies)."""
    state = {}
    for model_key, key in _FIELDS:
        if params.get(key) is not None:
            for name, v in params[key].state_dict().items():
                state[f"model_{model_key}.{name}"] = v.detach().cpu().clone()
    for key in _TABLES:
        if params.get(key) is not None:
            state[f"model_{key}.weight"] = params[key].detach().cpu().clone()
    return state


def _nested(params: dict) -> dict:
    """Port params -> {"field": state dict, "fine": ..., "t": table, ...}."""
    out = {}
    for _, key in _FIELDS:
        if params.get(key) is not None:
            out[key] = dict(params[key].state_dict())
    for key in _TABLES:
        if params.get(key) is not None:
            out[key] = params[key].detach()
    return out


def _nested_from_state(state: dict) -> dict:
    """A Lightning ``state_dict`` -> the ``_nested`` layout."""
    by_model = {model_key: key for model_key, key in _FIELDS}
    out: dict = {}
    for name, v in state.items():
        if not name.startswith("model_"):
            continue
        model_key, rest = name[len("model_"):].split(".", 1)
        if model_key in by_model:
            out.setdefault(by_model[model_key], {})[rest] = v
        elif model_key in _TABLES:
            out[model_key] = v
    return out


@torch.no_grad()
def load_params_(params: dict, nested: dict) -> None:
    """Copy ``nested`` leaves into the port params in place (the optimizer
    keeps its references); keys absent from ``nested`` keep their values."""
    for _, key in _FIELDS:
        if key in nested and params.get(key) is not None:
            params[key].load_state_dict(nested[key], strict=False)
    for key in _TABLES:
        if key in nested and params.get(key) is not None:
            src = torch.as_tensor(nested[key])
            assert src.shape == params[key].shape, (key, src.shape, params[key].shape)
            params[key].copy_(src)


class CheckpointManager:
    def __init__(self, run_dp: str, save_every_n_epochs: int = -1,
                 steps_per_epoch: int = 1, write: bool = True) -> None:
        """``write=False`` (data-parallel ranks but rank 0) keeps the policy
        (the best MAE) and writes no file."""
        self.ckpt_dp = os.path.abspath(os.path.join(run_dp, "ckpoints"))
        self.write = write
        if write:
            os.makedirs(self.ckpt_dp, exist_ok=True)
        self.save_every_n_epochs = save_every_n_epochs
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.best_mae = float("inf")
        self.seconds: dict = {"save": [], "restore": []}  # of each save / restore

    def path(self, name: str) -> str:
        return os.path.join(self.ckpt_dp, name + SUFFIX)

    # -- save ----------------------------------------------------------------
    def _save(self, name: str, state: TrainState, params_only: bool = False) -> None:
        if not self.write:
            return
        t0 = time.monotonic()
        step = int(state.step)
        payload = {"state_dict": export_params(state.params), "step": step,
                   "global_step": step, "epoch": step // self.steps_per_epoch}
        if not params_only:
            payload["optimizer"] = state.optimizer.state_dict()
            payload["best_mae"] = self.best_mae  # a resume keeps the best-save policy
        path = self.path(name)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        dt = time.monotonic() - t0
        self.seconds["save"].append(dt)
        mb = os.path.getsize(path) / 1e6
        logger.info("Checkpoint", f"saved {name} ({mb:.1f} MB"
                    + (", params-only" if params_only else "") + f"; {dt:.2f}s)")

    def save_last(self, state: TrainState) -> None:
        self._save("last", state)

    def maybe_save_best(self, state: TrainState, train_mae: float) -> bool:
        """Monitor train/mae (min). The best snapshot serves eval consumers,
        so it is params-only; a resume continues from ``last``."""
        if train_mae < self.best_mae:
            self.best_mae = train_mae
            self._save("best", state, params_only=True)
            return True
        return False

    def maybe_save_epoch(self, state: TrainState, epoch: int) -> None:
        n = self.save_every_n_epochs
        if n > 0 and epoch % n == 0:
            self._save(f"epoch_{epoch}", state, params_only=True)

    # -- restore -------------------------------------------------------------
    def restore(self, state: TrainState, name: str = "last",
                path: str | None = None) -> TrainState:
        """Restore params, Adam state (its update count too), the host step
        and the best MAE so far in place, from this run's ``name`` or an
        explicit checkpoint file; the file is read once."""
        t0 = time.monotonic()
        path = path or self.path(name)
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if "optimizer" not in raw:
            raise ValueError(
                f"{path} is a params-only (eval) checkpoint — it carries no "
                "optimizer state to resume from. Resume from the 'last' "
                "checkpoint, or warm-start (RunConfig.warm_start_fp) to "
                "continue from these weights with a fresh optimizer."
            )
        load_params_(state.params, _nested_from_state(raw["state_dict"]))
        state.optimizer.load_state_dict(raw["optimizer"])
        state.step = int(raw["step"])
        self.best_mae = float(raw.get("best_mae", float("inf")))
        self.seconds["restore"].append(time.monotonic() - t0)
        logger.info("Checkpoint", f"restored {os.path.basename(path)} at step {state.step}")
        return state


def filter_params(params: dict, only_prefixes=None, ignore_prefixes=None) -> dict:
    """Select a sub-tree by '/'-joined path prefixes (partial weight
    transfer, e.g. warm-starting a semantic run from a SatNeRF checkpoint
    while dropping the semantic head)."""

    def keep(path: str) -> bool:
        if only_prefixes and not any(path.startswith(p) for p in only_prefixes):
            return False
        if ignore_prefixes and any(path.startswith(p) for p in ignore_prefixes):
            return False
        return True

    def rec(node, path: str):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                sub = rec(v, f"{path}/{k}" if path else str(k))
                if sub is not None:
                    out[k] = sub
            return out or None
        if isinstance(node, (list, tuple)):
            out_l = []
            for i, v in enumerate(node):
                sub = rec(v, f"{path}/{i}")
                out_l.append(sub)
            return out_l if any(s is not None for s in out_l) else None
        return node if keep(path) else None

    return rec(params, "") or {}


def merge_params(target: dict, source: dict) -> dict:
    """Overlay ``source`` leaves onto ``target`` (shapes must match where
    present) — the load side of partial weight transfer."""

    def rec(t, s):
        if s is None:
            return t
        if isinstance(t, dict):
            return {k: rec(t[k], s.get(k)) if isinstance(s, dict) else t[k]
                    for k in t}
        if isinstance(t, (list, tuple)):
            s_list = s if isinstance(s, (list, tuple)) else [None] * len(t)
            return [rec(tv, sv) for tv, sv in zip(t, s_list)]
        if hasattr(s, "shape") and hasattr(t, "shape"):
            assert s.shape == t.shape, f"shape mismatch {s.shape} vs {t.shape}"
        return s if s is not None else t

    return rec(target, source)


def load_warm_start_params(params: dict, ckpt_fp: str) -> dict:
    """Params-only warm start from a checkpoint file, in place.

    The checkpoint's params overlay the freshly initialised ``params``
    (shapes must match where present; keys absent from the source keep their
    init). If the target is hierarchical (``fine``) and the source has no
    fine field, the fine field is seeded from the source's coarse field.
    """
    raw = torch.load(ckpt_fp, map_location="cpu", weights_only=True)
    src = _nested_from_state(raw.get("state_dict", raw))
    target = _nested(params)
    src = {k: v for k, v in src.items() if k in target}
    merged = merge_params(target, src)
    if "fine" in target and "fine" not in src and "field" in src:
        merged["fine"] = dict(merged["field"])
        logger.info("Checkpoint", "warm start: fine field seeded from the "
                                  "source's trained coarse field")
    load_params_(params, merged)
    src_step = raw.get("step")
    logger.info(
        "Checkpoint",
        f"warm start: params loaded from {ckpt_fp}"
        + (f" (source step {int(src_step)})" if src_step is not None else "")
        + f"; transferred top-level keys: {sorted(src)}",
    )
    return params


def find_ckpoint_fp(run_dp: str, epoch: int | None = None, name: str | None = None) -> str:
    """A checkpoint file by ``name`` ("best", "last", "epoch_<n>"; it must
    exist), else by epoch, else best, else last."""
    dp = os.path.join(run_dp, "ckpoints")
    if name:
        cand = os.path.join(dp, name + SUFFIX)
        if not os.path.isfile(cand):
            raise FileNotFoundError(f"no checkpoint {name!r} in {dp}")
        return cand
    if epoch is not None:
        cand = os.path.join(dp, f"epoch_{epoch}{SUFFIX}")
        if os.path.isfile(cand):
            return cand
        logger.warning("Checkpoint", f"requested epoch {epoch} snapshot not found in "
                                     f"{dp}; falling back to best/last")
    for name in ("best", "last"):
        cand = os.path.join(dp, name + SUFFIX)
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"no checkpoint found in {dp}")
