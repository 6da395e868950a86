"""Carry field weights into the port.

- :func:`field_state_from_params`: a field param pytree of numpy arrays, as
  the JAX package's ``init_field_params`` returns it (``{"trunk": [{"w",
  "b"}, ...], "sigma": {...}, "rgb": [...], ...}`` with ``(in, out)``
  weights), -> a ``Field`` state dict.
- :func:`params_from_jax`: the whole JAX params dict (``init_params``:
  ``{"field": ..., "t": ..., "t_s": ...}``) -> the port's trainable params.
- :func:`load_lightning_ckpt`: a reference Lightning checkpoint (the format
  ``satnerf_tpu.models.import_torch.save_lightning_ckpt`` writes: keys
  ``model_<key>.<param>``) -> state dicts and embedding tables.

The port keeps its own copy of the key map.
"""

from __future__ import annotations

import numpy as np
import torch

# param-pytree head name -> (reference module prefix per sub-layer)
HEAD_MAP = {
    "sigma": ("sigma_from_xyz.0",),
    "feats": ("feats_from_xyz",),
    "rgb": ("rgb_from_xyzdir.0", "rgb_from_xyzdir.2"),
    "sun_v": ("sun_v_net.0", "sun_v_net.2", "sun_v_net.4", "sun_v_net.6"),
    "sky": ("sky_color.0", "sky_color.2"),
    "beta": ("beta_from_xyz.0", "beta_from_xyz.2"),
    "beta_s": ("semantic_beta_from_xyz.0", "semantic_beta_from_xyz.2"),
    "semantic": ("semantic_prediction.0", "semantic_prediction.2"),
}


def _entry(base: str, layer: dict) -> dict:
    w = np.array(np.asarray(layer["w"], np.float32).T, order="C")  # (out, in)
    b = np.array(layer["b"], np.float32)
    return {f"{base}.weight": torch.from_numpy(w),
            f"{base}.bias": torch.from_numpy(b)}


def field_state_from_params(params) -> dict:
    """Field param pytree (numpy-convertible leaves) -> ``Field`` state dict."""
    state: dict = {}
    for i, layer in enumerate(params["trunk"]):
        state.update(_entry(f"fc_net.{2 * i}", layer))
    for name, value in params.items():
        if name == "trunk":
            continue
        if name not in HEAD_MAP:
            raise KeyError(f"unmapped field parameter group: {name}")
        layers = value if isinstance(value, (list, tuple)) else [value]
        bases = HEAD_MAP[name]
        if len(layers) != len(bases):
            raise ValueError(f"{name}: {len(layers)} layers, expected {len(bases)}")
        for base, layer in zip(bases, layers):
            state.update(_entry(base, layer))
    return state


def params_from_jax(params_np: dict, fcfg, device=None) -> dict:
    """JAX ``init_params`` pytree (numpy-convertible leaves) ->
    {"field": ``Field``, "fine": ``Field`` (when the pytree has one), "t":
    table, "t_s": table} on ``device`` (None: the card), the tables as leaves
    that require grad."""
    from satnerf_torch.device import resolve_device
    from satnerf_torch.models.field import Field

    dev = resolve_device(device)
    out = {}
    for key in ("field", "fine"):
        if key in params_np:
            field = Field(fcfg)
            field.load_state_dict(field_state_from_params(params_np[key]))
            out[key] = field.to(dev)
    for key in ("t", "t_s"):
        if key in params_np:
            table = torch.from_numpy(np.array(params_np[key], np.float32))
            out[key] = table.to(dev).requires_grad_(True)
    return out


def load_lightning_ckpt(ckpt_fp: str) -> dict:
    """Read a reference-format checkpoint.

    Returns {"field": state dict, "fine": state dict (if present),
    "t": (vocab, tau) table, "t_s": table (if present)}, all on the CPU.
    """
    raw = torch.load(ckpt_fp, map_location="cpu", weights_only=True)
    state = raw.get("state_dict", raw)
    groups: dict[str, dict] = {}
    for key, value in state.items():
        if not key.startswith("model_"):
            continue
        model_key, rest = key[len("model_"):].split(".", 1)
        groups.setdefault(model_key, {})[rest] = value.to(torch.float32)
    if "coarse" not in groups:
        raise KeyError(f"{ckpt_fp}: no model_coarse.* entries")
    out = {"field": groups["coarse"]}
    if "fine" in groups:
        out["fine"] = groups["fine"]
    for key in ("t", "t_s"):
        if key in groups:
            out[key] = groups[key]["weight"]
    return out
