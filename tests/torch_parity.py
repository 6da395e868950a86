"""Shared helpers of the tests/test_torch_*.py parity tests: the same field
weights and inputs, made from a seed, in the JAX reference and the port."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from satnerf_tpu.models import field as jfield
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params

# tier-1 runs several xdist workers on one machine: keep torch to few threads
torch.set_num_threads(2)


def field_pair(seed: int = 0, **cfg):
    """(JAX FieldConfig, JAX params, port FieldConfig, port Field) holding
    the same weights (JAX init, carried over by field_state_from_params)."""
    jcfg = jfield.FieldConfig(**cfg)
    params = jax.tree.map(
        np.array, jfield.init_field_params(jax.random.PRNGKey(seed), jcfg)
    )
    tcfg = tfield.FieldConfig(**cfg)
    module = tfield.Field(tcfg)
    module.load_state_dict(field_state_from_params(params))
    return jcfg, params, tcfg, module


def field_inputs(n: int, tau: int = 4, seed: int = 1):
    """Points in the unit cube, unit sun directions, t-embedding rows."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    sun = rng.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    view = rng.normal(size=(n, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    t_emb = (rng.normal(size=(n, tau)) * 0.5).astype(np.float32)
    t_s_emb = (rng.normal(size=(n, tau)) * 0.5).astype(np.float32)
    return xyz, sun, view, t_emb, t_s_emb


def max_err(a, b) -> float:
    a, b = (
        np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                   np.float32)
        for x in (a, b)
    )
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def synthetic_rays(n: int, seed: int = 0, vocab: int = 5):
    """Seeded rays: origins above the unit cube, near-nadir directions,
    near 0 and far 2, per-ray sun directions and ts indices."""
    rng = np.random.default_rng(seed)
    o = np.concatenate(
        [rng.uniform(-0.8, 0.8, (n, 2)), np.full((n, 1), 1.0)], axis=1
    )
    d = np.concatenate(
        [rng.uniform(-0.15, 0.15, (n, 2)), -np.ones((n, 1))], axis=1
    )
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate(
        [o, d, np.zeros((n, 1)), np.full((n, 1), 2.0)], axis=1
    ).astype(np.float32)
    sun = np.concatenate(
        [rng.uniform(-0.5, 0.5, (n, 2)), np.full((n, 1), 0.8)], axis=1
    )
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    ts = rng.integers(0, vocab, (n, 1))
    extras = np.concatenate([sun, ts], axis=1).astype(np.float32)
    return rays, extras


def _hashable(kw: dict) -> tuple:
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _jax_field_out(kw: tuple, n: int, n_full, bf16: bool) -> dict:
    jcfg, params, _, _ = field_pair(**dict(kw))
    xyz, sun, view, te, tse = field_inputs(n, jcfg.t_embedding_tau)
    out = jfield.field_forward(
        params, jcfg, jnp.asarray(xyz), view_dir=jnp.asarray(view),
        sun_d=jnp.asarray(sun), t_emb=jnp.asarray(te), t_s_emb=jnp.asarray(tse),
        compute_dtype=jnp.bfloat16 if bf16 else None, n_full=n_full,
    )
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def jax_field_out(kw: dict, n: int, n_full=None, dtype=None) -> dict:
    """JAX field_forward on field_inputs(n) (cached per configuration)."""
    return _jax_field_out(_hashable(kw), n, n_full, dtype == "bf16")


def torch_field_out(kw: dict, n: int, n_full=None, dtype=None) -> dict:
    """The port's field_forward on the same weights and inputs."""
    _, _, tcfg, module = field_pair(**kw)
    xyz, sun, view, te, tse = (
        torch.from_numpy(a) for a in field_inputs(n, tcfg.t_embedding_tau)
    )
    with torch.no_grad():
        return tfield.field_forward(
            module, tcfg, xyz, view_dir=view, sun_d=sun, t_emb=te, t_s_emb=tse,
            compute_dtype=torch.bfloat16 if dtype == "bf16" else None,
            n_full=n_full,
        )
