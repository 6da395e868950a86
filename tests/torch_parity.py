"""Shared helpers of the tests/test_torch_*.py parity tests: the same field
weights and inputs, made from a seed, in the JAX reference and the port."""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from satnerf_tpu.models import field as jfield
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params
from satnerf_torch.ops import _bwd
from satnerf_torch.ops.fastmath import COSINE_ENGINES, SIN_MODES, SINE_ENGINES

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


# -- the backward kernels' two primitives, emulated on the CPU ----------------


def _emulated_row_op(lib_name, fn_name, dt, rows, width, prods=(), add=None,
                     bias=None, pre=None, mode=_bwd.PLAIN, scale=1.0, sin_mode=0,
                     out_f32=None, out_dt=None, out2_dt=None):
    """What csrc/bwd_common.cuh's row GEMM computes, in torch (f32 sums of the
    f32 operands; a split weight by the weight it was split from). Checks the argument
    layout: each product is (A (rows, K), W^T (width, K)), K a multiple of
    16 on the tensor-core route, the f32 weights split into tf32 parts."""
    name = SIN_MODES[sin_mode]
    sin, cos = SINE_ENGINES[name], COSINE_ENGINES[name]
    thin = width == _bwd.THIN_WIDTH
    v = torch.zeros((rows, width), dtype=torch.float32)
    for a, wt in prods:
        assert a.dtype == dt and a.shape[0] == rows
        if isinstance(wt, _bwd.Tf32Split):
            assert dt == torch.float32 and not thin
            hi, lo = _bwd.split_tf32(wt.w)
            assert torch.equal(hi, wt.hi) and torch.equal(lo, wt.lo)
            w = wt.w.float()
        else:
            assert wt.dtype == dt
            w = wt.float()
        assert w.shape == (width, a.shape[1]), (w.shape, width, a.shape)
        assert a.shape[1] % (4 if thin else 16) == 0
        v = v + a.float() @ w.t()
    if add is not None:
        v = v + add.float()
    if bias is not None:
        v = v + bias
    main, second = v, None
    if mode == _bwd.FWD_SINE:
        second = sin(scale * v)
    elif mode == _bwd.FWD_RELU:
        second = torch.clamp(v, min=0.0)
    elif mode == _bwd.BWD_SINE:
        p = pre.float()
        main, second = v * cos(scale * p) * scale, sin(scale * p)
    elif mode == _bwd.BWD_RELU:
        main = torch.where(pre.float() > 0, v, 0.0)
    for out, val in ((out_f32, main), (out_dt, main), (out2_dt, second)):
        if out is not None:
            assert out.shape == (rows, width)
            out.copy_(val.to(out.dtype))


def _emulated_reduce_op(lib_name, fn_name, dt, rows, gemms=(), sums=()):
    """What csrc/bwd_common.cuh's reduction computes, in torch: partial sums
    over chunks of _bwd.SPLIT_ROWS rows, added in chunk order; in f32 the
    bias sums whose rows are a GEMM's B ride along with that GEMM."""
    folded, rest = _bwd.fold_sums(dt, gemms, sums)
    chunks = [(s * _bwd.SPLIT_ROWS, min(rows, (s + 1) * _bwd.SPLIT_ROWS))
              for s in range(_bwd.n_splits(rows))]
    for j, (a, b, out) in enumerate(gemms):
        assert a.dtype == dt and b.dtype == dt and a.shape[0] == b.shape[0] == rows
        total = bias = None
        for s0, s1 in chunks:
            part = a[s0:s1].float().t() @ b[s0:s1].float()
            total = part if total is None else total + part
            col = b[s0:s1].float().sum(0)
            bias = col if bias is None else bias + col
        out.copy_(total)
        if j in folded:
            folded[j].copy_(bias)
    for b, out in rest:
        out.copy_(b.float().sum(0))


@contextlib.contextmanager
def emulated_bwd_kernels():
    """Run the CUDA wrappers' orchestration of K2 and K4 on CPU tensors, with
    the two kernel launches replaced by their torch emulation."""
    saved = _bwd.row_op, _bwd.reduce_op
    _bwd.row_op, _bwd.reduce_op = _emulated_row_op, _emulated_reduce_op
    try:
        yield
    finally:
        _bwd.row_op, _bwd.reduce_op = saved


TINY_PIPE = dict(n_samples=8, fc_layers=2, fc_units=64, fc_skips=[1], batch_size=256,
                 render_chunk_size=4096, first_beta_epoch=1, depth_enabled=True)


def train_tiny_run(base, steps: int = 24):
    """A tiny port run trained on the CPU through the port's training CLI,
    as the README's recipe does: a 40 x 40 generated scene (2 train views +
    1 test view), the flagship TOML with a 2 x 64 field and 8 samples, depth
    on, validation every epoch (12 steps). -> (pipeline, trainer)."""
    import os

    from satnerf_torch.configs import write_toml
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.run import training

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    generate_scene(str(base / "datasets" / "SYN"), n_train=2, n_test=1, img_size=40,
                   n_tie_points=80)
    toml = open(os.path.join(repo, "configs", "pipelines", "rs_semantic.toml")).read()
    body = [ln for ln in toml.splitlines() if ln.split("=")[0].strip() not in TINY_PIPE]
    body += [f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
             for k, v in TINY_PIPE.items()]
    (base / "pipeline.toml").write_text("\n".join(body) + "\n")
    write_toml(str(base / "run.toml"), dict(
        dataset_name="SYN", datasets_dp=str(base / "datasets"), cache_dp=str(base / "cache"),
        workspace_dp=str(base / "training"), max_train_steps=steps, num_sanity_val_steps=0,
        seed=0))
    pipeline, _, trainer = training.start_training(str(base / "run.toml"),
                                                   str(base / "pipeline.toml"), device="cpu",
                                                   log_every=50)
    return pipeline, trainer
