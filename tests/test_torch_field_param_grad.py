"""``Field`` parameter and t-embedding gradients through the port's fused
path (``FusedField``: K1 residuals -> K2 -> K4, their plain versions on the
CPU) against the JAX package's ``field_forward``.

- Against JAX ``trunk_impl="pallas"`` (its Pallas kernels in interpret
  mode), with and without ``n_full``: f32 within 1e-5 of the largest
  gradient of each tensor.
- Against JAX's layer-by-layer ("xla") path: the bars of
  tests/test_pallas_trunk.py:115-122.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params
from torch_parity import field_inputs, field_pair

SMALL = dict(variant="rs_semantic", layers=4, feat=256, skips=(2,), mapping=True)


def _rel(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.detach().float() if isinstance(b, torch.Tensor) else b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _field_grads_jax(kw, n, n_full, jax_impl):
    jcfg, params, _, _ = field_pair(**dict(kw, trunk_impl=jax_impl))
    xyz, sun, _, te, _ = field_inputs(n)

    def loss(p, t):
        o = jfield.field_forward(p, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
                                 t_emb=t, n_full=n_full)
        return sum(jnp.sum(v ** 2) for v in o.values())

    gp, gt = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(te))
    return jax.tree.map(np.asarray, gp), np.asarray(gt)


def _field_grads_port(kw, n, n_full):
    _, _, tcfg, module = field_pair(**kw)
    xyz, sun, _, te, _ = (torch.from_numpy(a) for a in field_inputs(n))
    te = te.clone().requires_grad_(True)
    o = tfield.field_forward(module, tcfg, xyz, sun_d=sun, t_emb=te, n_full=n_full)
    sum(torch.sum(v ** 2) for v in o.values()).backward()
    return {k: p.grad for k, p in module.named_parameters()}, te.grad


@pytest.mark.parametrize("n_full", [None, 130])
@pytest.mark.parametrize("bwd", ["recompute", "stored"])
def test_field_param_grads_match_jax_pallas(bwd, n_full):
    kw = dict(SMALL, trunk_impl="pallas", trunk_bwd=bwd)
    gp_j, gt_j = _field_grads_jax(kw, 260, n_full, "pallas")
    got, gt = _field_grads_port(kw, 260, n_full)
    want = field_state_from_params(gp_j)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k].numpy()) < 1e-5, k
    assert _rel(gt, gt_j) < 1e-5, "t_emb"


def test_field_param_grads_match_jax_xla():
    """Port's fused path against JAX's layer-by-layer path: the bars of
    tests/test_pallas_trunk.py:115-122 (the cosine polynomial's ~1e-4
    elementwise noise)."""
    kw = dict(SMALL, trunk_impl="pallas")
    gp_j, gt_j = _field_grads_jax(kw, 260, 130, "xla")
    got, gt = _field_grads_port(kw, 260, 130)
    want = field_state_from_params(gp_j)
    fx = np.concatenate([want[k].numpy().ravel() for k in want] + [gt_j.ravel()])
    fp = np.concatenate([got[k].numpy().ravel() for k in want] + [gt.numpy().ravel()])
    assert abs(np.linalg.norm(fx) - np.linalg.norm(fp)) / np.linalg.norm(fx) < 1e-4
    assert float(fx @ fp / (np.linalg.norm(fx) * np.linalg.norm(fp))) > 1.0 - 1e-6
    denom = np.maximum(np.abs(fx), 1e-1 * np.abs(fx).mean() + 1e-3)
    assert np.max(np.abs(fx - fp) / denom) < 0.05


def test_flagship_8x512_param_grads_match_jax():
    """rs_semantic at its published width on 128 points (+ 64 sc points)."""
    kw = dict(variant="rs_semantic", layers=8, feat=512, skips=(4,), mapping=True,
              trunk_impl="pallas")
    gp_j, gt_j = _field_grads_jax(kw, 192, 128, "pallas")
    got, gt = _field_grads_port(kw, 192, 128)
    want = field_state_from_params(gp_j)
    for k in want:
        assert _rel(got[k], want[k].numpy()) < 1e-5, k
    assert _rel(gt, gt_j) < 1e-5, "t_emb"
