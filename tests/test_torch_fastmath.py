"""satnerf_torch.ops.fastmath against the JAX sine engines
(satnerf_tpu/ops/fastmath.py) over |x| <= 1e3, f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.ops import fastmath as jfm
from satnerf_torch.ops import fastmath as tfm

torch.set_num_threads(2)

ENGINES = [
    ("fast_sin", jfm.fast_sin, tfm.fast_sin),
    ("fast_sin5", jfm.fast_sin5, tfm.fast_sin5),
    ("fast_sin7f", jfm.fast_sin7f, tfm.fast_sin7f),
]


def _grid():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.linspace(-1e3, 1e3, 200_001, dtype=np.float32),
        rng.uniform(-1e3, 1e3, 100_000).astype(np.float32),
        # exact multiples of pi/2 and pi, where the fold branches switch
        (np.arange(-600, 601) * (np.pi / 2)).astype(np.float32),
    ])


@pytest.mark.parametrize("name,jax_fn,torch_fn", ENGINES, ids=[e[0] for e in ENGINES])
def test_engine_matches_jax(name, jax_fn, torch_fn):
    x = _grid()
    ref = np.asarray(jax_fn(jnp.asarray(x)))
    got = torch_fn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= 1e-6, name


@pytest.mark.parametrize("name,jax_fn,torch_fn", ENGINES, ids=[e[0] for e in ENGINES])
def test_engine_bf16_keeps_dtype(name, jax_fn, torch_fn):
    x = np.linspace(-50, 50, 4001, dtype=np.float32)
    got = torch_fn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jax_fn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    # both evaluate the f32 polynomial on the same bf16 inputs and round
    # the result to bf16 once
    assert np.max(np.abs(got.float().numpy() - ref)) <= 1e-6, name


def test_engines_table_names_the_sin_impls():
    assert set(tfm.SINE_ENGINES) == {"poly", "poly5", "poly7f"}
    x = torch.linspace(-3, 3, 101)
    assert torch.equal(tfm.SINE_ENGINES["poly"](x), tfm.fast_sin(x))
