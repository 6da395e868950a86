"""One training step of a 2 x 256 field (``trunk_impl="pallas"``: K1 with
128-wide heads, K2 and K4, as the four-scene workflow's 8 x 256 runs them)
against the JAX package's step on the same parameters and batch, depth on;
the helpers and bars of tests/test_torch_step.py. JAX's step runs under
``jax.jit`` (about 45 s of this file's time on the CPU is its compile and
its Pallas kernels in interpret mode)."""

from test_torch_step import _check, _one_step

FIELD_2X256 = dict(variant="rs_semantic", layers=2, feat=256, skips=(1,), mapping=True,
                   trunk_impl="pallas")


def test_2x256_fused_step_matches_jax():
    _check(*_one_step(variant="rs_semantic", impl="pallas", field_kw=FIELD_2X256, jit=True))
