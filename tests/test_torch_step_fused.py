"""One training step with ``trunk_impl="pallas"`` on both sides, against
the JAX package (the helpers and bars of tests/test_torch_step.py): the
port's ``FusedField`` (the plain versions of K1, K2 and K4 on the CPU) and
its compositing inside a whole rs_semantic step, depth on."""

from test_torch_step import _check, _one_step


def test_fused_field_step_matches_jax():
    _check(*_one_step(variant="rs_semantic", impl="pallas"))


def test_fused_field_step_without_depth_matches_jax():
    _check(*_one_step(variant="rs_semantic", impl="pallas", depth=False))
