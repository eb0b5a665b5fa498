"""One whole bf16 Algorithm-1 step of the port (its plain conv path on the
CPU) against the JAX step through its Pallas conv route in interpret
mode, which sums every conv's gradients in f32 as the port does.  The
step, the comparison and its tolerances are those of
``test_torch_train.py`` (see ``STEP_TOL`` there); this file holds only
the Pallas route, whose interpret-mode step takes ~12 s to trace.
"""
import pytest

from test_torch_train import _check_step, _fused_steps


@pytest.mark.parametrize("M", [1, 2])
def test_fused_bf16_step_matches_jax_pallas(M):
    _check_step(_fused_steps("bf16", M, pallas=True), "bf16", pallas=True)
