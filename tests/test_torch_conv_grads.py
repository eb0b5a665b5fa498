"""The gradients of the port's conv ops (their plain path on the CPU)
against ``jax.grad`` of the JAX package's fused Pallas ops run in
interpret mode: dx, dw and db of the conv and the transposed conv, with
each activation, at stride 1 and 2, in f32 and bf16.

Inputs come from a numpy seed and go through both packages.  Tolerances,
relative to each gradient's largest magnitude: f32 1e-4 (summation
order); bf16 2e-2 (one bf16 rounding of the same f32 sums on each side:
of dx and of the forward output the activation's slope is read from).
For bf16 both packages get the weights and bias already rounded to bf16:
the JAX interpret path would feed them in f32, the port rounds them as
the TPU does, and near a zero of the pre-activation that moves the
leaky-ReLU slope of a cell (measured: 3% of dx).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv3d import conv3d_bias_act as j_conv_bias_act
from repro.kernels.conv3d import \
    conv3d_transpose_bias_act as j_tconv_bias_act
from repro_torch.kernels.conv3d import ops

DT = {"f32": (jnp.float32, torch.float32, 1e-4),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("act", ["none", "leaky_relu", "softplus"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("transpose", [False, True])
def test_conv_grads_match_jax_pallas(transpose, stride, act, dtype):
    rng = np.random.default_rng(stride * 10 + len(act) + transpose)
    xs, co = ((1, 4, 3, 4, 3), 5) if transpose else ((2, 5, 4, 6, 3), 4)
    jdt, tdt, tol = DT[dtype]
    x = rng.normal(size=xs).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, 3, xs[-1], co))).astype(np.float32)
    b = (0.1 * rng.normal(size=(co,))).astype(np.float32)
    if dtype == "bf16":
        w, b = (np.array(jnp.asarray(a, jdt).astype(jnp.float32))
                for a in (w, b))
    jfn = j_tconv_bias_act if transpose else j_conv_bias_act
    tfn = (ops.conv3d_transpose_bias_act if transpose
           else ops.conv3d_bias_act)
    out_shape = jax.eval_shape(
        lambda: jfn(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
                    stride, act, 0.2, True)).shape
    gy = rng.normal(size=out_shape).astype(np.float32)

    def jloss(x_, w_, b_):
        y = jfn(x_, w_, b_, stride, act, 0.2, True)
        return jnp.sum(y.astype(jnp.float32) * gy)

    want = jax.jit(jax.grad(jloss, (0, 1, 2)))(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = tfn(xt, wt, bt, stride, act)
    got = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(gy).to(tdt))
    assert got[0].dtype == tdt
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, g, j in zip("xwb", got, want):
        g = g.float().numpy()
        j = np.asarray(j.astype(jnp.float32))
        err, scale = np.abs(g - j).max(), np.abs(j).max()
        assert err <= tol * scale, f"d{name}: max abs {err} > {tol} * {scale}"
