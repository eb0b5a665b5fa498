"""The port's training attention against the JAX package on the CPU: the
plain versions of the forward (O and the log-sum-exp), dq and dk/dv
(``repro_torch.kernels.flash_attention``: on CPU tensors each wrapper runs
its plain version) against the reference's ``flash_attention_fwd(...,
return_lse=True)`` and ``flash_attention_bwd``, whose Pallas kernels run in
interpret mode with small tiles; and the port's autograd Function against
``torch.autograd`` through the plain forward.

Tolerances, of the largest magnitude of each output: f32 1e-5 (the same
f32 math, summed in another order); bf16 2e-2 (the reference rounds the
probabilities and ds to bf16 before its second product, the port keeps
them in f32, and both round the result to bf16: a few bf16 ulps).  The
log-sum-exp is held elementwise to 1e-5 relative (a row that sees no key
has -1e30 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention_bwd as jax_bwd, flash_attention_fwd as jax_fwd)
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    # B, S, T, H, KH, D, causal, window, dtype
    (2, 20, 20, 6, 2, 16, True, 0, "float32"),       # GQA, S not a multiple
    (1, 24, 24, 4, 1, 32, True, 0, "float32"),       # MQA
    (2, 20, 20, 6, 2, 16, False, 0, "float32"),      # not causal
    (2, 20, 20, 6, 2, 16, True, 8, "float32"),       # window
    (1, 20, 13, 4, 2, 16, False, 8, "float32"),      # T != S, window alone
    (1, 20, 6, 2, 1, 16, True, 3, "float32"),        # rows that see no key
    (2, 20, 20, 6, 2, 16, True, 0, "bfloat16"),
]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, S, T, H, KH, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, KH, D), (B, T, KH, D),
                      (B, S, H, D))]


def _close(got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


@pytest.mark.parametrize("B,S,T,H,KH,D,causal,window,dt", CASES)
def test_plain_training_attention_matches_jax(B, S, T, H, KH, D, causal,
                                              window, dt):
    q, k, v, do = _inputs(B, S, T, H, KH, D, seed=S * T + H + window)
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dt]) for a in (q, k, v, do))
    jo, jlse = jax_fwd(jq, jk, jv, causal=causal, window=window, block_q=8,
                       block_kv=8, interpret=True, return_lse=True)
    jdq, jdk, jdv = jax_bwd(jq, jk, jv, jo, jlse, jdo, causal=causal,
                            window=window, block_q=8, block_kv=8,
                            interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(TDT[dt])
                       for a in (q, k, v, do))
    to, tlse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal,
                                       window=window, return_lse=True)
    assert to.dtype == TDT[dt] and tlse.dtype == torch.float32
    assert tlse.shape == (B, S, H)
    tol = TOL[dt]
    _close(to, jo.astype(jnp.float32), tol)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    tdq, tdk, tdv = tfa.flash_attention_bwd(tq, tk, tv, to, tlse, tdo,
                                            causal=causal, window=window)
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert got.dtype == TDT[dt]
        _close(got, want.astype(jnp.float32), tol)
    mask = tref.train_mask(S, T, causal, window, "cpu")
    empty = ~mask.any(dim=1)
    if bool(empty.any()):
        assert bool((to[:, empty] == 0).all())
        assert bool((tdq[:, empty] == 0).all())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_autograd_function_matches_autograd_of_plain_forward(causal, window):
    """The Function's recompute backward (plain dq and dk/dv from the
    saved log-sum-exp) against autograd through ``flash_fwd_ref``: f32,
    1e-5 of the largest gradient."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 17, 17, 6, 2, 16,
                                                       seed=3))
    grads = []
    for fn in (lambda *a: tops.flash_attention(*a, causal, window),
               lambda *a: tref.flash_fwd_ref(*a, causal=causal,
                                             window=window)[0]):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        grads.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
    for got, want in zip(*grads):
        _close(got, want.numpy(), 1e-5)


def test_autograd_function_honours_needs_input_grad():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 16,
                                                       seed=4))
    k.requires_grad_()
    dk, = torch.autograd.grad(tops.flash_attention(q, k, v).sum(), [k])
    assert dk.shape == k.shape and bool(torch.isfinite(dk).all())
    q.requires_grad_()
    out = tops.flash_attention(q, k.detach(), v)
    dq, = torch.autograd.grad(out.sum(), [q])
    assert dq.shape == q.shape


def test_wrappers_reject_what_they_do_not_take():
    q = torch.zeros((1, 4, 4, 16))
    k = torch.zeros((1, 4, 2, 16))
    lse = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention_fwd(q, torch.zeros((1, 4, 3, 16)),
                                torch.zeros((1, 4, 3, 16)))
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_bwd_dq(q, k, k, q, lse.double(), lse)
    with pytest.raises(ValueError, match="do must be"):
        tfa.flash_bwd_dkv(q, k, k, q[:, :2], lse, lse)
    with pytest.raises(ValueError, match="runs on cuda"):
        tfa.flash_attention_fwd(q.to("meta"), k.to("meta"), k.to("meta"))
