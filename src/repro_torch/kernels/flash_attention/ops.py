"""Differentiable flash attention for training (the reference's
``kernels/flash_attention/ops.py``, a ``jax.custom_vjp`` there).

:func:`flash_attention` is a ``torch.autograd.Function``: its forward runs
the forward kernel and saves q, k, v, O and the f32 log-sum-exp; its
backward computes ``delta = rowsum(dO * O)`` in f32 (one plain reduction,
as the reference computes it outside its kernels), then runs the dq
kernel and the dk/dv kernel, each only when an input it feeds needs a
gradient.  Under ``torch.utils.checkpoint`` the recompute runs the
forward kernel again and saves its own O and log-sum-exp.  Block sizes
are fixed by the kernels (the reference's autotune registry is not
ported).  On CPU tensors every step runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import attention_delta


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        delta = attention_delta(out, do)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw) if need_q else None
        dk = dv = None
        if need_k or need_v:
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return (dq, dk if need_k else None, dv if need_v else None, None,
                None)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k/v: (B, T, KH, D) -> (B, S, H, D), differentiable
    in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, window)
