"""The differentiable SSD scan (the reference's ``kernels/ssm_scan/ops.py``,
a ``jax.custom_vjp`` there).

:func:`ssm_scan` is a ``torch.autograd.Function``: its forward runs the
forward kernel and saves x, B, C, dt, A and the per-chunk entry states;
its backward runs the reverse-chunk backward kernel once and returns the
gradients that are asked for.  Under
``torch.utils.checkpoint`` the recompute runs the forward kernel again
and saves its own entry states.  On CPU tensors both run their plain
versions.

The chunk is :data:`CHUNK`, 128, its one definition (the wrappers and
the plain versions take the chunk as a required argument): the
reference's kernel route takes its chunk from its autotune registry,
whose default schedule is 128 (``kernels/ssm_scan/tune.py``), and its
training launcher runs that route on the TPU.  The reference's config
carries a chunk of 256 that only its lax.scan route reads; the port has
neither that route nor that field.  The autotune registry is not ported;
a caller that must match another chunk passes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ssm_scan as kern

CHUNK = 128


class SSMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, B, C, dt, A, chunk):
        y, _, si = kern.ssm_scan_fwd(x, B, C, dt, A, chunk=chunk,
                                     return_chunk_states=True)
        ctx.save_for_backward(x, B, C, dt, A, si)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, B, C, dt, A, si = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        grads = kern.ssm_scan_bwd(x, B, C, dt, A, si, dy.contiguous(),
                                  chunk=ctx.chunk)
        return tuple(g if n else None for g, n in zip(grads, need)) + (None,)


def ssm_scan(x, B, C, dt, A, chunk: int = CHUNK):
    """x (Bt, S, H, P), B/C (Bt, S, N), dt (Bt, S, H), A (H,), all f32 ->
    y (Bt, S, H, P) f32, differentiable in all five."""
    return SSMScan.apply(x, B, C, dt, A, chunk)
