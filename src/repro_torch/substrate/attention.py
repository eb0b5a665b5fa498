"""Attention substrate of the port: GQA projections, rotary embeddings
and the attention router.

:func:`attend` routes every call to a kernel's wrapper: training (no
``kv_len``) to the differentiable flash attention (``ops.flash_attention``:
the forward kernel, and the dq and dk/dv kernels in the backward);
serving calls (a per-row ``kv_len``) to split-KV decode for a single
query with no ``q_offset``, or to chunked prefill for a prompt chunk with
``q_offset``.  Each wrapper launches its CUDA kernel on a CUDA tensor and
runs its plain version on a CPU tensor, so the port needs none of the
reference's pure-JAX routes (``dot_attention``, ``blockwise_attention``).
"""
from __future__ import annotations

import torch

from repro_torch.substrate import layers


def rope_cos_sin(positions, d_head: int, theta: float, dtype=torch.float32):
    """positions: (..., S) int -> cos, sin (..., S, d_head // 2)."""
    half = d_head // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=positions.device) / half))
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) -> rotated x (half-split)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def init_attn(gen: torch.Generator, cfg, device="cuda"):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": layers.init_dense(gen, d, qd, bias=cfg.qkv_bias, device=device),
        "wk": layers.init_dense(gen, d, kvd, bias=cfg.qkv_bias, device=device),
        "wv": layers.init_dense(gen, d, kvd, bias=cfg.qkv_bias, device=device),
        "wo": layers.init_dense(gen, qd, d, bias=False,
                                scale=0.02 / max(cfg.n_layers, 1) ** 0.5,
                                device=device),
    }


def project_qkv(p, x, cfg):
    B, S, _ = x.shape
    q = layers.apply_dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = layers.apply_dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads,
                                               cfg.d_head)
    v = layers.apply_dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads,
                                               cfg.d_head)
    return q, k, v


def attend(q, k, v, *, kv_len=None, q_offset=None):
    """Attention router (the reference's ``attend`` on its kernel route),
    causal and without a window.

    q: (B, S, H, D); k/v: (B, T, KH, D).  Without ``kv_len`` (training)
    query i attends keys 0..i through the differentiable flash attention.
    With ``kv_len`` (B,) live cache lengths (serving), a single query
    without ``q_offset`` goes to split-KV decode; otherwise the queries go
    to chunked prefill at ``q_offset`` (default ``kv_len - 1``)."""
    if kv_len is None:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, True, 0)
    if q.shape[1] == 1 and q_offset is None:
        from repro_torch.kernels.flash_attention.decode import flash_decode
        return flash_decode(q, k, v, kv_len)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_chunk)
    off = q_offset if q_offset is not None else (kv_len - 1).clamp_min(0)
    return flash_attention_chunk(q, k, v, off, kv_len)

