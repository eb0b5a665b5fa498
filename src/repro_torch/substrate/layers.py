"""Initializers, norms, dense layers, the FFNs (SwiGLU and gelu) and the
embedding on tensors.

Parameters are nested dicts of tensors with the reference's leaf names and
layouts (dense ``w`` is ``(d_in, d_out)``).  The norms default to
layernorm, which the GAN uses; the language models pass their config's
``norm_type`` (rmsnorm for qwen2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, scale=0.02, device="cuda"):
    """``scale * N(0, 1)`` drawn from ``gen`` (on the generator's device),
    then moved to ``device`` — the same seed gives the same values on any
    target device."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(device)


def init_norm(d: int, device="cuda", norm_type: str = "layernorm"):
    if norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), device=device)}
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def apply_norm(p, x, eps: float = 1e-5, norm_type: str = "layernorm"):
    """Layernorm (population variance) or rmsnorm over the last axis only,
    with statistics in f32, cast back to ``x.dtype``."""
    xf = x.float()
    if norm_type == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def init_dense(gen: torch.Generator, d_in, d_out, bias=False, scale=0.02,
               device="cuda"):
    p = {"w": normal_init(gen, (d_in, d_out), scale, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def apply_dense(p, x):
    """``x @ w (+ b)`` with the f32 params cast to the activation dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


FFN_TYPES = ("swiglu", "gelu")   # the reference's relu2 waits for its models


def init_ffn(gen: torch.Generator, d_model, d_ff, device="cuda",
             ffn_type: str = "swiglu"):
    """FFN parameters: SwiGLU's gate, in and out, or gelu's in and out."""
    if ffn_type not in FFN_TYPES:
        raise ValueError(f"ffn_type {ffn_type!r} is not ported: {FFN_TYPES}")
    if ffn_type == "swiglu":
        return {"w_gate": normal_init(gen, (d_model, d_ff), device=device),
                "w_in": normal_init(gen, (d_model, d_ff), device=device),
                "w_out": normal_init(gen, (d_ff, d_model), device=device)}
    return {"w_in": normal_init(gen, (d_model, d_ff), device=device),
            "w_out": normal_init(gen, (d_ff, d_model), device=device)}


def apply_ffn(p, x, ffn_type: str = "swiglu"):
    """SwiGLU: (silu(x @ w_gate) * (x @ w_in)) @ w_out; gelu: gelu(x @
    w_in) @ w_out, with JAX's default gelu, the tanh approximation."""
    if ffn_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_in"].to(x.dtype))
    else:                        # "gelu", the one other type init_ffn makes
        h = F.gelu(x @ p["w_in"].to(x.dtype), approximate="tanh")
    return h @ p["w_out"].to(x.dtype)


def init_embed(gen: torch.Generator, vocab, d_model, device="cuda"):
    return {"emb": normal_init(gen, (vocab, d_model), 0.02, device)}


def apply_embed(p, tokens, dtype=torch.float32):
    """Rows of the embedding for ``tokens`` (int, any shape), in ``dtype``
    (only the gathered rows are cast)."""
    return p["emb"][tokens].to(dtype)
