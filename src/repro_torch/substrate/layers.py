"""Initializers, layernorm and dense layers on tensors.

Parameters are nested dicts of tensors with the reference's leaf names and
layouts (dense ``w`` is ``(d_in, d_out)``)."""
from __future__ import annotations

import torch


def normal_init(gen: torch.Generator, shape, scale=0.02, device="cuda"):
    """``scale * N(0, 1)`` drawn from ``gen`` (on the generator's device),
    then moved to ``device`` — the same seed gives the same values on any
    target device."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(device)


def init_norm(d: int, device="cuda"):
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def apply_norm(p, x, eps: float = 1e-5):
    """Layernorm over the last (channel) axis only, with statistics in f32
    (population variance), cast back to ``x.dtype``."""
    xf = x.float()
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
