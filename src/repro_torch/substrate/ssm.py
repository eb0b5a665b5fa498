"""Mamba2 (SSD) layer of the port: the training part of the reference's
``substrate/ssm.py`` (``init_mamba2``, ``_mamba2_split``,
``_causal_conv`` and ``apply_mamba2`` on its stateless kernel route).

The scan core always goes through ``kernels/ssm_scan/ops.ssm_scan``: the
CUDA kernels on a card, their plain versions on the CPU.  The serving
state (``Mamba2State``, ``mamba2_init_state``, ``mamba2_step``) and the
xLSTM blocks are not ported yet (ROADMAP.md, Queue 1, item 10).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.substrate import layers


def init_mamba2(gen: torch.Generator, d_model: int, ssm, device="cuda"):
    """The reference's leaves and scales (torch's stream, not JAX's)."""
    di = ssm.expand * d_model
    H = di // ssm.head_dim
    N = ssm.state_dim
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = lo + (hi - lo) * torch.rand((H,), generator=gen, device=gen.device)
    # softplus^-1 of dt in [1e-3, 1e-1], log-uniform
    dt_bias = torch.log(torch.expm1(torch.exp(u))).to(device)
    return {
        # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
        "in_proj": layers.normal_init(gen, (d_model, 2 * di + 2 * N + H),
                                      device=device),
        "conv_w": layers.normal_init(gen, (ssm.conv_width, di + 2 * N), 0.2,
                                     device=device),
        "conv_b": torch.zeros((di + 2 * N,), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).to(device),
        "D": torch.ones((H,), device=device),
        "dt_bias": dt_bias,
        "norm": layers.init_norm(di, device, "rmsnorm"),
        "out_proj": layers.normal_init(gen, (di, d_model), device=device),
    }


def _mamba2_split(p, x, d_model, ssm):
    di = ssm.expand * d_model
    H = di // ssm.head_dim
    N = ssm.state_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    return z, xbc, dt, di, H, N


def _causal_conv(xbc, w, b):
    """xbc: (B, S, C); depthwise causal conv of width W from zeros, then
    silu."""
    W = w.shape[0]
    S = xbc.shape[1]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype))


def apply_mamba2(p, x, d_model, ssm):
    """Chunked SSD forward of the stateless (training) route: x (B, S,
    d_model) -> (B, S, d_model)."""
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    B, S, _ = x.shape
    z, xbc, dt_raw, di, H, N = _mamba2_split(p, x, d_model, ssm)
    P = ssm.head_dim
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bmat, Cmat = torch.split(xbc, [di, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])              # (B, S, H)
    A = -torch.exp(p["A_log"])                                  # (H,) negative
    y = ssm_scan(xs.float().contiguous(), Bmat.float().contiguous(),
                 Cmat.float().contiguous(), dt.contiguous(), A)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, di).to(x.dtype)
    # the reference's apply_norm defaults to rmsnorm
    y = layers.apply_norm(p["norm"], y, norm_type="rmsnorm") * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)
