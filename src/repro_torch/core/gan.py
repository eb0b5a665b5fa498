"""3DGAN generator on tensors (the serving half of the reference's
`core/gan.py`).

Generator: (latent ⊕ E_p ⊕ theta) -> dense -> LeakyReLU -> stride-2
transposed 3-D convs (bias fused into the conv kernel; layernorm and
LeakyReLU outside it) -> crop -> output conv with bias + softplus fused ->
scale by E_p.  NDHWC activations, DHWIO conv weights.  Every conv goes
through `kernels/conv3d` (the CUDA kernel on a card, its plain version on
the CPU).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv3d.ops import (conv3d_bias_act,
                                            conv3d_transpose_bias_act)
from repro_torch.substrate import layers


def _conv_layer(x, w, b=None, stride=1, *, activation="none", slope=0.2,
                transpose=False):
    """One conv layer: conv + bias + activation in one kernel launch."""
    op = conv3d_transpose_bias_act if transpose else conv3d_bias_act
    return op(x, w, b, stride, activation, slope)


def _dense_fixed_rows(p, z, rows: int = 8):
    """``apply_dense`` as GEMMs of exactly ``rows`` rows (zero-padded).

    A BLAS library picks its algorithm, and with it the summation order,
    by the matrix shape, so one event's dense output could change in the
    last bits with the batch it shares.  At one fixed height every event
    goes through the same algorithm, which keeps a request's showers
    bit-identical whichever bucket they were packed into."""
    n = z.shape[0]
    zp = F.pad(z, (0, 0, 0, (-n) % rows))
    return torch.cat([layers.apply_dense(p, blk)
                      for blk in zp.split(rows)])[:n]


def _start_dims(image_shape, ups: int) -> Tuple[int, int, int]:
    f = 2 ** ups
    return tuple(-(-d // f) for d in image_shape)


def init_generator(gen: torch.Generator, cfg, device="cuda"):
    """Random generator params drawn from ``gen`` (serving an untrained
    generator, and tests).  Same leaf names and shapes as the reference's
    ``init_generator``; the values differ (torch, not threefry)."""
    chs = cfg.gen_channels
    ups = len(chs) - 1
    d0 = _start_dims(cfg.image_shape, ups)
    in_dim = cfg.latent_dim + 2
    p = {"fc": layers.init_dense(gen, in_dim, d0[0] * d0[1] * d0[2] * chs[0],
                                 bias=True, scale=0.05, device=device)}
    for i in range(ups):
        p[f"up{i}"] = {
            "w": layers.normal_init(gen, (3, 3, 3, chs[i], chs[i + 1]), 0.05,
                                    device),
            "b": torch.zeros((chs[i + 1],), device=device),
            "gn": layers.init_norm(chs[i + 1], device),
        }
    p["out"] = {"w": layers.normal_init(gen, (3, 3, 3, chs[-1], 1), 0.05,
                                        device),
                "b": torch.zeros((1,), device=device)}
    return p


def generate(p, noise, e_p, theta, cfg):
    """noise: (B, latent) in the compute dtype; e_p/theta (B,) raw units ->
    image (B, X, Y, Z, 1) in the compute dtype."""
    chs = cfg.gen_channels
    ups = len(chs) - 1
    d0 = _start_dims(cfg.image_shape, ups)
    e_n = (e_p / 100.0)[:, None].to(noise.dtype)
    t_n = theta[:, None].to(noise.dtype)
    z = torch.cat([noise, e_n, t_n], dim=-1)
    x = _dense_fixed_rows(p["fc"], z)
    x = F.leaky_relu(x, 0.2)
    x = x.reshape(-1, *d0, chs[0])
    for i in range(ups):
        # bias folds into the kernel epilogue; the activation cannot (a
        # layernorm sits between), so it stays outside
        x = _conv_layer(x, p[f"up{i}"]["w"], p[f"up{i}"]["b"], 2,
                        transpose=True)
        x = layers.apply_norm(p[f"up{i}"]["gn"], x)
        x = F.leaky_relu(x, 0.2)
    X, Y, Z = cfg.image_shape
    x = x[:, :X, :Y, :Z]
    # softplus keeps cell energies non-negative; scale with E_p
    x = _conv_layer(x, p["out"]["w"], p["out"]["b"], 1,
                    activation="softplus")
    return x * (e_n[:, None, None, None] * 0.025)
