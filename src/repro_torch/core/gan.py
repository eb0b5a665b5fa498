"""3DGAN on tensors: generator, discriminator and the ACGAN losses (the
reference's `core/gan.py`).

Generator: (latent ⊕ E_p ⊕ theta) -> dense -> LeakyReLU -> stride-2
transposed 3-D convs (bias fused into the conv kernel; layernorm and
LeakyReLU outside it) -> crop -> output conv with bias + softplus fused ->
scale by E_p.  Discriminator: log1p(50 * image) -> stride-2 convs, each
with layernorm and LeakyReLU -> flatten -> validity logit, E_p and theta
heads.  NDHWC activations, DHWIO conv weights.  Every conv, forward and
backward, goes through `kernels/conv3d` (the CUDA kernels on a card, their
plain versions on the CPU).
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


def init_discriminator(gen: torch.Generator, cfg, device="cuda"):
    """Random discriminator params drawn from ``gen``; the reference's
    leaf names and shapes."""
    chs = cfg.disc_channels
    p = {}
    c_in = 1
    for i, c in enumerate(chs):
        p[f"conv{i}"] = {
            "w": layers.normal_init(gen, (3, 3, 3, c_in, c), 0.05, device),
            "b": torch.zeros((c,), device=device),
            "ln": layers.init_norm(c, device),
        }
        c_in = c
    X, Y, Z = cfg.image_shape
    f = 2 ** len(chs)
    flat = (-(-X // f)) * (-(-Y // f)) * (-(-Z // f)) * chs[-1]
    for head in ("validity", "energy", "angle"):
        p[head] = layers.init_dense(gen, flat, 1, bias=True, device=device)
    return p


def discriminate(p, img, cfg):
    """img: (B, X, Y, Z, 1) -> (validity_logit, e_p_pred, theta_pred)."""
    x = torch.log1p(img * 50.0)        # compress the energy dynamic range
    for i in range(len(cfg.disc_channels)):
        x = _conv_layer(x, p[f"conv{i}"]["w"], p[f"conv{i}"]["b"], 2)
        x = layers.apply_norm(p[f"conv{i}"]["ln"], x)
        x = F.leaky_relu(x, 0.2)
    x = x.reshape(x.shape[0], -1)
    validity = layers.apply_dense(p["validity"], x)[:, 0]
    e_pred = F.softplus(layers.apply_dense(p["energy"], x)[:, 0]) * 100.0
    t_pred = layers.apply_dense(p["angle"], x)[:, 0] + math.pi / 2
    return validity, e_pred, t_pred


# ---------------------------------------------------------------------------
# Losses (ACGAN with physics constraints, 3DGAN-style); math in f32
# ---------------------------------------------------------------------------


def bce_logits(logit, target):
    return torch.mean(torch.clamp_min(logit, 0) - logit * target
                      + torch.log1p(torch.exp(-logit.abs())))


def mape(pred, true):
    return torch.mean((pred - true).abs() / torch.clamp_min(true.abs(), 1e-3))


def _aux_losses(v, e_pred, t_pred, img, labels, cfg, target):
    e_p, theta, ecal = labels
    v, e_pred, t_pred = (t.float() for t in (v, e_pred, t_pred))
    l_bce = bce_logits(v, target)
    l_e = mape(e_pred, e_p)
    l_t = torch.mean((t_pred - theta).abs())
    ecal_img = torch.sum(img, dim=(1, 2, 3, 4), dtype=torch.float32)
    l_ecal = mape(ecal_img, ecal)
    total = (l_bce + cfg.aux_energy_weight * l_e / 10.0
             + cfg.aux_angle_weight * l_t + cfg.aux_ecal_weight * l_ecal)
    return total, {"bce": l_bce, "e": l_e, "t": l_t, "ecal": l_ecal}, v


def disc_loss(d_params, g_out_or_real, labels, cfg, real: bool):
    v, e_pred, t_pred = discriminate(d_params, g_out_or_real, cfg)
    target = 1.0 if real else 0.0
    total, aux, v = _aux_losses(v, e_pred, t_pred, g_out_or_real, labels,
                                cfg, target)
    aux["acc"] = torch.mean(((v > 0) == (target > 0.5)).float())
    return total, aux


def gen_loss(g_params, d_params, noise, labels, cfg):
    e_p, theta, _ecal = labels
    img = generate(g_params, noise, e_p, theta, cfg)
    v, e_pred, t_pred = discriminate(d_params, img, cfg)
    total, aux, _ = _aux_losses(v, e_pred, t_pred, img, labels, cfg, 1.0)
    return total, aux
