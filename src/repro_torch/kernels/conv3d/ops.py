"""Public conv3d ops with the fused bias + activation epilogue, forward and
backward.

Both ops are ``torch.autograd.Function``s whose backward runs the kernels
too (the reference's ``custom_vjp`` pair in ``kernels/conv3d/ops.py``):

- dx is the forward kernel again, on the cotangent with spatially flipped,
  ci/co-swapped weights (`conv3d.conv3d_dx` / `conv3d_transpose_dx`);
- dw is the weight-gradient kernel (`conv3d.conv3d_dw` /
  `conv3d_transpose_dw`), f32, rounded once to the weight's dtype;
- db is a plain reduction of the epilogue cotangent, summed in f32.

The backward needs only the activation OUTPUT, saved from the forward:

    leaky_relu:  d/dz = where(y >= 0, 1, slope)        (y >= 0 <=> z >= 0)
    softplus:    d/dz = sigmoid(z) = 1 - exp(-y)       (y = log(1+e^z))

A gradient that autograd does not ask for is not computed: a frozen
network launches no dw kernel, an input that needs no gradient no dx.
The backward is not itself differentiable.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.conv3d import conv3d as conv_mod

ACTIVATIONS = ("none", "leaky_relu", "softplus")


def _act_grad_from_y(y, activation: str, slope: float):
    """d activation / d preactivation, recovered from the OUTPUT y."""
    if activation == "leaky_relu":
        return torch.where(y >= 0, torch.ones_like(y),
                           torch.full_like(y, slope))
    if activation == "softplus":
        return 1.0 - torch.exp(-y)          # = sigmoid(z); y >= 0 so stable
    raise ValueError(activation)


def _epilogue_cotangent(g, y, activation, slope):
    if activation == "none":
        return g.contiguous()
    return (g * _act_grad_from_y(y, activation, slope).to(g.dtype)) \
        .contiguous()


def _forward(ctx, geom, x, w, b, stride, activation, slope):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    x = x.contiguous()          # the kernels take dense NDHWC (a crop is not)
    y = geom["fwd"](x, w, b, stride, activation=activation, slope=slope)
    ctx.save_for_backward(x, w, y if activation != "none" else None)
    ctx.b_dtype = b.dtype if b is not None else None
    ctx.conf = (stride, activation, slope)
    return y


def _backward(ctx, geom, g):
    x, w, y = ctx.saved_tensors
    stride, activation, slope = ctx.conf
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    dz = _epilogue_cotangent(g, y, activation, slope)
    dx = dw = db = None
    if need_x:
        dx = geom["dx"](dz, w, stride, x.shape[1:4]).to(x.dtype)
    if need_w:
        dw = geom["dw"](x, dz, w.shape[:3], stride).to(w.dtype)
    if need_b:
        # f32 accumulation: a quarter-million-element sum of bf16 terms
        # drifts in bf16
        db = dz.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(ctx.b_dtype)
    return dx, dw, db, None, None, None


_CONV = {"fwd": conv_mod.conv3d_fwd, "dx": conv_mod.conv3d_dx,
         "dw": conv_mod.conv3d_dw}
_TCONV = {"fwd": conv_mod.conv3d_transpose_fwd,
          "dx": lambda dz, w, stride, _spatial:
              conv_mod.conv3d_transpose_dx(dz, w, stride),
          "dw": conv_mod.conv3d_transpose_dw}


class Conv3dBiasAct(torch.autograd.Function):
    """SAME conv + bias + activation (reference: ``conv3d_bias_act``)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, activation, slope):
        return _forward(ctx, _CONV, x, w, b, stride, activation, slope)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, _CONV, g)


class Conv3dTransposeBiasAct(torch.autograd.Function):
    """SAME transposed conv + bias + activation (reference:
    ``conv3d_transpose_bias_act``)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, activation, slope):
        return _forward(ctx, _TCONV, x, w, b, stride, activation, slope)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, _TCONV, g)


def conv3d_bias_act(x, w, b, stride: int = 1, activation: str = "none",
                    slope: float = 0.2):
    """Fused SAME conv + bias + activation; one kernel launch on a card,
    differentiable in x, w and b."""
    return Conv3dBiasAct.apply(x, w, b, stride, activation, slope)


def conv3d_transpose_bias_act(x, w, b, stride: int = 2,
                              activation: str = "none", slope: float = 0.2):
    """Fused SAME transposed conv + bias + activation, differentiable."""
    return Conv3dTransposeBiasAct.apply(x, w, b, stride, activation, slope)
