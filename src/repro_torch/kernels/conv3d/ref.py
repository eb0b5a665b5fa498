"""Plain PyTorch versions of the conv3d kernel and its entry points.

:func:`conv_core_ref` computes what ``csrc/conv3d_fwd.cu`` computes, the
straightforward way: explicit zero-insertion dilation, ``F.pad`` with the
exact pads (negative crops), ``F.conv3d`` on a channels-first view, then
bias and activation.  For bf16/fp16 it takes the operands rounded to the
compute dtype, computes in f32 and rounds once at the end, as the kernel
does.  (The reference's Pallas interpret mode upcasts the activations the
same way but feeds the weights and bias in f32; on the TPU they are
rounded to the compute dtype first, as here.)  The CPU path and the tests
use it; on the card it is what the kernel is held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv3d.conv3d import same_pads, transpose_pads


def _act_ref(y, activation: str, slope: float):
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, y * slope)
    if activation == "softplus":
        return torch.clamp_min(y, 0) + torch.log1p(torch.exp(-y.abs()))
    if activation != "none":
        raise ValueError(activation)
    return y


def conv_core_ref(x, w, b=None, *, stride: int, pads, in_dilation: int = 1,
                  activation: str = "none", slope: float = 0.2):
    """Plain version of `conv3d.conv_core` (same arguments, same result)."""
    dtype = x.dtype
    xf = x.float()
    wf = w.to(dtype).float()
    if in_dilation > 1:
        s = in_dilation
        N, D, H, W, C = xf.shape
        xd = xf.new_zeros((N, (D - 1) * s + 1, (H - 1) * s + 1,
                           (W - 1) * s + 1, C))
        xd[:, ::s, ::s, ::s] = xf
        xf = xd
    (dl, dh), (hl, hh), (wl, wh) = pads
    xc = F.pad(xf.permute(0, 4, 1, 2, 3), (wl, wh, hl, hh, dl, dh))
    y = F.conv3d(xc, wf.permute(4, 3, 0, 1, 2), stride=stride)
    y = y.permute(0, 2, 3, 4, 1)
    if b is not None:
        y = y + b.to(dtype).float()
    return _act_ref(y, activation, slope).to(dtype).contiguous()


def conv3d_bias_act_ref(x, w, b, stride: int = 1, activation: str = "none",
                        slope: float = 0.2):
    """SAME conv + bias + activation, plain."""
    pads = tuple(same_pads(L, k, stride)[:2]
                 for L, k in zip(x.shape[1:4], w.shape[:3]))
    return conv_core_ref(x, w, b, stride=stride, pads=pads,
                         activation=activation, slope=slope)


def conv3d_transpose_bias_act_ref(x, w, b, stride: int = 2,
                                  activation: str = "none",
                                  slope: float = 0.2):
    """SAME transposed conv (kernel unflipped) + bias + activation, plain."""
    pads = tuple(transpose_pads(k, stride) for k in w.shape[:3])
    return conv_core_ref(x, w, b, stride=1, pads=pads, in_dilation=stride,
                         activation=activation, slope=slope)
