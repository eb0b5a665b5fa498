"""Plain PyTorch versions of the conv3d kernels and their entry points.

:func:`conv_core_ref` computes what ``csrc/conv3d_fwd.cu`` computes, the
straightforward way: explicit zero-insertion dilation, ``F.pad`` with the
exact pads (negative crops), ``F.conv3d`` on a channels-first view, then
bias and activation.  For bf16/fp16 it takes the operands rounded to the
compute dtype, computes in f32 and rounds once at the end, as the kernel
does.  (The reference's Pallas interpret mode upcasts the activations the
same way but feeds the weights and bias in f32; on the TPU they are
rounded to the compute dtype first, as here.)  :func:`conv_dw_core_ref`
computes what ``csrc/conv3d_dw.cu`` computes: for each tap, the strided
slice of the same dilated, padded input contracted with the cotangent
over every position, in f32.  :func:`gemm_ref` computes what
``csrc/gemm.cu`` computes: the product of the operands in f32, rounded
once to the output dtype; :func:`gemm_err` is the one rule that holds a
GEMM's output against another.  The CPU path and the tests use them; on
the card they are what the kernels are held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv3d.conv3d import (_flip_t, dx_pads, same_pads,
                                               transpose_dx_pads,
                                               transpose_pads)


def _act_ref(y, activation: str, slope: float):
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, y * slope)
    if activation == "softplus":
        return torch.clamp_min(y, 0) + torch.log1p(torch.exp(-y.abs()))
    if activation != "none":
        raise ValueError(activation)
    return y


def _dilate_pad(xf, pads, in_dilation: int):
    """``xf`` (N, D, H, W, C) dilated by ``in_dilation`` and padded by
    ``pads`` (negative crops), as channels-first (N, C, D', H', W')."""
    if in_dilation > 1:
        s = in_dilation
        N, D, H, W, C = xf.shape
        xd = xf.new_zeros((N, (D - 1) * s + 1, (H - 1) * s + 1,
                           (W - 1) * s + 1, C))
        xd[:, ::s, ::s, ::s] = xf
        xf = xd
    (dl, dh), (hl, hh), (wl, wh) = pads
    # contiguous channels-first: the CPU conv is ~100x slower on the
    # channels-last strides a permute leaves
    return F.pad(xf.permute(0, 4, 1, 2, 3).contiguous(),
                 (wl, wh, hl, hh, dl, dh))


def conv_core_ref(x, w, b=None, *, stride: int, pads, in_dilation: int = 1,
                  activation: str = "none", slope: float = 0.2):
    """Plain version of `conv3d.conv_core` (same arguments, same result)."""
    dtype = x.dtype
    wf = w.to(dtype).float()
    xc = _dilate_pad(x.float(), pads, in_dilation)
    y = F.conv3d(xc, wf.permute(4, 3, 0, 1, 2).contiguous(), stride=stride)
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


def conv_dw_core_ref(x, g, kdims, *, stride: int, pads, in_dilation: int = 1):
    """Plain version of `conv3d.conv_dw_core`: dw[kd, kh, kw] = the tap's
    strided patches of the dilated, padded input, transposed, times g,
    summed over every output position in f32 (g is cast to ``x.dtype``
    first) -> f32 (KD, KH, KW, Ci, Co)."""
    xp = _dilate_pad(x.float(), pads, in_dilation)       # (N, Ci, D', H', W')
    gf = g.to(x.dtype).float()
    N, OD, OH, OW, Co = gf.shape
    g2 = gf.reshape(-1, Co)
    s = stride
    taps = []
    for kd in range(kdims[0]):
        for kh in range(kdims[1]):
            for kw in range(kdims[2]):
                patch = xp[:, :, kd:kd + (OD - 1) * s + 1:s,
                           kh:kh + (OH - 1) * s + 1:s,
                           kw:kw + (OW - 1) * s + 1:s]
                taps.append(patch.permute(1, 0, 2, 3, 4).reshape(
                    xp.shape[1], -1) @ g2)                # (Ci, Co)
    return torch.stack(taps).reshape(*kdims, xp.shape[1], Co)


def gemm_ref(x, w, out_dtype=None):
    """Plain version of `conv3d.gemm`: (M, K) @ (K, N) in f32, cast to
    ``out_dtype`` (default ``x.dtype``)."""
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


# a GEMM's f32 output is held to GEMM_TOL of the case's largest |output|
# (two f32 sums in another order, K up to 8960); a bf16 output to one bf16
# spacing at it plus GEMM_TOL of the largest (the two f32 sums differ by up
# to the latter and each rounds to bf16 once: where a sum cancels to near
# zero the spacing is finer than that difference)
GEMM_TOL = 1e-5


def bf16_spacing(v):
    """The bf16 spacing at each |v|: 2^(e - 8) for |v| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(v.abs().float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def gemm_err(got, want):
    """(error, within tolerance) of a GEMM output ``got`` against ``want``:
    for an f32 ``want`` the largest difference over the largest |want|,
    within GEMM_TOL; for a bf16 one the largest difference in units of its
    allowance, one bf16 spacing plus GEMM_TOL of the largest, within 1."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    largest = float(w.abs().max())
    if want.dtype == torch.float32:
        err = float(diff.max()) / max(largest, 1e-30)
        return err, err <= GEMM_TOL
    allow = bf16_spacing(torch.maximum(g.abs(), w.abs())) + GEMM_TOL * largest
    err = float((diff / allow).max())
    return err, err <= 1.0


def conv3d_dx(g, w, stride: int, in_spatial):
    """dx of the SAME stride-s conv, plain (`conv3d.conv3d_dx`)."""
    return conv_core_ref(g, _flip_t(w), None, stride=1,
                         pads=dx_pads(in_spatial, w.shape[:3], stride),
                         in_dilation=stride)


def conv3d_dw(x, g, kdims, stride: int):
    """dw of the SAME stride-s conv, plain (`conv3d.conv3d_dw`)."""
    pads = tuple(same_pads(L, k, stride)[:2]
                 for L, k in zip(x.shape[1:4], kdims))
    return conv_dw_core_ref(x, g, kdims, stride=stride, pads=pads)


def conv3d_transpose_dx(g, w, stride: int):
    """dx of the SAME transposed conv, plain (`conv3d.conv3d_transpose_dx`)."""
    return conv_core_ref(g, _flip_t(w), None, stride=stride,
                         pads=transpose_dx_pads(w.shape[:3], stride))


def conv3d_transpose_dw(x, g, kdims, stride: int):
    """dw of the SAME transposed conv, plain (`conv3d.conv3d_transpose_dw`)."""
    pads = tuple(transpose_pads(k, stride) for k in kdims)
    return conv_dw_core_ref(x, g, kdims, stride=1, pads=pads,
                            in_dilation=stride)
