"""conv3d geometry, the CUDA kernel's wrapper and the forward entry points.

Every conv of the port reduces to :func:`conv_core` with some (stride,
pads, input dilation): the SAME forward conv, and the SAME transposed conv
as an input-dilated stride-1 conv with the kernel UNFLIPPED, exactly as
``lax.conv_transpose(..., "SAME")`` and the reference's
``conv3d_transpose_fwd`` do (this is not ``nn.ConvTranspose3d``).

On a CUDA tensor :func:`conv_core` launches ``csrc/conv3d_fwd.cu`` and adds
one to :data:`LAUNCHES`; on a CPU tensor it runs the plain version
(`ref.conv_core_ref`).  There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

# kernel launches made by conv_core (one per launch, nowhere else)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACTS = {"none": 0, "leaky_relu": 1, "softplus": 2}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17
             + [ctypes.c_float, ctypes.c_void_p])


# ---------------------------------------------------------------------------
# padding geometry
# ---------------------------------------------------------------------------


def same_pads(size: int, k: int, stride: int):
    """TF-style SAME padding for one spatial dim -> (lo, hi, out); the odd
    pad goes on the high side."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return pad // 2, pad - pad // 2, out


def transpose_pads(k: int, stride: int):
    """lax.conv_transpose 'SAME' rule for the dilated-input stride-1 conv."""
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def out_dims(in_spatial, kdims, *, stride: int, pads, in_dilation: int = 1):
    """Output sizes of the conv over the dilated, padded input (negative
    pads crop): ``(Lp - K) // stride + 1`` per dim."""
    outs = []
    for L, k, (lo, hi) in zip(in_spatial, kdims, pads):
        lp = (L - 1) * in_dilation + 1 + lo + hi
        outs.append((lp - k) // stride + 1)
    return tuple(outs)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _launch(x, w, b, *, stride, pads, in_dilation, activation, slope):
    global LAUNCHES
    from repro_torch.kernels import build
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d kernel takes f32/bf16/fp16, got {x.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype} on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 5 or w.dim() != 5 or w.shape[3] != x.shape[4] \
            or b.shape != (w.shape[4],):
        raise ValueError(f"shapes x {tuple(x.shape)} (N,D,H,W,Ci), w "
                         f"{tuple(w.shape)} (KD,KH,KW,Ci,Co), b "
                         f"{tuple(b.shape)} (Co,) do not fit")
    if stride < 1 or in_dilation < 1:
        raise ValueError(f"stride {stride} and dilation {in_dilation} must "
                         "be >= 1")
    N, D, H, W, Ci = x.shape
    KD, KH, KW, _, Co = w.shape
    OD, OH, OW = out_dims((D, H, W), (KD, KH, KW), stride=stride, pads=pads,
                          in_dilation=in_dilation)
    if min(N, OD, OH, OW, Co, Ci) <= 0:
        raise ValueError(f"empty conv: output {(N, OD, OH, OW, Co)}, Ci {Ci}")
    y = torch.empty((N, OD, OH, OW, Co), dtype=x.dtype, device=x.device)
    lib = build.load("conv3d_fwd")
    fn = lib.conv3d_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPES[x.dtype], _ACTS[activation], x.data_ptr(),
                w.data_ptr(), b.data_ptr(), y.data_ptr(), N, D, H, W, Ci,
                OD, OH, OW, Co, KD, KH, KW, stride, in_dilation,
                pads[0][0], pads[1][0], pads[2][0], float(slope), stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_fwd launch failed: cudaError {rc}")
    LAUNCHES += 1
    return y


def conv_core(x, w, b=None, *, stride: int, pads, in_dilation: int = 1,
              activation: str = "none", slope: float = 0.2):
    """Conv of ``x`` (N, D, H, W, Ci) dilated by ``in_dilation`` and padded
    by ``pads`` ((lo, hi),)*3 (negative crops) with ``w`` (KD, KH, KW, Ci,
    Co) at ``stride``, plus bias and activation -> (N, OD, OH, OW, Co) in
    ``x.dtype``.  ``w`` and ``b`` are cast to ``x.dtype`` first; sums and
    the epilogue run in f32 and round once at the store."""
    if activation not in _ACTS:
        raise ValueError(f"activation {activation!r} not in {tuple(_ACTS)}")
    if x.device.type == "cpu":
        from repro_torch.kernels.conv3d.ref import conv_core_ref
        return conv_core_ref(x, w, b, stride=stride, pads=pads,
                             in_dilation=in_dilation, activation=activation,
                             slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    w = w.to(x.dtype).contiguous()
    b = (torch.zeros((w.shape[-1],), dtype=x.dtype, device=x.device)
         if b is None else b.to(x.dtype).contiguous())
    return _launch(x, w, b, stride=stride, pads=pads, in_dilation=in_dilation,
                   activation=activation, slope=slope)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def conv3d_fwd(x, w, b=None, stride: int = 1, *, activation: str = "none",
               slope: float = 0.2):
    """SAME conv + bias + activation.  x: (N, D, H, W, Ci); w: (KD, KH, KW,
    Ci, Co); optional bias (Co,)."""
    pads = tuple(same_pads(L, k, stride)[:2]
                 for L, k in zip(x.shape[1:4], w.shape[:3]))
    return conv_core(x.contiguous(), w, b, stride=stride, pads=pads,
                     activation=activation, slope=slope)


def conv3d_transpose_fwd(x, w, b=None, stride: int = 2, *,
                         activation: str = "none", slope: float = 0.2):
    """SAME transposed conv = input dilation + the stride-1 conv, kernel
    unflipped; output spatial dims = input * stride."""
    pads = tuple(transpose_pads(k, stride) for k in w.shape[:3])
    return conv_core(x.contiguous(), w, b, stride=1, pads=pads,
                     in_dilation=stride, activation=activation, slope=slope)
