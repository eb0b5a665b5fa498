"""conv3d geometry, the CUDA kernels' wrappers and the entry points.

Every conv of the port reduces to :func:`conv_core` with some (stride,
pads, input dilation): the SAME forward conv, and the SAME transposed conv
as an input-dilated stride-1 conv with the kernel UNFLIPPED, exactly as
``lax.conv_transpose(..., "SAME")`` and the reference's
``conv3d_transpose_fwd`` do (this is not ``nn.ConvTranspose3d``).  The dx
of either conv is :func:`conv_core` again, on the cotangent with flipped,
ci/co-swapped weights; the dw of either is :func:`conv_dw_core` over the
same (stride, pads, dilation) as its forward pass.

On a CUDA tensor :func:`conv_core` launches ``csrc/conv3d_fwd.cu`` and adds
one to :data:`LAUNCHES`, and :func:`conv_dw_core` launches
``csrc/conv3d_dw.cu`` and adds one to :data:`DW_LAUNCHES`; on a CPU tensor
each runs its plain version (`ref.conv_core_ref`, `ref.conv_dw_core_ref`).
The standalone :func:`gemm` launches ``csrc/gemm.cu`` on a CUDA tensor and
adds one to :data:`GEMM_LAUNCHES`; on a CPU tensor it runs `ref.gemm_ref`.
There is no fallback from a kernel to its plain version.
"""
from __future__ import annotations

import ctypes

import torch

# kernel launches made by conv_core / conv_dw_core / gemm (one per launch,
# nowhere else)
LAUNCHES = 0
DW_LAUNCHES = 0
GEMM_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACTS = {"none": 0, "leaky_relu": 1, "softplus": 2}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17
             + [ctypes.c_float, ctypes.c_void_p])
_DW_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 18 + [ctypes.c_void_p])
# blocks the dw kernel aims for (weight tiles x splits of the positions)
# and the fewest positions a split takes: a few blocks per SM of an H100
DW_TARGET_BLOCKS = 512
DW_MIN_SPLIT = 256
DW_TILE = 256                # weights per block (csrc/conv3d_dw.cu)
_GEMM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GEMM_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                  + [ctypes.c_int64] * 3 + [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# standalone GEMM
# ---------------------------------------------------------------------------


def gemm(x, w, *, out_dtype=None):
    """(M, K) @ (K, N) summed in f32 and rounded once to ``out_dtype``
    (default ``x.dtype``).  ``x`` and ``w`` are both f32 or both bf16 on
    one device; ``out_dtype`` is f32 or bf16.  A non-contiguous operand is
    made contiguous first."""
    global GEMM_LAUNCHES
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm takes (M, K) @ (K, N), got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if x.dtype not in _GEMM_DTYPES or w.dtype != x.dtype \
            or out_dtype not in _GEMM_DTYPES:
        raise TypeError(f"gemm takes two f32 or two bf16 operands and an f32 "
                        f"or bf16 output, got {x.dtype} @ {w.dtype} -> "
                        f"{out_dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    M, K = x.shape
    N = w.shape[1]
    if min(M, K, N) <= 0:
        raise ValueError(f"empty gemm: M {M}, K {K}, N {N}")
    if x.device.type == "cpu":
        from repro_torch.kernels.conv3d.ref import gemm_ref
        return gemm_ref(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gemm runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    from repro_torch.kernels import build
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    fn = build.load("gemm").gemm
    fn.argtypes, fn.restype = _GEMM_ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_GEMM_DTYPES[x.dtype], _GEMM_DTYPES[out_dtype], x.data_ptr(),
                w.data_ptr(), y.data_ptr(), M, K, N, stream)
    if rc != 0:
        raise RuntimeError(f"gemm launch failed: cudaError {rc}")
    GEMM_LAUNCHES += 1
    return y


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


def dx_pads(in_spatial, kdims, stride: int):
    """Pads of the dx route of the SAME stride-``stride`` conv: its
    cotangent dilated by the stride, through the flipped weights at stride
    1 (a negative high pad crops)."""
    pads = []
    for L, k in zip(in_spatial, kdims):
        lo, _hi, out = same_pads(L, k, stride)
        pads.append((k - 1 - lo, L + lo - 1 - (out - 1) * stride))
    return tuple(pads)


def transpose_dx_pads(kdims, stride: int):
    """Pads of the dx route of the SAME transposed conv: a stride-``stride``
    conv of its cotangent through the flipped weights."""
    pads = []
    for k in kdims:
        pa, _pb = transpose_pads(k, stride)
        pads.append((k - 1 - pa, pa + 1 - stride))
    return tuple(pads)


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


def dw_splits(positions: int, n_weights: int) -> int:
    """How many f32 partials the dw kernel splits its sum over
    ``positions`` into: enough blocks to fill the card
    (:data:`DW_TARGET_BLOCKS` over the weight tiles), no split shorter than
    :data:`DW_MIN_SPLIT` positions.  A function of the shapes only, so the
    summation order, and with it every bit of dw, is fixed."""
    tiles = -(-n_weights // DW_TILE)
    want = -(-DW_TARGET_BLOCKS // tiles)
    return max(1, min(want, -(-positions // DW_MIN_SPLIT), 65535))


def _launch_dw(x, g, kdims, *, stride, pads, in_dilation):
    global DW_LAUNCHES
    from repro_torch.kernels import build
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d_dw kernel takes f32/bf16/fp16, got {x.dtype}")
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"g must be {x.dtype} on {x.device}, got {g.dtype} "
                         f"on {g.device}")
    for name, t in (("x", x), ("g", g)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if stride < 1 or in_dilation < 1:
        raise ValueError(f"stride {stride} and dilation {in_dilation} must "
                         "be >= 1")
    if x.dim() != 5 or g.dim() != 5 or len(kdims) != 3:
        raise ValueError(f"shapes x {tuple(x.shape)} (N,D,H,W,Ci), g "
                         f"{tuple(g.shape)} (N,OD,OH,OW,Co), taps {kdims}")
    N, D, H, W, Ci = x.shape
    Co = g.shape[-1]
    KD, KH, KW = kdims
    outs = out_dims((D, H, W), kdims, stride=stride, pads=pads,
                    in_dilation=in_dilation)
    if tuple(g.shape[:4]) != (N, *outs):
        raise ValueError(f"shapes do not fit: g {tuple(g.shape)} for output "
                         f"{(N, *outs, Co)} of x {tuple(x.shape)}")
    gather_g = stride == 1          # sum over input positions (see the .cu)
    positions = N * D * H * W if gather_g else N * outs[0] * outs[1] * outs[2]
    n_weights = KD * KH * KW * Ci * Co
    splits = dw_splits(positions, n_weights)
    partial = torch.empty((splits, n_weights), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((KD, KH, KW, Ci, Co), dtype=torch.float32,
                     device=x.device)
    lib = build.load("conv3d_dw")
    fn = lib.conv3d_dw
    fn.argtypes, fn.restype = _DW_ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPES[x.dtype], int(gather_g), x.data_ptr(), g.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), N, D, H, W, Ci, *outs, Co,
                KD, KH, KW, stride, in_dilation, pads[0][0], pads[1][0],
                pads[2][0], splits, stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_dw launch failed: cudaError {rc}")
    DW_LAUNCHES += 1
    return dw


def conv_dw_core(x, g, kdims, *, stride: int, pads, in_dilation: int = 1):
    """Weight gradient of :func:`conv_core` with the same (stride, pads,
    in_dilation): ``x`` (N, D, H, W, Ci) the conv's input, ``g`` (N, OD,
    OH, OW, Co) its output cotangent (cast to ``x.dtype`` first, as the
    reference does) -> f32 (KD, KH, KW, Ci, Co), summed in f32."""
    if x.device.type == "cpu":
        from repro_torch.kernels.conv3d.ref import conv_dw_core_ref
        return conv_dw_core_ref(x, g, kdims, stride=stride, pads=pads,
                                in_dilation=in_dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_dw runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    return _launch_dw(x, g.to(x.dtype), tuple(kdims), stride=stride,
                      pads=pads, in_dilation=in_dilation)


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


def _flip_t(w):
    """Spatially flipped, ci/co-swapped weights for the dx routes."""
    return w.flip((0, 1, 2)).transpose(3, 4)


def conv3d_dx(g, w, stride: int, in_spatial):
    """dx of the SAME stride-s conv: a transposed conv through the same
    kernel (g dilated by s, flipped/swapped weights, stride 1)."""
    return conv_core(g.contiguous(), _flip_t(w), None, stride=1,
                     pads=dx_pads(in_spatial, w.shape[:3], stride),
                     in_dilation=stride)


def conv3d_dw(x, g, kdims, stride: int):
    """dw of the SAME stride-s conv: patches^T . g, f32."""
    pads = tuple(same_pads(L, k, stride)[:2]
                 for L, k in zip(x.shape[1:4], kdims))
    return conv_dw_core(x, g, kdims, stride=stride, pads=pads)


def conv3d_transpose_dx(g, w, stride: int):
    """dx of the SAME transposed conv: a stride-s conv of the cotangent
    with flipped/swapped weights through the same kernel."""
    return conv_core(g.contiguous(), _flip_t(w), None, stride=stride,
                     pads=transpose_dx_pads(w.shape[:3], stride))


def conv3d_transpose_dw(x, g, kdims, stride: int):
    """dw of the SAME transposed conv: the same patches^T . g over the
    dilated input, f32."""
    pads = tuple(transpose_pads(k, stride) for k in kdims)
    return conv_dw_core(x, g, kdims, stride=1, pads=pads,
                        in_dilation=stride)
