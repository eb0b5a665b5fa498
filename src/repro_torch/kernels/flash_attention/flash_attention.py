"""Flash attention's wrappers: chunked prefill for serving, and the
training forward and its two backward kernels.

On a CUDA tensor each wrapper launches its kernel and adds one to its
count: :func:`flash_attention_chunk` ``csrc/flash_chunk.cu``
(:data:`LAUNCHES`), :func:`flash_attention_fwd` ``csrc/flash_fwd.cu``
(:data:`FWD_LAUNCHES`), :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
``csrc/flash_bwd.cu`` (:data:`DQ_LAUNCHES`, :data:`DKV_LAUNCHES`).  On a
CPU tensor each runs its plain version in ``ref.py``.  There is no
fallback from a kernel to its plain version.  ``ops.flash_attention``
wraps the training kernels as an autograd Function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.decode import check_inputs

# kernel launches made by flash_attention_chunk (one per launch)
LAUNCHES = 0
# kernel launches of the training kernels: flash_attention_fwd,
# flash_bwd_dq and flash_bwd_dkv (one per call each)
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/flash_chunk.cu's DType

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
MAX_ROWS = 64            # block_q * G score rows per block (csrc)
HEADS = (16, 32, 64, 128, 256)   # head sizes the kernel is built for
TRAIN_HEADS = (16, 32, 64, 128)  # head sizes the training kernels take
# training entry point -> (its source's stem, the number of its pointers)
_TRAIN_FNS = {"flash_fwd": ("flash_fwd", 5), "flash_bwd_dq": ("flash_bwd", 7),
              "flash_bwd_dkv": ("flash_bwd", 8)}


def chunk_block_q(G: int) -> int:
    """Queries per block: as many as fill :data:`MAX_ROWS` score rows with
    the G heads of one KV head."""
    return max(1, MAX_ROWS // G)


def _launch(q, k, v, q_offset, kv_len, window):
    global LAUNCHES
    from repro_torch.kernels import build
    B, C, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    if D not in HEADS or G > MAX_ROWS:
        raise ValueError(f"flash_chunk kernel takes D in {HEADS} and "
                         f"H / KH <= {MAX_ROWS}, got D={D}, G={G}")
    out = torch.empty_like(q)
    fn = build.load("flash_chunk").flash_chunk
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                q_offset.data_ptr(), kv_len.data_ptr(), out.data_ptr(), B, C,
                T, H, KH, D, chunk_block_q(G), window, 1.0 / D ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_chunk launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def flash_attention_chunk(q, k, v, q_offset, kv_len, *, window: int = 0):
    """Prompt-chunk attention against a ragged cache (serving prefill).

    q: (B, C, H, D), row i of slot b at absolute position
    ``q_offset[b] + i``; k/v: (B, T, KH, D) cache at capacity T, already
    holding this chunk's keys; kv_len: (B,) live length per row.  A row
    sees key t when t < kv_len, t <= its position and, with a window,
    t > its position - window; a row that sees none (an inactive slot,
    kv_len = 0) is exact zeros.  Returns (B, C, H, D) in q's dtype."""
    check_inputs(q, k, v, (q_offset, kv_len), "flash_attention_chunk")
    if q.device.type == "cpu":
        from repro_torch.kernels.flash_attention.ref import flash_chunk_ref
        return flash_chunk_ref(q, k, v, q_offset, kv_len, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_chunk runs on cuda (kernel) or "
                         f"cpu (plain version), not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_chunk kernel takes f32/bf16, got {q.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _launch(q, k, v, q_offset.to(torch.int32).contiguous(),
                   kv_len.to(torch.int32).contiguous(), window)


# ---------------------------------------------------------------------------
# training: forward with its log-sum-exp, dq, dk/dv
# ---------------------------------------------------------------------------


def _check_rows(x, q, name, what):
    if x.shape != q.shape[:3] or x.dtype != torch.float32 \
            or x.device != q.device:
        raise ValueError(f"{what}: {name} must be f32 {tuple(q.shape[:3])} "
                         f"(B, S, H) on {q.device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _train_kernel(q, what):
    """Raise unless q is a CUDA tensor of a dtype the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                         f"version), not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes f32/bf16, got {q.dtype}")


def _train_launch(name, q, k, tensors, causal, window):
    """Launch the training kernel ``name`` on the pointers of ``tensors``
    (inputs, then outputs, as its C signature lists them)."""
    from repro_torch.kernels import build
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    if D not in TRAIN_HEADS or G > MAX_ROWS:
        raise ValueError(f"{name} kernel takes D in {TRAIN_HEADS} and "
                         f"H / KH <= {MAX_ROWS}, got D={D}, G={G}")
    stem, n_ptr = _TRAIN_FNS[name]
    fn = getattr(build.load(stem), name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPES[q.dtype], *(t.data_ptr() for t in tensors), B, S, T,
                H, KH, D, chunk_block_q(G), int(causal), window,
                1.0 / D ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """Causal / windowed GQA attention over a whole sequence (training).

    q: (B, S, H, D); k/v: (B, T, KH, D).  Query i sees key t when t <= i
    (causal) and, with a window, t > i - window.  Returns O (B, S, H, D) in
    q's dtype and, when ``return_lse``, the f32 log-sum-exp (B, S, H), head
    ``kh * G + g`` (the backward's residual)."""
    global FWD_LAUNCHES
    check_inputs(q, k, v, (), "flash_attention_fwd")
    if q.device.type == "cpu":
        from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
        out, lse = flash_fwd_ref(q, k, v, causal=causal, window=window)
    else:
        _train_kernel(q, "flash_attention_fwd")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        _train_launch("flash_fwd", q, k, (q, k, v, out, lse), causal, window)
        FWD_LAUNCHES += 1
    return (out, lse) if return_lse else out


def _bwd_inputs(q, k, v, do, lse, delta, what):
    check_inputs(q, k, v, (), what)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{what}: do must be {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}, got {do.dtype} {tuple(do.shape)} on "
                         f"{do.device}")
    _check_rows(lse, q, "lse", what)
    _check_rows(delta, q, "delta", what)
    if q.device.type == "cpu":
        return None
    _train_kernel(q, what)
    return tuple(t.contiguous() for t in (q, k, v, do, lse, delta))


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 window: int = 0):
    """dq (B, S, H, D) in q's dtype, rebuilt from the forward's ``lse`` and
    ``delta`` = :func:`ref.attention_delta` (both (B, S, H) f32)."""
    global DQ_LAUNCHES
    args = _bwd_inputs(q, k, v, do, lse, delta, "flash_bwd_dq")
    if args is None:
        from repro_torch.kernels.flash_attention.ref import flash_bwd_dq_ref
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                window=window)
    dq = torch.empty_like(args[0])
    _train_launch("flash_bwd_dq", q, k, args + (dq,), causal, window)
    DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  window: int = 0):
    """(dk, dv), each (B, T, KH, D) in k's dtype, summed over the G query
    heads of each KV head."""
    global DKV_LAUNCHES
    args = _bwd_inputs(q, k, v, do, lse, delta, "flash_bwd_dkv")
    if args is None:
        from repro_torch.kernels.flash_attention.ref import flash_bwd_dkv_ref
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                                 window=window)
    dk, dv = torch.empty_like(args[1]), torch.empty_like(args[2])
    _train_launch("flash_bwd_dkv", q, k, args + (dk, dv), causal, window)
    DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """The recompute backward: ``o``/``lse`` are the forward's outputs.
    Returns (dq, dk, dv) in the operands' dtypes."""
    from repro_torch.kernels.flash_attention.ref import attention_delta
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                           window=window)
    return dq, dk, dv
