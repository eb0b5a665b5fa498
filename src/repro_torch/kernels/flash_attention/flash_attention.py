"""Chunked-prefill attention for serving, and its wrapper.

On a CUDA tensor :func:`flash_attention_chunk` launches
``csrc/flash_chunk.cu`` and adds one to :data:`LAUNCHES`; on a CPU tensor
it runs the plain version (`ref.flash_chunk_ref`).  There is no fallback
from the kernel to its plain version.  The training kernels of the
reference's module (``_flash_kernel`` and its backward) are not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.decode import check_inputs

# kernel launches made by flash_attention_chunk (one per launch)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/flash_chunk.cu's DType

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
MAX_ROWS = 64            # block_q * G score rows per block (csrc)
HEADS = (16, 32, 64, 128, 256)   # head sizes the kernel is built for


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
