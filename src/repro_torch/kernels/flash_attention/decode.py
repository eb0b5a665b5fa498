"""Split-KV single-query decode attention for serving, and its wrapper.

On a CUDA tensor :func:`flash_decode` launches ``csrc/flash_decode.cu``
(the per-split partials, then a second small kernel that merges them) and
adds one to :data:`LAUNCHES`; on a CPU tensor it runs the plain version
(`ref.flash_decode_ref`) on the same split geometry.  There is no
fallback from the kernel to its plain version.

The split geometry is :func:`decode_schedule` of the cache capacity T and
the head size D alone, never of the live lengths, so a row's result does
not depend on how full the other slots are.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel launches made by flash_decode (one per call, counting the
# partials kernel and the merge kernel of that call together)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/flash_decode.cu's DType
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
SPLIT_POSITIONS = 64     # positions per split when the cache allows it
MAX_SPLITS = 16          # splits per (row, KV head) at most
MAX_HEAD = 256           # shared memory holds (G + 32) rows of D floats
MAX_GROUP = 64


def decode_schedule(T: int, D: int):
    """(block_kv, num_splits) for a cache of capacity ``T`` and head size
    ``D``: splits of :data:`SPLIT_POSITIONS` positions, at most
    :data:`MAX_SPLITS` of them (longer splits for longer caches).  The
    tile is 64 positions while D <= 128 and shrinks above, so a split's
    tiles stay whole."""
    block_kv = max(16, min(SPLIT_POSITIONS, 8192 // max(D, 1)))
    n_blocks = -(-T // block_kv)
    return block_kv, max(1, min(MAX_SPLITS, n_blocks))


def _launch(q, k, v, kv_len, window, block_kv, num_splits):
    global LAUNCHES
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ref import split_geometry
    B, _, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    if D > MAX_HEAD or G > MAX_GROUP:
        raise ValueError(f"flash_decode kernel takes D <= {MAX_HEAD} and "
                         f"H / KH <= {MAX_GROUP}, got D={D}, G={G}")
    split, n_splits = split_geometry(T, block_kv, num_splits)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, KH, n_splits, G, D), **f32)
    m = torch.empty((B, KH, n_splits, G), **f32)
    l = torch.empty((B, KH, n_splits, G), **f32)
    out = torch.empty_like(q)
    fn = build.load("flash_decode").flash_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_len.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                out.data_ptr(), B, T, H, KH, D, split, n_splits, window,
                1.0 / D ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def check_inputs(q, k, v, lengths, what):
    """Raise unless q (B, S, H, D), k/v (B, T, KH, D) with KH | H share
    one device and one dtype, and every tensor in ``lengths`` is (B,)
    integer on that device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} (B,S,H,D), k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (B,T,KH,D) "
                         "do not fit")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    for t in lengths:
        if t.shape != (q.shape[0],) or t.device != q.device \
                or t.is_floating_point():
            raise ValueError(f"{what}: lengths must be ({q.shape[0]},) "
                             f"integers on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def flash_decode(q, k, v, kv_len, *, window: int = 0,
                 block_kv: Optional[int] = None,
                 num_splits: Optional[int] = None):
    """Single-query decode attention against a ragged KV cache.

    q: (B, 1, H, D); k/v: (B, T, KH, D) cache at capacity T; kv_len: (B,)
    per-row live lengths (the query lives at position kv_len - 1).
    Returns (B, 1, H, D) in q's dtype.  The split geometry is
    :func:`decode_schedule` unless (block_kv, num_splits) are given."""
    check_inputs(q, k, v, (kv_len,), "flash_decode")
    if q.shape[1] != 1:
        raise ValueError(f"flash_decode is single-query (got S={q.shape[1]})")
    sched = decode_schedule(k.shape[1], q.shape[3])
    block_kv = block_kv or sched[0]
    num_splits = num_splits or sched[1]
    if q.device.type == "cpu":
        from repro_torch.kernels.flash_attention.ref import flash_decode_ref
        return flash_decode_ref(q, k, v, kv_len, window=window,
                                block_kv=block_kv, num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda (kernel) or cpu (plain "
                         f"version), not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode kernel takes f32/bf16, got {q.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    return _launch(q, k, v, kv_len, window, block_kv, num_splits)
