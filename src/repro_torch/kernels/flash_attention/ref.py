"""Plain PyTorch versions of the serving attention kernels.

Written from the reference's Pallas kernels (``decode.py`` ``_decode_kernel``
and ``combine_splits``, ``flash_attention.py`` ``_flash_chunk_kernel``):
the same masks, f32 score and softmax math, the same split structure for
decode (unnormalised per-split ``(acc, m, l)`` merged by log-sum-exp) and
exact zeros for rows that see no key.  The scores are materialised, so
these are references, not fast paths: a CPU tensor takes them, and the
card's main path never calls them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_partials_ref(q, k, v, kv_len, *, window: int = 0,
                        block_kv: int, num_splits: int):
    """Per-split online-softmax partials of single-query decode.

    q: (B, 1, H, D); k/v: (B, T, KH, D); kv_len: (B,) int.  The cache is
    cut into ``n_splits`` runs of ``blocks_per_split * block_kv``
    positions, as the kernel cuts it.  Returns ``acc`` (B, KH, S, G, D)
    and ``m``, ``l`` (B, KH, S, G), f32; an empty split is (0, NEG_INF, 0).
    """
    B, _, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    split, n_splits = split_geometry(T, block_kv, num_splits)
    pad = n_splits * split - T
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(B, n_splits, split, KH, D)
    vf = vf.reshape(B, n_splits, split, KH, D)
    qg = q[:, 0].float().reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bsthd->bhsgt", qg, kf) * (1.0 / D ** 0.5)
    kpos = torch.arange(n_splits * split, device=q.device).reshape(
        n_splits, split)
    kvl = kv_len.to(q.device).long()[:, None, None]
    mask = kpos[None] < kvl                                  # (B, S, t)
    if window:
        mask = mask & (kpos[None] > kvl - 1 - window)
    mask = mask[:, None, :, None, :]                         # (B,1,S,1,t)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    e = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = e.sum(dim=-1)
    acc = torch.einsum("bhsgt,bsthd->bhsgd", e, vf)
    return acc, m, l


def combine_splits_ref(acc, m, l):
    """Merge per-split partials: acc (..., S, G, D), m/l (..., S, G) ->
    normalised (..., G, D).  Empty splits (l == 0) weigh exactly 0."""
    m_glob = m.amax(dim=-2)
    w = torch.exp(m - m_glob[..., None, :])
    w = torch.where(l > 0, w, torch.zeros_like(w))
    l_glob = (l * w).sum(dim=-2)
    o = (acc * w[..., None]).sum(dim=-3)
    return o / l_glob.clamp_min(1e-30)[..., None]


def flash_decode_ref(q, k, v, kv_len, *, window: int = 0, block_kv: int,
                     num_splits: int):
    """Single-query decode attention against a ragged cache -> (B, 1, H, D)
    in q's dtype (the query sits at position ``kv_len - 1``)."""
    B, _, H, D = q.shape
    acc, m, l = decode_partials_ref(q, k, v, kv_len, window=window,
                                    block_kv=block_kv, num_splits=num_splits)
    return combine_splits_ref(acc, m, l).reshape(B, 1, H, D).to(q.dtype)


def flash_chunk_ref(q, k, v, q_offset, kv_len, *, window: int = 0):
    """Prompt-chunk attention against a ragged cache.

    q: (B, C, H, D), row i at absolute position ``q_offset[b] + i``; k/v:
    (B, T, KH, D) holding the chunk's keys; kv_len: (B,) live length.
    Key t is seen by row i when ``t < kv_len``, ``t <= q_offset + i`` and,
    with a window, ``t > q_offset + i - window``.  Rows that see no key
    are exact zeros.  Returns (B, C, H, D) in q's dtype."""
    B, C, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.float().reshape(B, C, KH, G, D)
    s = torch.einsum("bckgd,btkd->bkgct", qg, k.float()) * (1.0 / D ** 0.5)
    qpos = q_offset.to(q.device).long()[:, None] + torch.arange(
        C, device=q.device)[None]                             # (B, C)
    kpos = torch.arange(T, device=q.device)
    mask = (kpos[None, None] < kv_len.to(q.device).long()[:, None, None]) \
        & (qpos[:, :, None] >= kpos[None, None])
    if window:
        mask = mask & (kpos[None, None] > qpos[:, :, None] - window)
    mask = mask[:, None, None]                                # (B,1,1,C,T)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgct,btkd->bckgd", e, v.float())
    o = o / l.permute(0, 3, 1, 2, 4).clamp_min(1e-30)
    return o.reshape(B, C, H, D).to(q.dtype)


def split_geometry(T: int, block_kv: int, num_splits: int):
    """(positions per split, number of splits) of a cache of capacity T cut
    as the reference's ``flash_decode`` cuts it: tiles of ``block_kv``
    (at most T), ``num_splits`` runs of whole tiles, no empty trailing
    run."""
    block_kv = max(1, min(block_kv, T))
    n_blocks = -(-T // block_kv)
    blocks_per_split = -(-n_blocks // max(1, num_splits))
    n_splits = -(-n_blocks // blocks_per_split)
    return blocks_per_split * block_kv, n_splits
