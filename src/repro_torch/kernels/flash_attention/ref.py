"""Plain PyTorch versions of the attention kernels.

Written from the reference's Pallas kernels (``decode.py`` ``_decode_kernel``
and ``combine_splits``, ``flash_attention.py`` ``_flash_chunk_kernel``,
``_flash_kernel``, ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``):
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


# ---------------------------------------------------------------------------
# training: the forward with its log-sum-exp, and the recompute backward
# ---------------------------------------------------------------------------


def train_mask(S: int, T: int, causal: bool, window: int, device):
    """(S, T) bool: query i sees key t when t <= i (causal) and, with a
    window, t > i - window (the reference's ``_tile_mask``)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def _scores(q, k):
    """f32 scores (B, KH, G, S, T) of q (B, S, H, D) against k (B, T, KH, D),
    query head ``kh * G + g``, scaled by 1 / sqrt(D)."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qg = q.float().reshape(B, S, KH, H // KH, D)
    return torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (1.0 / D ** 0.5)


def _rows(x, KH):
    """(B, S, H) per-row values -> (B, KH, G, S, 1), beside the scores."""
    B, S, H = x.shape
    return x.float().reshape(B, S, KH, H // KH).permute(0, 2, 3, 1)[..., None]


def flash_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal / windowed GQA attention over a whole sequence.

    q: (B, S, H, D); k/v: (B, T, KH, D).  Returns O (B, S, H, D) in q's
    dtype and the f32 log-sum-exp (B, S, H), head ``kh * G + g``.  A row
    that sees no key is exact zeros with lse = -1e30 + log(1e-30)."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    mask = train_mask(S, T, causal, window, q.device)
    s = _scores(q, k).masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", e, v.float()) \
        / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].permute(0, 3, 1, 2)     # (B, S, KH, G)
    return o.reshape(B, S, H, D).to(q.dtype), lse.reshape(B, S, H)


def attention_delta(o, do):
    """``rowsum(dO * O)`` in f32, (B, S, H): the softmax-jacobian row
    correction the backward kernels take (the reference computes it
    outside its kernels too)."""
    return (do.float() * o.float()).sum(dim=-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal, window):
    """The backward tile math on whole rows: p = exp(s - lse), exactly 0
    where masked, and ds = p * (dO . v - delta) * scale, both
    (B, KH, G, S, T) f32."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    mask = train_mask(S, T, causal, window, q.device)
    p = torch.where(mask, torch.exp(_scores(q, k) - _rows(lse, KH)),
                    torch.zeros((), device=q.device))
    dog = do.float().reshape(B, S, KH, H // KH, D)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    return p, p * (dp - _rows(delta, KH)) * (1.0 / D ** 0.5)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                     window: int = 0):
    """dq (B, S, H, D) in q's dtype: ds . k over the keys each row sees."""
    B, S, H, D = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float())
    return dq.reshape(B, S, H, D).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                      window: int = 0):
    """(dk, dv), each (B, T, KH, D) in k's dtype: ds^T . q and p^T . dO,
    summed over the G query heads of each KV head."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    qg = q.float().reshape(B, S, KH, H // KH, D)
    dog = do.float().reshape(B, S, KH, H // KH, D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)
