"""Decoder-only language model of the dense family: training and serving.

A copy of the reference's ``models/lm.py`` for the dense family: ``init``,
the training forward (``apply_block``, ``backbone``, ``forward``, the
chunked cross-entropy and ``loss_fn``), the KV cache, one decode step and
one batched prefill chunk.  Parameters keep the reference's leaf names and
``(d_in, d_out)`` dense layouts; ``blocks`` is a list of the ``n_layers``
per-layer dicts (the reference stacks them on a leading axis for
``lax.scan``; the port runs a Python loop over the layers, and
``convert.lm_to_numpy`` stacks them back).  The cache is ``{"k", "v"}`` of
shape (L, B, T, KH, D), as in the reference.

The port writes the cache IN PLACE (the reference returns a new one):
``decode_step`` and ``prefill_chunk`` return the same tensors they were
given, updated.  Remat is ``torch.utils.checkpoint`` per block, whose
recompute runs the block's attention forward again.  Attention goes
through ``substrate.attention.attend``: the CUDA kernels on a card, their
plain versions on the CPU.

Other families (MoE, the VLM's M-RoPE) and sliding-window attention are
not ported yet: ``check_supported`` raises on them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.substrate import attention as attn_lib
from repro_torch.substrate import layers


def check_supported(cfg):
    """Raise unless ``cfg`` is what this module runs: the dense family with
    full causal attention, SwiGLU, rotary positions and tied embeddings."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} (arch '{cfg.arch_id}') is not "
            "ported yet: the port's LM runs the dense family (see ROADMAP.md)")
    if (cfg.sliding_window or cfg.ffn_type != "swiglu" or cfg.rope_theta <= 0
            or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"arch '{cfg.arch_id}' (sliding_window {cfg.sliding_window}, ffn "
            f"{cfg.ffn_type}, rope_theta {cfg.rope_theta}, tied "
            f"{cfg.tie_embeddings}) is not ported yet: the port's LM runs "
            "full causal attention, SwiGLU, rope and tied embeddings only "
            "(see ROADMAP.md)")


def init_block(gen: torch.Generator, cfg, device="cuda"):
    return {
        "ln1": layers.init_norm(cfg.d_model, device, cfg.norm_type),
        "attn": attn_lib.init_attn(gen, cfg, device),
        "ln2": layers.init_norm(cfg.d_model, device, cfg.norm_type),
        "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, device),
    }


def init(gen: torch.Generator, cfg, device="cuda"):
    """Random parameters drawn from ``gen`` (the reference's scales; torch's
    stream, not JAX's), placed on ``device``."""
    check_supported(cfg)
    return {
        "embed": layers.init_embed(gen, cfg.vocab, cfg.d_model, device),
        "blocks": [init_block(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "ln_f": layers.init_norm(cfg.d_model, device, cfg.norm_type),
    }


def _rope_for(cfg, positions, dtype):
    return attn_lib.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta, dtype)


def _head_matrix(params):
    """The LM head: the tied embedding, transposed."""
    return params["embed"]["emb"].T


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    """KV cache ``{"k", "v"}``, each (L, batch, max_len, KH, D) zeros."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ints(x, device, dtype=torch.int32):
    """``x`` (int, array or tensor) as a ``dtype`` tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _block(bp, h, cos, sin, cfg, attend):
    """One block over h (B, S, d): norm, QKV, rope, ``attend(q, k, v)``,
    output projection, FFN, both residuals."""
    B, S, _ = h.shape
    hn = layers.apply_norm(bp["ln1"], h, norm_type=cfg.norm_type)
    q, k, v = attn_lib.project_qkv(bp["attn"], hn, cfg)
    q = attn_lib.apply_rope(q, cos, sin)
    k = attn_lib.apply_rope(k, cos, sin)
    o = attend(q, k, v)
    h = h + layers.apply_dense(bp["attn"]["wo"], o.reshape(B, S, cfg.q_dim))
    hn = layers.apply_norm(bp["ln2"], h, norm_type=cfg.norm_type)
    return h + layers.apply_ffn(bp["ffn"], hn)


def _cached(kc, vc, write, **attend_kw):
    """Serving attention: ``write(cache_layer, new)`` the block's K and V
    into the layer's cache, then attend against the cache."""
    def attend(q, k, v):
        write(kc, k)
        write(vc, v)
        return attn_lib.attend(q, kc.to(q.dtype), vc.to(q.dtype),
                               **attend_kw)
    return attend


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def apply_block(p, x, cos, sin, cfg):
    """x: (B, S, d) -> x' (B, S, d), causal attention over the sequence."""
    return _block(p, x, cos, sin, cfg, attn_lib.attend)


def backbone(params, x, cfg, *, positions):
    """x: (B, S, d) embedded input -> final hidden states (B, S, d).  Each
    block is checkpointed (the reference launcher's remat): only its input
    is kept, and the backward recomputes the block (its attention kernel
    included)."""
    cos, sin = _rope_for(cfg, positions, x.dtype)
    for bp in params["blocks"]:
        x = checkpoint(apply_block, bp, x, cos, sin, cfg, use_reentrant=False)
    return layers.apply_norm(params["ln_f"], x, norm_type=cfg.norm_type)


def forward(params, tokens, cfg, *, policy):
    """tokens (B, S) int -> (final hidden states (B, S, d), aux, the
    parameters cast to the compute dtype).  Hidden states, not logits: the
    loss takes the head in chunks.  ``aux`` is the reference's MoE
    auxiliary loss, 0 for the dense family."""
    cparams = policy.cast_to_compute(params)
    x = layers.apply_embed(cparams["embed"], tokens.long(),
                           policy.compute_dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    h = backbone(cparams, x, cfg, positions=positions)
    return h, torch.zeros((), device=x.device), cparams


def chunked_softmax_xent(h, head_w, targets, valid, chunk=512):
    """Mean cross-entropy over the vocabulary, ``chunk`` positions of the
    (B, S, V) logits at a time (the reference's chunks: ``min(chunk, S)``
    each, then the remainder).

    h: (B, S, d) hidden; head_w: (d, V); targets: (B, S) int; valid: (B, S)
    f32 weights."""
    S = h.shape[1]
    chunk = min(chunk, S)
    loss_sum = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for s0 in range(0, S, chunk):
        hs, vs = h[:, s0:s0 + chunk], valid[:, s0:s0 + chunk]
        logits = (hs @ head_w.to(hs.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[:, s0:s0 + chunk, None].long())[..., 0]
        loss_sum = loss_sum + ((lse - tgt) * vs).sum()
        cnt = cnt + vs.sum()
    return loss_sum / cnt.clamp_min(1.0)


def loss_fn(params, batch, cfg, *, policy):
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S) -> (loss,
    {"ce", "aux"})."""
    tokens = batch["tokens"]
    h, aux, cparams = forward(params, tokens, cfg, policy=policy)
    targets = tokens[:, 1:]
    valid = torch.ones(targets.shape, device=h.device)
    ce = chunked_softmax_xent(h[:, :-1], _head_matrix(cparams), targets,
                              valid)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def decode_step(params, tokens1, cache, pos, cfg, *, policy):
    """One decode step.  tokens1: (B, 1); pos: scalar or (B,) per-row
    absolute positions (each slot decodes at its own depth); cache:
    {"k", "v"} (L, B, T, KH, D), updated in place.  Returns (logits
    (B, 1, V) f32, cache)."""
    cparams = policy.cast_to_compute(params)
    dev = cache["k"].device
    x = layers.apply_embed(cparams["embed"], _ints(tokens1, dev, torch.long),
                           policy.compute_dtype)
    B = x.shape[0]
    T = cache["k"].shape[2]
    pos_vec = _ints(pos, dev).expand(B)                        # (B,)
    cos, sin = _rope_for(cfg, pos_vec[:, None], x.dtype)
    # the reference's dynamic_update_slice clamps the index into the cache
    write_idx = pos_vec.clamp(0, T - 1).long()
    kv_len = (pos_vec + 1).clamp(max=T)
    rows = torch.arange(B, device=dev)

    def write(c, new):
        c[rows, write_idx] = new[:, 0].to(c.dtype)

    h = x
    for bp, kc, vc in zip(cparams["blocks"], cache["k"], cache["v"]):
        h = _block(bp, h, cos, sin, cfg,
                   _cached(kc, vc, write, kv_len=kv_len))
    h = layers.apply_norm(cparams["ln_f"], h, norm_type=cfg.norm_type)
    logits = h @ _head_matrix(cparams).to(h.dtype)
    return logits.float(), cache


def prefill_chunk(params, tokens, cache, pos, lens, cfg, *, policy):
    """Batched chunked prefill: C prompt positions for every active slot in
    one pass, K/V written straight into each slot's cache rows.

    tokens: (B, C); pos: (B,) cache position of each slot's chunk start;
    lens: (B,) valid tokens of the chunk per slot (0 = slot not
    prefilling: its cache rows are left bit-identical and its logits are
    unused; an idle slot's position may lie past T).  Requires
    pos + lens <= T on the rows with lens > 0.  The cache is updated in place;
    only positions [pos, pos + lens) of each row are written.  Returns
    (last-valid-token logits (B, 1, V) f32, cache)."""
    cparams = policy.cast_to_compute(params)
    dev = cache["k"].device
    x = layers.apply_embed(cparams["embed"], _ints(tokens, dev, torch.long),
                           policy.compute_dtype)
    B, C, _ = x.shape
    T = cache["k"].shape[2]
    # the write's indices on the host (from host pos / lens: no sync)
    pos_h = _ints(pos, "cpu")
    lens_h = _ints(lens, "cpu")
    if bool(((pos_h + lens_h > T) & (lens_h > 0)).any()):
        raise ValueError(f"chunk past the cache: pos {pos_h.tolist()} + lens "
                         f"{lens_h.tolist()} > {T}")
    wb, wi = (torch.arange(C)[None] < lens_h[:, None]).nonzero(as_tuple=True)
    wt = (pos_h[wb] + wi).to(dev)
    wb, wi = wb.to(dev), wi.to(dev)
    pos_d, lens_d = pos_h.to(dev), lens_h.to(dev)
    kv_len = pos_d + lens_d
    qpos = pos_d[:, None] + torch.arange(C, device=dev, dtype=torch.int32)
    cos, sin = _rope_for(cfg, qpos, x.dtype)

    def write(c, new):
        c[wb, wt] = new[wb, wi].to(c.dtype)

    h = x
    for bp, kc, vc in zip(cparams["blocks"], cache["k"], cache["v"]):
        h = _block(bp, h, cos, sin, cfg,
                   _cached(kc, vc, write, kv_len=kv_len, q_offset=pos_d))
    last = (lens_d.long() - 1).clamp(0, C - 1)
    h_last = h[torch.arange(B, device=dev), last][:, None]      # (B, 1, d)
    h_last = layers.apply_norm(cparams["ln_f"], h_last,
                               norm_type=cfg.norm_type)
    logits = h_last @ _head_matrix(cparams).to(h.dtype)
    return logits.float(), cache
