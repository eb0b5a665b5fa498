"""Zamba2 hybrid LM of the port: a Mamba2 backbone and ONE shared
attention + FFN block, training only (the reference's ``models/zamba.py``
``init``, ``forward`` and ``loss_fn``).

The shared block (one set of parameters, applied after layers 0, k, 2k,
... for k = ``cfg.shared_attn_every``) runs on concat(hidden, the initial
embedding) at width 2 * d_model and projects back to d_model.  ``mamba``
is a list of the ``n_layers`` per-layer dicts (the reference stacks them
on a leading axis for ``lax.scan``; ``convert.lm_to_numpy`` stacks them
back).  Each layer, with the shared block where it fires, is one
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(body)``): its
recompute runs the SSD forward kernel and the flash forward kernel again.
The initial embedding enters each checkpoint as an argument, so the
embedding's gradient gathers every shared application's share.

Serving (``init_cache``, ``decode_step``, ``prefill_chunk``, ``prefill``)
waits for ROADMAP.md, Queue 1, item 10.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.substrate import attention as attn_lib
from repro_torch.substrate import layers, ssm


def _shared_cfg(cfg):
    """Attention geometry of the shared block: runs at width 2*d_model."""
    return dataclasses.replace(
        cfg, d_model=2 * cfg.d_model, d_head=2 * cfg.d_model // cfg.n_heads,
        qkv_bias=False)


def init(gen: torch.Generator, cfg, device="cuda"):
    """Random parameters drawn from ``gen`` (the reference's scales; torch's
    stream, not JAX's), placed on ``device``."""
    scfg = _shared_cfg(cfg)
    d2 = 2 * cfg.d_model
    return {
        "embed": layers.init_embed(gen, cfg.vocab, cfg.d_model, device),
        "mamba": [{"ln": layers.init_norm(cfg.d_model, device, "rmsnorm"),
                   "m": ssm.init_mamba2(gen, cfg.d_model, cfg.ssm, device)}
                  for _ in range(cfg.n_layers)],
        "shared": {
            "ln": layers.init_norm(d2, device, "rmsnorm"),
            "attn": attn_lib.init_attn(gen, scfg, device),
            "out": layers.init_dense(gen, d2, cfg.d_model, device=device),
            "ln2": layers.init_norm(cfg.d_model, device, "rmsnorm"),
            "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, device,
                                   cfg.ffn_type),
        },
        "ln_f": layers.init_norm(cfg.d_model, device, "rmsnorm"),
        "head": {"w": layers.normal_init(gen, (cfg.d_model, cfg.vocab),
                                         device=device)},
    }


def _apply_shared(sp, x, x0, cfg, cos, sin):
    """The shared attention block on concat(x, x0), training (causal over
    the sequence); returns x with both residuals added."""
    scfg = _shared_cfg(cfg)
    B, S, _ = x.shape
    h = torch.cat([x, x0], dim=-1)
    h = layers.apply_norm(sp["ln"], h, norm_type="rmsnorm")
    q, k, v = attn_lib.project_qkv(sp["attn"], h, scfg)
    q, k = attn_lib.apply_rope(q, cos, sin), attn_lib.apply_rope(k, cos, sin)
    o = attn_lib.attend(q, k, v)
    o = layers.apply_dense(sp["out"], o.reshape(B, S, scfg.q_dim))
    x = x + o
    hn = layers.apply_norm(sp["ln2"], x, norm_type="rmsnorm")
    return x + layers.apply_ffn(sp["ffn"], hn, cfg.ffn_type)


def _layer(block, h, x0, shared, cos, sin, cfg):
    """One Mamba2 layer and, when ``shared`` is given, the shared block."""
    hn = layers.apply_norm(block["ln"], h, norm_type="rmsnorm")
    h = h + ssm.apply_mamba2(block["m"], hn, cfg.d_model, cfg.ssm)
    if shared is not None:
        h = _apply_shared(shared, h, x0, cfg, cos, sin)
    return h


def forward(params, tokens, cfg, *, policy):
    """tokens (B, S) int -> (final hidden states (B, S, d), aux 0, the
    parameters cast to the compute dtype)."""
    cparams = policy.cast_to_compute(params)
    x = layers.apply_embed(cparams["embed"], tokens.long(),
                           policy.compute_dtype)
    x0 = x
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device).expand(B, S)
    cos, sin = attn_lib.rope_cos_sin(pos, _shared_cfg(cfg).d_head,
                                     cfg.rope_theta, x.dtype)
    every = max(cfg.shared_attn_every, 1)
    for idx, block in enumerate(cparams["mamba"]):
        shared = cparams["shared"] if idx % every == 0 else None
        x = checkpoint(_layer, block, x, x0, shared, cos, sin, cfg,
                       use_reentrant=False)
    h = layers.apply_norm(cparams["ln_f"], x, norm_type="rmsnorm")
    return h, torch.zeros((), device=x.device), cparams


def loss_fn(params, batch, cfg, *, policy):
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S) through the
    untied head -> (loss, {"ce", "aux"})."""
    from repro_torch.models.lm import chunked_softmax_xent
    tokens = batch["tokens"]
    h, aux, cparams = forward(params, tokens, cfg, policy=policy)
    targets = tokens[:, 1:]
    valid = torch.ones(targets.shape, device=h.device)
    ce = chunked_softmax_xent(h[:, :-1], cparams["head"]["w"], targets, valid)
    return ce + aux, {"ce": ce, "aux": aux}
