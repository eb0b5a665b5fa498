"""Serving steps (a copy of the reference's ``train/steps.py``
``make_serve_step`` / ``make_prefill_chunk_step``): each runs the model and
takes the greedy next token, the argmax over the vocabulary at the last
position (the first maximum on a tie, as ``jnp.argmax``)."""
from __future__ import annotations

import torch


def make_serve_step(model, cfg, policy):
    def serve_step(params, tokens1, cache, pos):
        logits, cache = model.decode_step(params, tokens1, cache, pos, cfg,
                                          policy=policy)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_chunk_step(model, cfg, policy):
    """One launch ingests a (B, C) prompt chunk per slot (ragged ``lens``;
    0 = inactive slot) and returns each slot's next token, sampled from
    its last valid prompt position."""
    def prefill_chunk_step(params, tokens, cache, pos, lens):
        logits, cache = model.prefill_chunk(params, tokens, cache, pos, lens,
                                            cfg, policy=policy)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    return prefill_chunk_step
