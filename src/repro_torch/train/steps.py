"""Train and serve steps shared by the language models (the reference's
``train/steps.py``).

``make_train_step`` is one training step: the loss and its gradients
(accumulated in f32 over microbatches), the global-norm clip and the
optimizer update.  The serving steps run the model and take the greedy
next token, the argmax over the vocabulary at the last position (the
first maximum on a tie, as ``jnp.argmax``).  The reference's mesh,
``grad_reduce`` and sequence sharding wait for the data-parallel slice.
"""
from __future__ import annotations

import torch

from repro_torch.optim import optimizers as opt_lib
from repro_torch.substrate.precision import tree_leaves, tree_map


def _split_microbatches(batch, n: int):
    """``n`` microbatches of ``batch``: rows [i * b / n, (i + 1) * b / n) of
    every leaf (the reference's reshape to a leading microbatch axis)."""
    b0 = batch["tokens"].shape[0]
    if b0 % n:
        raise ValueError(f"batch of {b0} does not split into {n} "
                         "microbatches")
    m = b0 // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


CLIP_NORM = 1.0  # the reference launcher's clip


def make_train_step(model, cfg, optimizer, policy, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: gradients of ``model.loss_fn`` (summed in f32 over
    ``microbatches`` in order, then divided by their number), clipped to
    ``CLIP_NORM`` by global norm, then the optimizer's update.  Metrics:
    ``loss``, ``grad_norm`` (before the clip) and, with one microbatch,
    the loss's own aux metrics."""

    def grad_of(params, mb):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = model.loss_fn(p, mb, cfg, policy=policy)
            # a leaf the loss never reads gets zeros, as jax.grad gives it
            # (Zamba2's shared attn/wo: the block projects through "out")
            flat = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                       materialize_grads=True)
        it = iter(flat)
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                tree_map(lambda _: next(it), params))

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            grads, loss = None, torch.zeros(())
            for mb in _split_microbatches(batch, microbatches):
                l, _, g = grad_of(params, mb)
                g = tree_map(lambda x: x.float(), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss.to(l.device) + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {}
        else:
            loss, metrics, grads = grad_of(params, batch)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, CLIP_NORM)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = opt_lib.apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


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
