"""Mixed-precision policies: f32 master params, compute in ``compute_dtype``,
results in ``output_dtype``, and the dynamic loss scale with its
skip-on-nonfinite guard.

bf16 shares the f32 exponent range, so it needs no loss SCALING; the
adversarial step still runs the loss-scale state machine under bf16 with
``loss_scale=1``, so a diverging GAN phase never writes NaNs into the
master weights.  The fp16 policy scales up, halves on overflow and grows
back after ``growth_interval`` clean phases.  Trees are nested dicts of
tensors; the state lives on the device, and nothing here syncs the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (``None`` leaves
    stay None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32
    # dynamic loss scaling: 0 disables the state machine entirely; 1 runs
    # skip-on-nonfinite without amplification (bf16); >1 is the fp16 mode
    loss_scale: float = 0.0
    # clean phases between scale doublings (0: never grow, bf16 mode)
    growth_interval: int = 0

    def cast_to_compute(self, tree):
        """Floating leaves cast to ``compute_dtype`` (differentiable)."""
        return tree_map(lambda x: x.to(self.compute_dtype)
                        if x.is_floating_point() else x, tree)


DEFAULT = Policy(loss_scale=1.0)                      # bf16 compute
FULL = Policy(compute_dtype=torch.float32)            # f32 everywhere
FP16 = Policy(compute_dtype=torch.float16,
              loss_scale=2.0 ** 15, growth_interval=200)


def get_policy(name: str) -> Policy:
    return {"bf16": DEFAULT, "mixed": DEFAULT, "f32": FULL, "full": FULL,
            "fp16": FP16}[name]


def policy_name(policy: Policy) -> str:
    """Canonical name for a policy (the inverse of :func:`get_policy`)."""
    return {torch.bfloat16: "bf16", torch.float32: "f32",
            torch.float16: "fp16"}[policy.compute_dtype]


# ---------------------------------------------------------------------------
# dynamic loss scaling with skip-on-nonfinite
# ---------------------------------------------------------------------------


class LossScaleState(NamedTuple):
    """Device-resident dynamic-loss-scale state, carried in the train
    state."""
    scale: torch.Tensor        # f32 scalar, multiplies the loss
    good_steps: torch.Tensor   # int32: consecutive finite phases since a skip


def init_loss_scale(policy: Optional[Policy], device="cuda"
                    ) -> Optional[LossScaleState]:
    """The initial state, or None when the policy disables scaling."""
    if policy is None or not policy.loss_scale:
        return None
    return LossScaleState(
        torch.tensor(policy.loss_scale, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def all_finite(tree) -> torch.Tensor:
    """Scalar bool tensor: every leaf of ``tree`` is finite (the overflow
    check run on the UNSCALED gradients of each phase)."""
    leaves = [torch.isfinite(x).all() for x in tree_leaves(tree)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack(leaves).all()


def unscale(state: LossScaleState, tree):
    inv = 1.0 / state.scale
    return tree_map(lambda g: g.float() * inv, tree)


def next_loss_scale(state: LossScaleState, finite: torch.Tensor,
                    growth_interval: int) -> LossScaleState:
    """Halve on overflow; after ``growth_interval`` consecutive clean
    phases, double (never below 1, never grown when the interval is 0)."""
    good = torch.where(finite, state.good_steps + 1,
                       torch.zeros_like(state.good_steps))
    if growth_interval > 0:
        grow = good >= growth_interval
        scale = torch.where(grow, state.scale * 2.0, state.scale)
        good = torch.where(grow, torch.zeros_like(good), good)
    else:
        scale = state.scale
    scale = torch.where(finite, scale,
                        torch.clamp_min(state.scale * 0.5, 1.0))
    return LossScaleState(scale, good)


def select_finite(finite: torch.Tensor, new_tree, old_tree):
    """``new_tree`` where the phase was finite, else the untouched
    ``old_tree``: the skip that keeps nonfinite updates out of the master
    params and optimizer state."""
    return tree_map(lambda n, o: torch.where(finite, n, o), new_tree,
                    old_tree)
