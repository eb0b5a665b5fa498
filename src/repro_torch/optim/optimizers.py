"""Optimizers as pure functions over nested dicts of tensors: SGD, Adam,
AdamW, RMSprop, the global-norm clip and the warmup-cosine schedule (the
reference's `optim/optimizers.py`, no optax).

Each optimizer is an :class:`Optimizer` pair ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; updates are ADDED to
params (they carry the negative sign).  State is f32 and lives on the
params' device; the step counter is an int32 scalar tensor, so a schedule
and a skipped update never sync the host.  The 3DGAN trains with RMSprop.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import torch

from repro_torch.substrate.precision import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


ScheduleOrFloat = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: ScheduleOrFloat, step):
    return lr(step) if callable(lr) else lr


def _zeros_like_float(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _step0(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------


def sgd(lr: ScheduleOrFloat, momentum: float = 0.0):
    def init(params):
        mu = _zeros_like_float(params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lrt = _lr_at(lr, step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return (tree_map(lambda m: -lrt * m, mu),
                    {"step": step, "mu": mu})
        return tree_map(lambda g: -lrt * g, grads), {"step": step, "mu": None}

    return Optimizer(init, update)


def adam(lr: ScheduleOrFloat, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    def init(params):
        return {"step": _step0(params), "m": _zeros_like_float(params),
                "v": _zeros_like_float(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lrt = _lr_at(lr, step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def u(m_, v_, p):
            upd = -lrt * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd - lrt * weight_decay * p.float()
            return upd.to(p.dtype)

        upds = (tree_map(u, m, v, params) if params is not None else
                tree_map(lambda m_, v_: u(m_, v_, m_), m, v))
        return upds, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr: ScheduleOrFloat, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def rmsprop(lr: ScheduleOrFloat, decay=0.9, eps=1e-8, momentum=0.0):
    """RMSprop, the 3DGAN training optimizer (keras-compatible math)."""
    def init(params):
        return {"step": _step0(params), "nu": _zeros_like_float(params),
                "mu": _zeros_like_float(params) if momentum else None}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lrt = _lr_at(lr, step)
        nu = tree_map(lambda n, g: decay * n + (1 - decay) * torch.square(
            g.float()), state["nu"], grads)
        scaled = tree_map(lambda g, n: g.float() / (torch.sqrt(n) + eps),
                          grads, nu)
        if momentum:
            mu = tree_map(lambda m, s: momentum * m + s, state["mu"], scaled)
            return (tree_map(lambda m: -lrt * m, mu),
                    {"step": step, "nu": nu, "mu": mu})
        return (tree_map(lambda s: -lrt * s, scaled),
                {"step": step, "nu": nu, "mu": None})

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# gradient transforms
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(g, 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads), g


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at step ``total``."""
    def schedule(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def get_optimizer(name: str, lr: ScheduleOrFloat, **kw) -> Optimizer:
    return {"sgd": sgd, "adam": adam, "adamw": adamw,
            "rmsprop": rmsprop}[name](lr, **kw)
