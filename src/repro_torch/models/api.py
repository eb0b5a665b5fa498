"""Model API of the port: the training and serving functions of one
architecture family, under the reference's ``models/api.py`` names.

The dense language-model family is ported for training and serving, the
hybrid family (Zamba2) for training: its serving fields raise, naming the
ROADMAP item they wait for.  ``get_model`` raises for the other families.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import lm


class Model(NamedTuple):
    init: Callable
    loss_fn: Callable
    init_cache: Callable
    decode_step: Callable
    prefill_chunk: Callable          # chunked batched prefill


def _serving_waits(cfg):
    def refuse(*_, **__):
        raise NotImplementedError(
            f"serving arch '{cfg.arch_id}' ({cfg.family} family) waits for "
            "zamba serving (ROADMAP.md, Queue 1, item 10); the port trains "
            "it")
    return refuse


def get_model(cfg) -> Model:
    if cfg.family == "hybrid":
        from repro_torch.models import zamba
        refuse = _serving_waits(cfg)
        return Model(zamba.init, zamba.loss_fn, refuse, refuse, refuse)
    lm.check_supported(cfg)
    return Model(lm.init, lm.loss_fn, lm.init_cache, lm.decode_step,
                 lm.prefill_chunk)
