"""Model API of the port: the training and serving functions of one
architecture family, under the reference's ``models/api.py`` names.

Only the dense language-model family is ported; ``get_model`` raises for
the others.
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


def get_model(cfg) -> Model:
    lm.check_supported(cfg)
    return Model(lm.init, lm.loss_fn, lm.init_cache, lm.decode_step,
                 lm.prefill_chunk)
