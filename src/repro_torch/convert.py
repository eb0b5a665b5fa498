"""Generator parameters between numpy trees and tensors.

The reference's parameters are nested dicts of arrays; handed over as
numpy (``jax.device_get`` or a checkpoint), :func:`generator_from_numpy`
turns them into the port's nested dict of f32 tensors with the same leaf
names and layouts, so both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch


def generator_from_numpy(tree, device="cuda") -> dict:
    """Nested dict of arrays -> nested dict of f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: generator_from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def generator_to_numpy(params) -> dict:
    """Nested dict of tensors -> nested dict of f32 numpy arrays."""
    if isinstance(params, dict):
        return {k: generator_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
