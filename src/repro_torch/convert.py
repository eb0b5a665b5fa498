"""Parameter and state trees between numpy and tensors.

The reference's parameters, optimizer states and train state are nested
dicts of arrays.  Handed over as numpy (``jax.device_get`` or a
checkpoint), :func:`tree_from_numpy` turns any such tree into tensors
with the same leaf names, layouts and dtypes, :func:`state_from_numpy`
builds the port's ``GANState`` from the reference's fields, and
:func:`generator_from_numpy` carries a generator over as f32 for serving,
:func:`lm_from_numpy` a language model's parameters and
:func:`lm_state_from_numpy` its AdamW train state; :func:`lm_to_numpy`
goes back, stacking the per-layer ``blocks`` (dense) or ``mamba``
(Zamba2) as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.substrate.precision import tree_leaves, tree_map


def tree_from_numpy(tree, device="cuda"):
    """Nested dict of arrays -> nested dict of tensors on ``device``, each
    with its array's dtype (``None`` leaves stay ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree)).to(device)


def tree_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    return tree.detach().cpu().numpy()


def state_from_numpy(g_params, d_params, g_opt, d_opt, step, loss_scale=None,
                     device="cuda"):
    """The port's ``GANState`` from the reference's fields as numpy trees;
    ``loss_scale`` is ``(scale, good_steps)`` or None."""
    from repro_torch.core.adversarial import GANState
    from repro_torch.substrate.precision import LossScaleState
    ls = None
    if loss_scale is not None:
        scale, good = loss_scale
        ls = LossScaleState(
            torch.tensor(float(np.asarray(scale)), dtype=torch.float32,
                         device=device),
            torch.tensor(int(np.asarray(good)), dtype=torch.int32,
                         device=device))
    return GANState(
        tree_from_numpy(g_params, device), tree_from_numpy(d_params, device),
        tree_from_numpy(g_opt, device), tree_from_numpy(d_opt, device),
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        ls)


def generator_from_numpy(tree, device="cuda") -> dict:
    """Nested dict of arrays -> nested dict of f32 tensors on ``device``."""
    return tree_map(lambda t: t.float(), tree_from_numpy(tree, device))


def generator_to_numpy(params) -> dict:
    """Nested dict of tensors -> nested dict of f32 numpy arrays."""
    return tree_to_numpy(tree_map(lambda t: t.float(), params))


# the key of a language model's tree whose leaves the reference stacks on a
# leading layer axis: the dense LM's blocks, Zamba2's Mamba2 layers
STACKED_KEYS = ("blocks", "mamba")


def lm_from_numpy(tree, device="cuda") -> dict:
    """The reference's ``init`` tree of a language model (``models/lm``'s or
    ``models/zamba``'s, as numpy) -> the port's parameters on ``device``:
    the same leaves, dtypes and ``(d_in, d_out)`` layouts, with the leaves
    of the stacked key (``blocks`` or ``mamba``, a leading layer axis) cut
    into a list of per-layer dicts."""
    out = {}
    for k, v in tree.items():
        if k not in STACKED_KEYS:
            out[k] = tree_from_numpy(v, device)
            continue
        stacked = tree_from_numpy(v, device)
        n_layers = len(tree_leaves(stacked)[0])
        out[k] = [tree_map(lambda t, i=i: t[i].contiguous(), stacked)
                  for i in range(n_layers)]
    return out


def stack_layers(blocks) -> dict:
    """A list of per-layer dicts -> one dict whose leaves are the layers'
    tensors stacked on a leading layer axis, on the CPU (the reference's
    ``blocks`` and ``mamba`` layout)."""
    return tree_map(lambda *ts: torch.stack([t.detach().cpu() for t in ts]),
                    blocks[0], *blocks[1:])


def lm_to_numpy(params) -> dict:
    """The port's LM parameters -> the reference's ``init`` tree as numpy:
    the per-layer list stacked on a leading layer axis (the inverse of
    :func:`lm_from_numpy`)."""
    return {k: tree_to_numpy(stack_layers(v) if k in STACKED_KEYS else v)
            for k, v in params.items()}


def lm_state_from_numpy(params, opt_state, device="cuda"):
    """The port's ``LMState`` from the reference's LM (dense or Zamba2)
    params and AdamW state (``{"step", "m", "v"}``, ``m`` and ``v`` shaped
    like the params) as numpy trees."""
    from repro_torch.train.engine import LMState
    opt = {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                dtype=torch.int32, device=device),
           "m": lm_from_numpy(opt_state["m"], device),
           "v": lm_from_numpy(opt_state["v"], device)}
    return LMState(lm_from_numpy(params, device), opt)
