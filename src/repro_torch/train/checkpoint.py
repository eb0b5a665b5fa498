"""Checkpoints: nested dict of tensors <-> directory of npz + manifest.

The format is the reference's: arrays in one compressed ``arrays.npz``
keyed by the flattened path (``fc/w``, ``up0/gn/scale``) and a
``manifest.json`` with the step, the sorted keys and a caller's ``extra``
dict.  A list of per-layer dicts (an LM's ``blocks``, Zamba2's ``mamba``) is
written as the
reference writes its stacked layers: one array per leaf
(``blocks/attn/wq/w``) with a leading layer axis, cut back into the list
on restore.  What the reference's ``launch/train.py --ckpt`` saves loads
here unchanged, and the other way round.  :func:`restore` is strict: a
leaf missing on either side, or a shape mismatch, raises with the
offending keys.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _join(key, k):
    return f"{key}/{k}" if key else str(k)


def _flatten(tree, key="", out=None) -> dict:
    """``{path: array}`` of a tree of dicts, tensors (or numpy arrays) and
    lists of per-layer dicts (stacked on a leading layer axis)."""
    from repro_torch.convert import stack_layers
    out = {} if out is None else out
    if isinstance(tree, list) and tree:
        _flatten(stack_layers(tree), key, out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, _join(key, k), out)
    elif isinstance(tree, torch.Tensor):
        out[key] = tree.detach().cpu().numpy()
    elif isinstance(tree, np.ndarray):
        out[key] = tree
    else:
        raise TypeError(f"checkpoint leaf {key!r}: expected a dict, an array "
                        f"or a list of per-layer dicts, got "
                        f"{type(tree).__name__}")
    return out


def save(path: str, tree, step: int = 0, extra: dict = None):
    arrays = _flatten(tree)
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    meta = {"step": int(step), "keys": sorted(arrays), "extra": extra or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _shapes(t, key="", layers=None, out=None) -> dict:
    """``{path: shape}`` the checkpoint must hold for template ``t``; a
    list's leaves carry the number of layers in front."""
    out = {} if out is None else out
    if isinstance(t, list) and t and layers is None:
        _shapes(t[0], key, len(t), out)
    elif isinstance(t, dict):
        for k, v in t.items():
            _shapes(v, _join(key, k), layers, out)
    elif isinstance(t, torch.Tensor):
        out[key] = tuple(t.shape) if layers is None else (layers, *t.shape)
    else:
        raise TypeError(f"template leaf {key!r}: expected a dict, a tensor "
                        f"or a list of per-layer dicts, got "
                        f"{type(t).__name__}")
    return out


def restore(path: str, template) -> dict:
    """Restore into the structure of ``template`` (nested dicts of tensors,
    and lists of per-layer dicts): each leaf takes its template's shape,
    dtype and device."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    want = _shapes(template)
    missing = [k for k in want if k not in arrays]
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(
            f"checkpoint/template mismatch at {path}: "
            f"missing from checkpoint: {missing or 'none'}; "
            f"not in template: {extra or 'none'}")
    for key, shape in want.items():
        if tuple(arrays[key].shape) != shape:
            raise ValueError(f"{key}: ckpt {arrays[key].shape} vs template "
                             f"{shape}")

    def build(t, key="", layer=None):
        if isinstance(t, list):
            return [build(v, key, i) for i, v in enumerate(t)]
        if isinstance(t, dict):
            return {k: build(v, _join(key, k), layer) for k, v in t.items()}
        a = arrays[key] if layer is None else arrays[key][layer]
        return torch.as_tensor(a).to(t.device, t.dtype)
    return build(template)


def latest_step(path: str) -> int:
    return manifest(path)["step"]


def manifest(path: str) -> dict:
    """The checkpoint's manifest (step, keys, caller-supplied extra)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def manifest_precision(path: str, default: str = "f32") -> str:
    """The precision policy the checkpoint was trained under (manifests
    written without it default to f32)."""
    return manifest(path).get("extra", {}).get("precision", default)


def restore_gan_generator(path: str, cfg, device="cuda") -> dict:
    """Trained 3DGAN generator params for serving, restored strictly
    against the generator's structure for ``cfg`` (the serving config must
    be the training config)."""
    from repro_torch.core import gan
    template = gan.init_generator(torch.Generator().manual_seed(0), cfg,
                                  device)
    return restore(path, template)
