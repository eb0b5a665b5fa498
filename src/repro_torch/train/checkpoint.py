"""Checkpoints: nested dict of tensors <-> directory of npz + manifest.

The format is the reference's: arrays in one compressed ``arrays.npz``
keyed by the flattened path (``fc/w``, ``up0/gn/scale``) and a
``manifest.json`` with the step, the sorted keys and a caller's ``extra``
dict.  A generator saved by the reference's ``launch/train.py --ckpt``
loads here unchanged.  :func:`restore` is strict: a leaf missing on either
side, or a shape mismatch, raises with the offending keys.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def save(path: str, tree, step: int = 0, extra: dict = None):
    os.makedirs(path, exist_ok=True)
    arrays = _flatten(tree)
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    meta = {"step": int(step), "keys": sorted(arrays), "extra": extra or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(meta, f, indent=1)


def restore(path: str, template) -> dict:
    """Restore into the structure of ``template`` (a nested dict of
    tensors): each leaf takes its template's shape, dtype and device."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    flat_t = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat_t[f"{prefix}{k}"] = v
    walk(template)
    missing = [k for k in flat_t if k not in arrays]
    extra = sorted(set(arrays) - set(flat_t))
    if missing or extra:
        raise ValueError(
            f"checkpoint/template mismatch at {path}: "
            f"missing from checkpoint: {missing or 'none'}; "
            f"not in template: {extra or 'none'}")
    for key, leaf in flat_t.items():
        if tuple(arrays[key].shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt {arrays[key].shape} vs template "
                             f"{tuple(leaf.shape)}")

    def build(t, prefix=""):
        out = {}
        for k, v in t.items():
            key = f"{prefix}{k}"
            out[k] = (build(v, key + "/") if isinstance(v, dict) else
                      torch.as_tensor(arrays[key]).to(v.device, v.dtype))
        return out
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
