"""Physics validation: calorimeter energy response, GAN vs Monte Carlo.

Host-side numpy comparisons (copies of the reference's, with the report
printed after training) plus the serving gate's accumulators:
:func:`profile_sums` runs on the device and the gate drains its sums once
per window into :func:`gate_report`.
"""
from __future__ import annotations

import numpy as np
import torch


def longitudinal_profile(images: np.ndarray) -> np.ndarray:
    """images: (B, X, Y, Z, 1) -> mean profile over z, normalised."""
    prof = np.asarray(images).sum(axis=(1, 2, 4)).mean(axis=0)
    return prof / max(prof.sum(), 1e-12)


def transverse_profile(images: np.ndarray, axis: str = "x") -> np.ndarray:
    a = {"x": (2, 3, 4), "y": (1, 3, 4)}[axis]
    prof = np.asarray(images).sum(axis=a).mean(axis=0)
    return prof / max(prof.sum(), 1e-12)


def energy_response(images: np.ndarray, e_p: np.ndarray) -> np.ndarray:
    return np.asarray(images).sum(axis=(1, 2, 3, 4)) / np.asarray(e_p)


def profile_divergence(p: np.ndarray, q: np.ndarray, eps=1e-9) -> float:
    """Symmetrised KL between two normalised profiles (scalar 'how far')."""
    p = np.clip(p, eps, None)
    q = np.clip(q, eps, None)
    p, q = p / p.sum(), q / q.sum()
    return float(0.5 * (np.sum(p * np.log(p / q)) + np.sum(q * np.log(q / p))))


def edge_ratio_error(p: np.ndarray, q: np.ndarray, edge_cells: int = 5) -> float:
    """Relative error of the edge mass (edges are orders of magnitude below
    the core, so drift shows there first)."""
    pe = p[:edge_cells].sum() + p[-edge_cells:].sum()
    qe = q[:edge_cells].sum() + q[-edge_cells:].sum()
    return float(abs(pe - qe) / max(qe, 1e-12))


def validation_report(gan_images, mc_images, gan_ep, mc_ep) -> dict:
    """Profile divergences and energy response of generated showers
    against Monte Carlo (host numpy), as printed after training."""
    rep = {}
    for name, fn in (("longitudinal", longitudinal_profile),
                     ("transverse_x", lambda im: transverse_profile(im, "x")),
                     ("transverse_y", lambda im: transverse_profile(im, "y"))):
        pg, pm = fn(gan_images), fn(mc_images)
        rep[f"{name}_kl"] = profile_divergence(pg, pm)
        rep[f"{name}_edge_err"] = edge_ratio_error(pg, pm)
    rg = energy_response(gan_images, gan_ep)
    rm = energy_response(mc_images, mc_ep)
    rep["response_mean_gan"] = float(rg.mean())
    rep["response_mean_mc"] = float(rm.mean())
    rep["response_rel_err"] = float(abs(rg.mean() - rm.mean())
                                    / max(rm.mean(), 1e-12))
    return rep


def profile_sums(images, e_p, mask=None) -> dict:
    """Masked per-batch profile accumulators, computed on the device.

    ``images``: (B, X, Y, Z, 1); ``mask``: (B,) — padded bucket rows
    contribute nothing.  Sum the returned tensors across steps and drain
    them once per gate window; normalised, the profiles equal what
    ``longitudinal_profile`` / ``transverse_profile`` give on the same
    (unpadded) events.
    """
    img = images.float()
    if mask is not None:
        m = mask.float()
        img = img * m[:, None, None, None, None]
        ep = e_p.float() * m
        n = m.sum()
    else:
        ep = e_p.float()
        n = torch.tensor(float(img.shape[0]), device=img.device)
    # per-event response summed (the reference weights events equally),
    # divided by the unmasked E_p: masked rows are already zero
    resp = img.sum(dim=(1, 2, 3, 4)) / torch.clamp_min(e_p.float(), 1e-12)
    return {
        "longitudinal": img.sum(dim=(1, 2, 4)).sum(dim=0),   # (Z,)
        "transverse_x": img.sum(dim=(2, 3, 4)).sum(dim=0),   # (X,)
        "transverse_y": img.sum(dim=(1, 3, 4)).sum(dim=0),   # (Y,)
        "response": resp.sum(),
        "e_cal": img.sum(),
        "e_p": ep.sum(),
        "count": n,
    }


def reference_profiles(images, e_p) -> dict:
    """The Monte-Carlo side of the serving gate (host numpy, computed once)."""
    return {
        "longitudinal": longitudinal_profile(images),
        "transverse_x": transverse_profile(images, "x"),
        "transverse_y": transverse_profile(images, "y"),
        "response_mean": float(np.mean(energy_response(images, e_p))),
    }


def gate_report(sums: dict, reference: dict) -> dict:
    """Drained (host) gate sums -> the training-time divergences against a
    fixed MC reference."""
    rep = {}
    for name in ("longitudinal", "transverse_x", "transverse_y"):
        prof = np.asarray(sums[name], np.float64)
        prof = prof / max(prof.sum(), 1e-12)
        rep[f"{name}_kl"] = profile_divergence(prof, reference[name])
        rep[f"{name}_edge_err"] = edge_ratio_error(prof, reference[name])
    resp = float(sums["response"]) / max(float(sums["count"]), 1e-12)
    rep["response_mean"] = resp
    rep["response_rel_err"] = float(abs(resp - reference["response_mean"])
                                    / max(reference["response_mean"], 1e-12))
    rep["count"] = float(sums["count"])
    return rep
