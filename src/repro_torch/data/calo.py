"""Synthetic electromagnetic-calorimeter Monte Carlo (numpy).

A copy of the reference's simulator, used here as the serving gate's
Monte-Carlo reference: 3-D energy-deposit images (X, Y, Z) conditioned on
the primary energy E_p and incidence angle theta, with a gamma
longitudinal profile, a two-gaussian core+halo transverse profile tilted
by theta, and per-cell fluctuations plus sampling noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CaloSpec:
    image_shape: tuple = (51, 51, 25)
    e_min: float = 10.0        # GeV
    e_max: float = 500.0
    theta_min: float = np.deg2rad(60.0)
    theta_max: float = np.deg2rad(120.0)
    moliere_core: float = 1.1  # cells
    moliere_halo: float = 3.5
    halo_frac: float = 0.18
    sampling_frac: float = 0.025   # ECAL measures ~2.5% of E_p


class CaloSimulator:
    def __init__(self, spec: CaloSpec = CaloSpec(), seed: int = 0):
        self.spec = spec
        self.rng = np.random.default_rng(seed)

    def sample_labels(self, n: int):
        s = self.spec
        e_p = self.rng.uniform(s.e_min, s.e_max, n).astype(np.float32)
        theta = self.rng.uniform(s.theta_min, s.theta_max, n).astype(np.float32)
        return e_p, theta

    def generate(self, n: int):
        """Returns images (n, X, Y, Z), e_p (n,), theta (n,), ecal (n,)."""
        s = self.spec
        X, Y, Z = s.image_shape
        e_p, theta = self.sample_labels(n)

        z = np.arange(Z, dtype=np.float32) + 0.5
        x = np.arange(X, dtype=np.float32) + 0.5
        y = np.arange(Y, dtype=np.float32) + 0.5

        # longitudinal gamma profile, shower max ~ log(E)
        a = 2.0 + 0.6 * np.log(e_p / 10.0)[:, None]          # (n, 1)
        b = (a - 1.0) / (0.45 * Z * (1.0 + 0.08 * np.log(e_p / 100.0)[:, None]))
        long_prof = np.power(z[None], a - 1.0) * np.exp(-b * z[None])
        long_prof /= long_prof.sum(axis=1, keepdims=True)    # (n, Z)

        # shower axis tilted in x-z by theta (90 deg = perpendicular)
        x0, y0 = X / 2.0, Y / 2.0
        slope = np.tan(theta - np.pi / 2.0)[:, None]         # (n, 1)
        cx = x0 + slope * (z[None] - Z / 2.0)                # (n, Z)

        dx2 = (x[None, :, None] - cx[:, None, :]) ** 2       # (n, X, Z)
        dy2 = ((y - y0) ** 2)[None, :, None]                 # (1, Y, 1)

        def gauss(d2, sig):
            return np.exp(-d2 / (2 * sig * sig)) / (np.sqrt(2 * np.pi) * sig)

        tx = (1 - s.halo_frac) * gauss(dx2, s.moliere_core) \
            + s.halo_frac * gauss(dx2, s.moliere_halo)       # (n, X, Z)
        ty = (1 - s.halo_frac) * gauss(dy2, s.moliere_core) \
            + s.halo_frac * gauss(dy2, s.moliere_halo)       # (1, Y, 1)

        img = (e_p * s.sampling_frac)[:, None, None, None] \
            * long_prof[:, None, None, :] * tx[:, :, None, :] * ty[None]
        # per-cell fluctuations + sampling noise
        img *= self.rng.gamma(20.0, 1 / 20.0, size=img.shape)
        img += self.rng.normal(0.0, 2e-5, size=img.shape)
        img = np.clip(img, 0.0, None).astype(np.float32)
        ecal = img.sum(axis=(1, 2, 3)).astype(np.float32)
        return img, e_p, theta, ecal

    def batches(self, batch: int, skip: int = 0):
        """Endless batch stream; ``skip`` discards the first N batches (a
        resumed stream yields exactly what a fresh one yields from there)."""
        for _ in range(skip):
            self.generate(batch)
        while True:
            img, e_p, theta, ecal = self.generate(batch)
            yield {"image": img[..., None],      # (B, X, Y, Z, 1) NDHWC
                   "e_p": e_p, "theta": theta, "ecal": ecal}
