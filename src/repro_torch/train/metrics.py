"""Structured metric logging and the device-side windowed accumulator
behind the engine's async loop (the reference's `train/metrics.py`)."""
from __future__ import annotations

import json
import time
from typing import Optional

import torch


class MetricAccumulator:
    """Windowed metric accumulation WITHOUT per-step host syncs.

    ``update`` folds one step's scalar metric tensors into running sums on
    their device (queued work, no sync); ``means`` copies the whole window
    to the host once and returns floats.  Sums accumulate in f32 whatever
    the step emits: each increment is cast at ``update`` time.
    """

    def __init__(self):
        self.sums = None
        self.count = 0

    @staticmethod
    def _f32(metrics) -> dict:
        return {k: torch.as_tensor(v).to(torch.float32)
                for k, v in dict(metrics).items()}

    def update(self, metrics) -> None:
        self.count += 1
        m = self._f32(metrics)
        self.sums = m if self.sums is None else {
            k: self.sums[k] + m[k] for k in self.sums}

    def means(self) -> dict:
        """Host-side means of the current window (one device transfer)."""
        if not self.count:
            return {}
        keys = list(self.sums)
        host = torch.stack([self.sums[k].reshape(()) for k in keys]).cpu()
        return {k: float(v) / self.count for k, v in zip(keys, host)}

    def reset(self) -> None:
        self.sums = None
        self.count = 0


class MetricLog:
    def __init__(self, path: Optional[str] = None, print_every: int = 10):
        self.path = path
        self.print_every = print_every
        self.rows = []
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        row = {"step": step, "t": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self.rows.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(f"{k}={v:.4g}" for k, v in row.items()
                             if k not in ("step", "t"))
            print(f"[step {step:6d} t={row['t']:8.1f}s] {parts}", flush=True)

    def series(self, key: str):
        return [r[key] for r in self.rows if key in r]
