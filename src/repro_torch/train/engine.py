"""Training engine of the port: one device, the paper's fused loop.

The reference's engine (`train/engine.py`) runs its tasks (Algorithm 1,
or any LM through ``steps.make_train_step``) data-parallel over a mesh in
two loop strategies, ``builtin`` (jit + GSPMD) and ``custom`` (shard_map +
explicit psum).  On one device the two are the same program; the port has
the single-device ``builtin`` loop: the task's step (``gan_task``: the
fused step of `core/adversarial.py`; ``lm_task``: `train/steps.py`), a
host-to-device prefetch one batch ahead, and windowed metric logging with
one host transfer per window.  The ``custom`` loop, meshes and ZeRO-1 wait
for the data-parallel slice (ROADMAP.md, Queue 1).

Usage::

    from repro_torch.configs import calo3dgan
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import engine as engine_lib

    cfg = calo3dgan.reduced()
    task = engine_lib.gan_task(cfg, opt_lib.rmsprop(1e-4),
                               opt_lib.rmsprop(1e-4))
    eng = engine_lib.Engine("cuda")
    state, metrics = eng.fit(task, sim.batches(cfg.batch_size), steps=100,
                             seed=0)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.substrate.rng import MASK64, mix_seed
from repro_torch.train import metrics as metrics_lib

def step_seed(seed: int, gstep: int) -> int:
    """Seed of global step ``gstep``'s generator: a splitmix64 mix of
    (seed, gstep), the counterpart of ``fold_in(step_rng, gstep)``.  A
    resumed fit (same seed, ``start_step`` = completed steps) replays the
    noise of an uninterrupted one."""
    return mix_seed(seed, gstep)


def init_seed(seed: int) -> int:
    """Seed of the generator the initial params are drawn from (a stream
    no step uses)."""
    return mix_seed(seed, MASK64)


@dataclasses.dataclass(frozen=True)
class Task:
    """A trainable workload: ``init(gen, device) -> state`` and
    ``make_step(grad_reduce=None) -> step(state, batch, gen) -> (state,
    metrics)``."""
    name: str
    init: Callable[[torch.Generator, Any], Any]
    make_step: Callable[..., Callable]


def gan_task(cfg, g_optimizer, d_optimizer, *, policy=None,
             microbatches: int = 1) -> Task:
    """The paper's workload: 3DGAN Algorithm 1 as a fused step."""
    from repro_torch.core import adversarial

    def init(gen, device):
        return adversarial.init_state(gen, cfg, g_optimizer, d_optimizer,
                                      policy=policy, device=device)

    def make_step(grad_reduce=None):
        return adversarial.make_fused_step(
            cfg, g_optimizer, d_optimizer, policy=policy,
            grad_reduce=grad_reduce, microbatches=microbatches)

    return Task("gan", init, make_step)


class LMState(NamedTuple):
    """An LM's train state carried through the engine loop."""
    params: Any
    opt_state: Any


def lm_task(model, cfg, optimizer, *, policy,
            microbatches: int = 1) -> Task:
    """Any ported LM architecture through ``steps.make_train_step`` (clip
    at 1.0).  The LM loss is deterministic given the batch: the step's
    generator is unused."""
    from repro_torch.train import steps as steps_lib

    def init(gen, device):
        params = model.init(gen, cfg, device)
        return LMState(params, optimizer.init(params))

    def make_step(grad_reduce=None):
        if grad_reduce is not None:
            raise NotImplementedError(
                "grad_reduce waits for the data-parallel slice (ROADMAP.md, "
                "Queue 1)")
        inner = steps_lib.make_train_step(model, cfg, optimizer, policy,
                                          microbatches=microbatches)

        def step(state, batch, gen):
            params, opt_state, metrics = inner(state.params, state.opt_state,
                                               batch)
            return LMState(params, opt_state), metrics

        return step

    return Task("lm", init, make_step)


class Prefetcher:
    """Host batches (dicts of numpy arrays) to the device, one batch
    ahead of the consumer.

    On a card each batch goes through pinned host memory and a
    ``non_blocking`` copy on a side stream, so the copy of batch i+1
    overlaps step i; the consumer's stream waits for the copy's event
    before it reads the batch.  ``stats``: ``h2d_wait_ms``, host time the
    loop waited for the host iterator; ``put_ms``, host time spent pinning
    and issuing the copies.
    """

    def __init__(self, batches: Iterable[dict], device, limit: int):
        self.it = iter(batches)
        self.device = torch.device(device)
        self.left = limit
        self.stats = {"h2d_wait_ms": 0.0, "put_ms": 0.0}
        self.cuda = self.device.type == "cuda"
        self.copy_stream = (torch.cuda.Stream(self.device) if self.cuda
                            else None)
        self.pending = self._put()

    def _put(self):
        if self.left <= 0:
            return None
        t0 = time.perf_counter()
        try:
            host = next(self.it)
        except StopIteration:
            return None
        t1 = time.perf_counter()
        self.left -= 1
        tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in host.items()}
        if self.cuda:
            with torch.cuda.stream(self.copy_stream):
                dev = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in tensors.items()}
                ready = torch.cuda.Event()
                ready.record(self.copy_stream)
        else:
            dev = {k: v.to(self.device) for k, v in tensors.items()}
            ready = None
        self.stats["h2d_wait_ms"] += 1e3 * (t1 - t0)
        self.stats["put_ms"] += 1e3 * (time.perf_counter() - t1)
        return dev, ready

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self.pending is None:
            raise StopIteration
        batch, ready = self.pending
        if ready is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(ready)
            for v in batch.values():
                v.record_stream(main)
        self.pending = self._put()
        return batch


class Engine:
    """Single-device training engine (the launcher's ``--loop builtin``).
    ``device`` defaults to the card; ``"cpu"`` runs every conv through its
    plain version."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu' for the "
                               "plain path")
        self.last_fit_stats = {"steps": 0, "host_transfers": 0,
                               "h2d_wait_ms": 0.0, "h2d_put_ms": 0.0,
                               "h2d_wait_ms_windows": []}

    def init_state(self, task: Task, seed: int):
        gen = torch.Generator().manual_seed(init_seed(seed))
        return task.init(gen, self.device)

    def step_generator(self, seed: int, gstep: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            step_seed(seed, gstep))

    def fit(self, task: Task, batches: Iterable[dict], steps: int, *,
            seed: int, state=None, log=None, log_every: int = 1,
            sync_every: Optional[int] = None, start_step: int = 0,
            hooks: tuple = ()):
        """Run ``steps`` training steps; returns (state, last_metrics).

        Per-step metrics fold into device-side sums and reach the host
        once every ``log_every`` steps (``log.log(gstep, **means)``), so
        with ``log_every > 1`` no step waits for the device.
        ``sync_every`` forces a device sync every N steps.  Step ``g``
        draws from ``step_generator(seed, g)``: a fit resumed from saved
        ``state`` with ``start_step`` = completed steps and the same seed
        replays the uninterrupted run.  ``hooks`` are ``hook(gstep,
        state)`` calls after each step's dispatch.

        ``self.last_fit_stats``: {"steps", "host_transfers",
        "h2d_wait_ms", "h2d_put_ms", "h2d_wait_ms_windows"}.
        """
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        stream = Prefetcher(batches, self.device, steps)
        if stream.pending is None and steps > 0:
            raise ValueError("fit() got an empty batches iterable")
        step = task.make_step()
        if state is None:
            state = self.init_state(task, seed)
        metrics: dict = {}
        acc = metrics_lib.MetricAccumulator()
        transfers, last = 0, -1
        h2d_windows: list = []
        h2d_marked = 0.0

        def close_window():
            nonlocal h2d_marked
            waited = stream.stats["h2d_wait_ms"]
            h2d_windows.append(waited - h2d_marked)
            h2d_marked = waited

        for i, batch in zip(range(steps), stream):
            last = i
            gstep = start_step + i
            state, metrics = step(state, batch,
                                  self.step_generator(seed, gstep))
            for hook in hooks:
                hook(gstep, state)
            if log is not None:
                acc.update(metrics)
                if (i + 1) % log_every == 0 or i == steps - 1:
                    log.log(gstep, **acc.means())   # ONE transfer per window
                    transfers += 1
                    acc.reset()
                    close_window()
            if sync_every and (i + 1) % sync_every == 0 \
                    and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if log is not None and acc.count:
            # the batch stream ran dry before ``steps``: flush the partial
            # window so no step goes unlogged
            log.log(start_step + last, **acc.means())
            transfers += 1
            close_window()
        self.last_fit_stats = {
            "steps": last + 1, "host_transfers": transfers,
            "h2d_wait_ms": stream.stats["h2d_wait_ms"],
            "h2d_put_ms": stream.stats["put_ms"],
            "h2d_wait_ms_windows": h2d_windows,
        }
        return state, metrics
