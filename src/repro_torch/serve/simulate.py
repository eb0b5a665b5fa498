"""Fast-simulation serving engine: bucketed 3DGAN event generation.

Requests ask for showers (``primary_energy``, ``n_events``, ``seed``); the
engine turns them into device work:

- **fixed batch buckets** — event work from the scheduler's queue is
  packed into the smallest bucket that fits (padded + masked), so every
  step runs at one of a handful of batch sizes;
- **results on the device** — generated showers stay on the device until
  a request's LAST event is generated; then exactly one device->host copy
  per request (`SimulateEngine._finalize`);
- **deterministic per-event noise** — event ``i`` of a request draws its
  latent noise from its own generator seeded by a fixed 64-bit mix of
  ``(request.seed, i)`` (:func:`event_noise`), and every op of the
  generator computes a row from that row alone, so a request's showers
  are bit-identical whichever bucket they were packed into;
- **rolling physics gate** — every step's masked profile sums accumulate
  on the device; once per ``window`` events the gate drains them in one
  copy and reports the training-time divergences against a fixed MC
  reference (:class:`PhysicsGate`);
- **scheduling** — ordering, deadlines, priorities, admission control and
  load shedding live in `serve/scheduler.Scheduler`; a request that
  cannot be served is REJECTED with a structured error, never dropped.

Every generator conv runs through the hand-written CUDA kernel on a card
(`kernels/conv3d`).  Device meshes and replica failover are not part of
this engine yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gan, validation
from repro_torch.serve.scheduler import Rejection, Scheduler, SchedulerConfig
from repro_torch.substrate.precision import get_policy
from repro_torch.substrate.rng import mix_seed


def event_seed(seed: int, ev_idx: int) -> int:
    """The 64-bit generator seed of event ``ev_idx`` of a request."""
    return mix_seed(seed, ev_idx)


def event_noise(seeds, ev_idx, latent: int, device, dtype) -> torch.Tensor:
    """(B, latent) standard-normal noise, row ``r`` drawn from its own
    ``torch.Generator(device)`` seeded by ``event_seed(seeds[r],
    ev_idx[r])`` — a row depends on its (request seed, event index) only."""
    rows = []
    for s, i in zip(np.asarray(seeds).tolist(), np.asarray(ev_idx).tolist()):
        g = torch.Generator(device=device)
        g.manual_seed(event_seed(s, i))
        rows.append(torch.randn((latent,), generator=g, device=device))
    return torch.stack(rows).to(dtype)


@dataclasses.dataclass
class SimRequest:
    """One event-generation request: n_events showers at one beam setting.

    ``priority`` (higher wins; lowest sheds first) and ``deadline_s`` (a
    latency SLA relative to submit) feed the scheduler.  A request that
    cannot be served ends ``status == "rejected"`` with a structured
    ``error`` dict (`serve/scheduler.Rejection`).
    """
    rid: int
    primary_energy: float          # E_p in GeV (conditioning label)
    n_events: int
    seed: int = 0
    theta: float = float(np.pi / 2)   # incidence angle (rad)
    priority: int = 0
    deadline_s: Optional[float] = None
    # filled by the engine:
    images: Optional[np.ndarray] = None   # (n_events, X, Y, Z, 1)
    latency_s: float = 0.0
    done: bool = False
    status: str = "queued"         # "queued" | "done" | "rejected"
    error: Optional[dict] = None


@dataclasses.dataclass
class _Cursor:
    """Engine-internal progress through one request's event range."""
    req: SimRequest
    t0: float
    next_ev: int = 0
    chunks: List[torch.Tensor] = dataclasses.field(default_factory=list)
    deadline_t: Optional[float] = None   # absolute, engine-clock time


class PhysicsGate:
    """Rolling on-device physics validation for a serving deployment.

    ``update`` adds one step's masked profile sums to running sums on the
    device (no host sync); the window is counted in HOST-side real events,
    so deciding when to drain never waits on the device.  Every ``window``
    events the gate drains once and appends a report
    (`core/validation.gate_report`) against the fixed MC ``reference``.
    """

    def __init__(self, reference: dict, window: int = 512):
        self.reference = reference
        self.window = int(window)
        self.reports: List[dict] = []
        self._sums: Optional[dict] = None
        self._pending = 0

    def update(self, sums: dict, n_real: int) -> None:
        self._pending += int(n_real)
        if self._sums is None:
            self._sums = dict(sums)
        else:
            self._sums = {k: self._sums[k] + sums[k] for k in self._sums}
        if self._pending >= self.window:
            self.flush()

    def flush(self) -> Optional[dict]:
        """Drain the current (possibly partial) window: ONE device->host
        copy, one appended report.  No-op when nothing accumulated."""
        if not self._pending:
            return None
        names = list(self._sums)
        flat = torch.cat([self._sums[k].reshape(-1) for k in names]).cpu()
        host, at = {}, 0
        for k in names:
            n = self._sums[k].numel()
            host[k] = flat[at:at + n].reshape(self._sums[k].shape).numpy()
            at += n
        rep = validation.gate_report(host, self.reference)
        self.reports.append(rep)
        self._sums, self._pending = None, 0
        return rep

    def latest(self) -> Optional[dict]:
        return self.reports[-1] if self.reports else None

    def drifted(self, max_kl: float) -> bool:
        """True when the latest window's worst profile KL exceeds the
        budget."""
        rep = self.latest()
        if rep is None:
            return False
        worst = max(rep["longitudinal_kl"], rep["transverse_x_kl"],
                    rep["transverse_y_kl"])
        return worst > max_kl


class SimulateEngine:
    """Micro-batching 3DGAN event-generation service over bucketed steps.

    Parameters
    ----------
    cfg
        A `configs/calo3dgan.GANConfig` (the generator architecture).
    g_params
        Generator params (nested dict of f32 tensors), e.g. from
        `train/checkpoint.restore_gan_generator`; moved to ``device``.
    buckets
        Ascending fixed batch sizes; work is padded to the smallest bucket
        that fits the queue's remaining events.
    policy_name
        Precision policy (`substrate/precision.get_policy`): noise and the
        conv stack run in ``compute_dtype``, returned images are
        ``output_dtype``.
    gate
        Optional :class:`PhysicsGate`; fed once per step.
    sched
        Optional `serve/scheduler.SchedulerConfig` (``None``: plain FIFO).
    max_kl
        PhysicsGate drift budget: past it the engine enters degraded mode
        and sheds work below ``sched.degrade_shed_below`` priority.
    clock
        Time source for deadlines and latency.
    device
        ``"cuda"`` (default; raises when there is no card) or ``"cpu"``.
    """

    def __init__(self, cfg, g_params, *, buckets: Sequence[int] = (8, 32, 128),
                 policy_name: str = "f32",
                 gate: Optional[PhysicsGate] = None,
                 sched: Optional[SchedulerConfig] = None,
                 max_kl: Optional[float] = None,
                 clock=time.perf_counter, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SimulateEngine(device='cuda') needs a CUDA "
                               "card; pass device='cpu' to run the plain path")
        self.cfg = cfg
        self.policy = get_policy(policy_name)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one batch bucket")
        for b in self.buckets:
            if b <= 0:
                raise ValueError(f"bucket {b} must be positive")
        self.params = _to_device(g_params, self.device)
        self.gate = gate
        self.max_kl = max_kl
        self.clock = clock
        self.scheduler = Scheduler(sched or SchedulerConfig(), clock=clock)
        self._finished: List[SimRequest] = []
        self.rejected: List[SimRequest] = []
        self._submitted = 0
        self._degraded: List[dict] = []     # degradation ladder transitions
        self.stats = {"steps": 0, "events_generated": 0, "padded_events": 0,
                      "device_transfers": 0, "events_wasted": 0,
                      "bucket_steps": {b: 0 for b in self.buckets}}

    @classmethod
    def from_checkpoint(cls, path: str, cfg, *, policy_name: Optional[str]
                        = None, device="cuda", **kw) -> "SimulateEngine":
        """Restore a generator checkpoint and the precision policy it was
        trained under (an explicit ``policy_name`` overrides it)."""
        from repro_torch.train import checkpoint as ckpt_lib
        params = ckpt_lib.restore_gan_generator(path, cfg, device)
        resolved = policy_name or ckpt_lib.manifest_precision(path)
        return cls(cfg, params, policy_name=resolved, device=device, **kw)

    # -- host API ----------------------------------------------------------

    def warmup(self) -> None:
        """Build (or load) the CUDA kernels so the first request does not
        pay for it; nothing to do on the CPU."""
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.load("conv3d_fwd")

    def submit(self, req: SimRequest) -> None:
        """Admission-controlled enqueue.  A shed arrival is marked
        ``rejected`` with a structured ``error``."""
        if req.n_events <= 0:
            raise ValueError(f"request {req.rid}: n_events must be positive")
        now = self.clock()
        self._submitted += 1
        cur = _Cursor(req, now)
        if req.deadline_s is not None:
            cur.deadline_t = now + float(req.deadline_s)
        if self._degraded and \
                req.priority < self.scheduler.config.degrade_shed_below:
            self._reject(cur, Rejection(
                req.rid, "degraded",
                f"degraded mode ({self._degraded[-1]['reason']}): only "
                f"priority >= {self.scheduler.config.degrade_shed_below} "
                "admitted", t=now, priority=req.priority))
            return
        res = self.scheduler.admit(cur, rid=req.rid, n_events=req.n_events,
                                   priority=req.priority,
                                   deadline=cur.deadline_t)
        for item, rej in res.rejections:
            self._reject(item, rej)

    def run(self, max_steps: int = 100_000) -> List[SimRequest]:
        """Serve until the queue drains (or ``max_steps`` bucket steps);
        returns every request finished so far.

        Each iteration: expire dead deadlines, check the gate's drift
        alarm, plan one bucket step in scheduler order, run it, and
        finalize the requests whose last event landed.
        """
        for _ in range(max_steps):
            for item, rej in self.scheduler.expire():
                self._reject(item, rej)
            self._check_gate_drift()
            plan = self.scheduler.plan_step(self.buckets)
            if plan is None:
                break
            bucket, assignments = plan
            inputs, spans, n_real = self._pack_plan(bucket, assignments)
            img, sums = self._step(*inputs)
            self.stats["steps"] += 1
            self.stats["bucket_steps"][bucket] += 1
            self.scheduler.commit(plan)
            if self.gate is not None:
                self.gate.update(sums, n_real)
            self.stats["padded_events"] += bucket - n_real
            for cur, row, take in spans:
                cur.chunks.append(img[row:row + take])
                cur.next_ev += take
                if cur.next_ev == cur.req.n_events:
                    self._finalize(cur)
        return list(self._finished)

    def generate_events(self, primary_energy: float, n_events: int,
                        seed: int = 0) -> np.ndarray:
        """One-shot convenience: serve a single request, return its images."""
        req = SimRequest(rid=self._submitted, primary_energy=primary_energy,
                         n_events=n_events, seed=seed)
        self.submit(req)
        self.run()
        return req.images

    # -- degradation ladder ------------------------------------------------

    def _enter_degraded(self, reason: str) -> None:
        if self._degraded and self._degraded[-1]["reason"] == reason:
            return
        self._degraded.append({"reason": reason, "t": self.clock(),
                               "step": self.stats["steps"]})

    def _check_gate_drift(self) -> None:
        """PhysicsGate alarm -> quality-degraded mode: shed everything
        below the configured priority floor, keep serving the rest."""
        if self.gate is None or self.max_kl is None:
            return
        if not self.gate.drifted(self.max_kl):
            return
        self._enter_degraded("gate_drift")
        floor = self.scheduler.config.degrade_shed_below
        worst = self.gate.latest()
        for item, rej in self.scheduler.shed_below(
                floor, "degraded",
                f"physics gate drifted past max_kl={self.max_kl} "
                f"(longitudinal_kl={worst['longitudinal_kl']:.4f})"):
            self._reject(item, rej)

    def degraded_report(self) -> dict:
        """Structured service-state report; ``mode`` is ``healthy`` until a
        degradation transition is recorded."""
        sched = self.scheduler
        return {
            "mode": self._degraded[-1]["reason"] if self._degraded
            else "healthy",
            "transitions": list(self._degraded),
            "queue": {"requests": sched.queue_depth(),
                      "events": sched.backlog_events()},
            "shed": dict(sched.stats["rejected"]),
            "gate": self.gate.latest() if self.gate is not None else None,
            "drifted": (self.gate.drifted(self.max_kl)
                        if self.gate is not None and self.max_kl is not None
                        else False),
            "served": len(self._finished),
            "rejected": len(self.rejected),
        }

    # -- rejection bookkeeping ---------------------------------------------

    def _reject(self, cur: _Cursor, rej: Rejection) -> None:
        req = cur.req
        req.status = "rejected"
        req.error = rej.to_dict()
        req.done = False
        req.images = None
        self.stats["events_wasted"] += cur.next_ev
        cur.chunks = []
        self.rejected.append(req)

    # -- packing and the step ------------------------------------------------

    def _pack_plan(self, bucket: int, assignments):
        """Materialise a scheduler plan into one bucket batch.  Padded rows
        carry a benign mid-range E_p and mask=0 so they never reach the
        gate or a user."""
        seeds = np.zeros((bucket,), np.int64)
        ev_idx = np.zeros((bucket,), np.int64)
        e_p = np.full((bucket,), 100.0, np.float32)
        theta = np.full((bucket,), np.pi / 2, np.float32)
        mask = np.zeros((bucket,), np.float32)
        spans = []
        row = 0
        for entry, take in assignments:
            cur = entry.item
            seeds[row:row + take] = cur.req.seed
            ev_idx[row:row + take] = np.arange(cur.next_ev,
                                               cur.next_ev + take)
            e_p[row:row + take] = cur.req.primary_energy
            theta[row:row + take] = cur.req.theta
            mask[row:row + take] = 1.0
            spans.append((cur, row, take))
            row += take
        return (seeds, ev_idx, e_p, theta, mask), spans, row

    @torch.inference_mode()
    def _step(self, seeds, ev_idx, e_p, theta, mask):
        """One bucket step: noise, generator, gate sums; all on the device."""
        dev = self.device
        compute = self.policy.compute_dtype
        noise = event_noise(seeds, ev_idx, self.cfg.latent_dim, dev, compute)
        lab = torch.from_numpy(np.stack([e_p, theta, mask])).to(dev)
        e_p_t, theta_t, mask_t = lab[0], lab[1], lab[2]
        img = gan.generate(self.params, noise, e_p_t, theta_t, self.cfg)
        sums = validation.profile_sums(img, e_p_t, mask_t)
        return img.to(self.policy.output_dtype), sums

    def _finalize(self, cur: _Cursor) -> None:
        now = self.clock()
        if cur.deadline_t is not None and now > cur.deadline_t:
            # generated, but too late to honor the SLA: a structured
            # rejection, never a silently-late result
            self._reject(cur, Rejection(
                cur.req.rid, "deadline",
                f"completed {now - cur.deadline_t:.3f}s past its deadline",
                t=now, priority=cur.req.priority))
            return
        dev = (cur.chunks[0] if len(cur.chunks) == 1
               else torch.cat(cur.chunks, dim=0))
        cur.req.images = dev.cpu().numpy()   # the ONE transfer per request
        cur.chunks = []
        self.stats["device_transfers"] += 1
        self.stats["events_generated"] += cur.req.n_events
        cur.req.latency_s = self.clock() - cur.t0
        cur.req.done = True
        cur.req.status = "done"
        self._finished.append(cur.req)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
