"""Request scheduler for the serving engine: deadlines, priorities,
admission control, and continuous batching (a copy of the reference's
`serve/scheduler.py`, pure Python).

- **deadlines** — a request may carry an absolute deadline; queued work
  whose deadline has passed is *rejected with a structured error*
  (:class:`Rejection`), never silently served late and never left to
  hang.  Ordering within a priority level is earliest-deadline-first.
- **priorities** — higher ``priority`` wins bucket admission; under
  overload or degraded operation the LOWEST priority sheds first.
- **admission control / load shedding** — ``max_queue_events`` bounds
  the backlog (derive it from the SLA with
  :meth:`SchedulerConfig.for_sla`).  An arrival over the bound first
  evicts strictly-lower-priority queued work (latest-deadline first);
  if that cannot make room the arrival itself is shed.  Optional
  feasibility check: an arrival whose deadline cannot be met even at the
  configured drain rate is rejected at submit time.
- **continuous batching** — :meth:`Scheduler.plan_step` admits requests
  into the next bucket step in scheduling order (promoted, then
  priority, then deadline).  Requests split across steps and share
  buckets.  The LM slot engine takes whole requests with
  :meth:`Scheduler.pop_next` instead.
- **age-based promotion** — an entry passed over for
  ``promote_after_steps`` consecutive bucket steps jumps to the front of
  the order (FIFO among promoted), so an old small request never starves.

Determinism: the scheduler never reads the wall clock directly — it
calls the injected ``clock``; all ordering keys are (priority, deadline,
submit sequence).  The default :class:`SchedulerConfig` is plain FIFO.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

REJECT_REASONS = ("overload", "deadline", "degraded", "capacity")


@dataclasses.dataclass(frozen=True)
class Rejection:
    """A structured shed/reject record — the service's answer when it
    cannot (or will not) serve a request, instead of a hang or a silent
    drop.  ``reason`` is one of :data:`REJECT_REASONS`:

    - ``overload``   — admission control shed it (queue bound exceeded);
    - ``deadline``   — its deadline expired (in queue, or infeasible at
      admission, or the result completed late);
    - ``degraded``   — shed by a degraded-mode policy (e.g. a PhysicsGate
      drift alarm keeping only high-priority traffic);
    - ``capacity``   — no healthy replica remained to run it.
    """
    rid: int
    reason: str
    detail: str
    t: float = 0.0
    priority: int = 0

    def __post_init__(self):
        if self.reason not in REJECT_REASONS:
            raise ValueError(
                f"reason must be one of {REJECT_REASONS}, got {self.reason!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Scheduling policy knobs (all off by default = legacy FIFO).

    ``max_queue_events``
        Admission bound on the queued-but-ungenerated event backlog;
        ``0`` disables admission control.  Derive from the SLA via
        :meth:`for_sla`.
    ``drain_rate_ev_s``
        Measured service throughput (events/s).  When set, an
        arrival whose deadline is infeasible even if served immediately
        (``backlog / rate`` already past it) is rejected at admission.
    ``promote_after_steps``
        Age-based promotion: an entry passed over for this many
        consecutive bucket steps jumps the priority/deadline order
        (``0`` disables).  This is the anti-starvation rule — without
        it a stream of large high-priority requests can push a small
        old request's latency unboundedly.
    ``degrade_shed_below``
        Degraded-mode threshold: :meth:`Scheduler.shed_below` callers
        (gate-drift / overload ladders) shed entries with
        ``priority < degrade_shed_below``.
    """
    max_queue_events: int = 0
    drain_rate_ev_s: float = 0.0
    promote_after_steps: int = 0
    degrade_shed_below: int = 1

    @classmethod
    def for_sla(cls, drain_rate_ev_s: float, sla_s: float,
                **kw) -> "SchedulerConfig":
        """SLA-derived admission bound: a backlog longer than
        ``drain_rate_ev_s * sla_s`` events cannot drain inside the SLA
        even at full throughput, so admitting past it only manufactures
        deadline misses — shed at the door instead."""
        return cls(max_queue_events=max(int(drain_rate_ev_s * sla_s), 1),
                   drain_rate_ev_s=drain_rate_ev_s, **kw)


@dataclasses.dataclass
class _Entry:
    """One admitted unit of work and its scheduling state."""
    item: Any                      # caller's handle (engine cursor)
    rid: int
    remaining: int                 # events not yet packed into a step
    priority: int = 0
    deadline: Optional[float] = None   # absolute, in clock() time
    seq: int = 0                   # admission order (FIFO tiebreak)
    waited_steps: int = 0          # consecutive steps passed over


@dataclasses.dataclass(frozen=True)
class AdmitResult:
    """Outcome of :meth:`Scheduler.admit`: whether the arrival got in,
    plus every (item, Rejection) it produced — evicted lower-priority
    entries, or the arrival itself."""
    admitted: bool
    rejections: Tuple[Tuple[Any, Rejection], ...] = ()


class Scheduler:
    """Priority/deadline-aware bucket scheduler over admitted entries.

    The engine owns dispatch; the scheduler owns WHO is
    served WHEN: :meth:`admit` applies admission control, :meth:`expire`
    rejects dead work, :meth:`plan_step` picks the next bucket's
    occupants (pure — call :meth:`commit` once the step actually ran, so
    a failed dispatch leaves the queue intact), and :meth:`shed_below` /
    :meth:`drain` implement the degradation ladder's shedding.
    """

    def __init__(self, config: Optional[SchedulerConfig] = None, *,
                 clock=time.monotonic):
        self.config = config or SchedulerConfig()
        self.clock = clock
        self._entries: List[_Entry] = []
        self._seq = 0
        self.stats = {"admitted": 0, "planned_steps": 0, "promotions": 0,
                      "evictions": 0,
                      "rejected": {r: 0 for r in REJECT_REASONS}}

    # -- introspection -------------------------------------------------------

    def queue_depth(self) -> int:
        return len(self._entries)

    def backlog_events(self) -> int:
        return sum(e.remaining for e in self._entries)

    # -- admission -----------------------------------------------------------

    def _reject(self, entry: _Entry, reason: str, detail: str):
        rej = Rejection(entry.rid, reason, detail, t=self.clock(),
                        priority=entry.priority)
        self.stats["rejected"][reason] += 1
        return (entry.item, rej)

    def admit(self, item: Any, *, rid: int, n_events: int,
              priority: int = 0,
              deadline: Optional[float] = None) -> AdmitResult:
        """Admission-control one arrival.  ``deadline`` is ABSOLUTE (in
        ``clock()`` time); callers turn a relative SLA into one at
        submit.  May evict queued strictly-lower-priority entries to
        make room (lowest priority first, latest deadline first within a
        priority, newest last as the final tiebreak)."""
        cfg = self.config
        entry = _Entry(item, rid, int(n_events), int(priority), deadline,
                       seq=self._seq)
        self._seq += 1
        rejections: List[Tuple[Any, Rejection]] = []
        now = self.clock()

        if deadline is not None and deadline <= now:
            rejections.append(self._reject(
                entry, "deadline", "deadline already expired at admission"))
            return AdmitResult(False, tuple(rejections))
        if cfg.drain_rate_ev_s > 0 and deadline is not None:
            # feasibility: even served ahead of everyone, can it finish?
            if now + n_events / cfg.drain_rate_ev_s > deadline:
                rejections.append(self._reject(
                    entry, "deadline",
                    f"infeasible: {n_events} events need "
                    f"{n_events / cfg.drain_rate_ev_s:.2f}s at "
                    f"{cfg.drain_rate_ev_s:.0f} ev/s"))
                return AdmitResult(False, tuple(rejections))

        if cfg.max_queue_events > 0:
            if n_events > cfg.max_queue_events:
                rejections.append(self._reject(
                    entry, "overload",
                    f"{n_events} events exceeds the whole admission "
                    f"bound {cfg.max_queue_events}"))
                return AdmitResult(False, tuple(rejections))
            over = (self.backlog_events() + n_events
                    - cfg.max_queue_events)
            if over > 0:
                # evict strictly-lower-priority queued work first
                victims = sorted(
                    (e for e in self._entries if e.priority < priority),
                    key=lambda e: (e.priority,
                                   -(e.deadline if e.deadline is not None
                                     else float("inf")),
                                   -e.seq))
                freed = 0
                evicted = []
                for v in victims:
                    if freed >= over:
                        break
                    freed += v.remaining
                    evicted.append(v)
                if freed >= over:
                    for v in evicted:
                        self._entries.remove(v)
                        self.stats["evictions"] += 1
                        rejections.append(self._reject(
                            v, "overload",
                            f"evicted for priority-{priority} arrival "
                            f"rid={rid}"))
                else:
                    rejections.append(self._reject(
                        entry, "overload",
                        f"backlog {self.backlog_events()} + {n_events} "
                        f"events exceeds bound {cfg.max_queue_events}"))
                    return AdmitResult(False, tuple(rejections))

        self._entries.append(entry)
        self.stats["admitted"] += 1
        return AdmitResult(True, tuple(rejections))

    # -- deadline expiry & shedding ------------------------------------------

    def expire(self) -> List[Tuple[Any, Rejection]]:
        """Reject every queued entry whose deadline has passed — the
        structured alternative to serving it late (or hanging on it)."""
        now = self.clock()
        dead = [e for e in self._entries
                if e.deadline is not None and e.deadline <= now]
        out = []
        for e in dead:
            self._entries.remove(e)
            out.append(self._reject(
                e, "deadline",
                f"deadline expired in queue ({e.remaining} of its events "
                "ungenerated)"))
        return out

    def shed_below(self, priority: int, reason: str,
                   detail: str) -> List[Tuple[Any, Rejection]]:
        """Shed every queued entry with ``priority < priority`` — the
        degradation ladder's move (lowest priority leaves first)."""
        victims = sorted((e for e in self._entries if e.priority < priority),
                         key=lambda e: (e.priority, e.seq))
        out = []
        for v in victims:
            self._entries.remove(v)
            out.append(self._reject(v, reason, detail))
        return out

    def drain(self, reason: str, detail: str) -> List[Tuple[Any, Rejection]]:
        """Reject EVERYTHING queued (total outage: no healthy replicas)."""
        out = [self._reject(e, reason, detail) for e in self._entries]
        self._entries.clear()
        return out

    # -- continuous batching --------------------------------------------------

    def _order(self) -> List[_Entry]:
        cfg = self.config
        promoted, rest = [], []
        for e in self._entries:
            if cfg.promote_after_steps > 0 \
                    and e.waited_steps >= cfg.promote_after_steps:
                promoted.append(e)
            else:
                rest.append(e)
        promoted.sort(key=lambda e: e.seq)          # FIFO among promoted
        rest.sort(key=lambda e: (
            -e.priority,
            e.deadline if e.deadline is not None else float("inf"),
            e.seq))
        return promoted + rest

    def plan_step(self, buckets: Sequence[int]):
        """Plan the next bucket step: ``(bucket, [(item, start_offset_hint
        is the caller's business — (item, take)), ...])`` or ``None`` when
        nothing is queued.

        PURE with respect to queue state — the engine calls
        :meth:`commit` after the step's dispatch succeeds; a dispatch
        failure (dead replica group) leaves every entry intact so the
        work can be rejected or retried explicitly.
        """
        order = self._order()
        if not order:
            return None
        total = sum(e.remaining for e in order)
        bucket = None
        for b in buckets:
            if b >= total:
                bucket = b
                break
        if bucket is None:
            bucket = max(buckets)
        plan, row = [], 0
        for e in order:
            if row == bucket:
                break
            take = min(bucket - row, e.remaining)
            if take <= 0:
                continue
            plan.append((e, take))
            row += take
        return bucket, plan

    def pop_next(self) -> Optional[Any]:
        """Remove and return the first queued item in scheduling order: the
        slot-pool engine's admission primitive (`serve/engine.py` claims
        one whole request per freed slot; no bucket packing).  Ages the
        passed-over entries like :meth:`commit`, so the promotion rule
        applies to both front-ends."""
        order = self._order()
        if not order:
            return None
        e = order[0]
        if e.waited_steps >= self.config.promote_after_steps > 0:
            self.stats["promotions"] += 1
        self._entries.remove(e)
        for other in self._entries:
            other.waited_steps += 1
        return e.item

    def commit(self, plan) -> None:
        """Apply a :meth:`plan_step` result after its dispatch succeeded:
        consume the planned events, retire finished entries, and age the
        passed-over ones (feeding the promotion rule)."""
        bucket, assignments = plan
        del bucket
        served = set()
        for e, take in assignments:
            e.remaining -= take
            served.add(id(e))
            if e.waited_steps >= self.config.promote_after_steps > 0:
                self.stats["promotions"] += 1
            e.waited_steps = 0
        self._entries = [e for e in self._entries if e.remaining > 0]
        for e in self._entries:
            if id(e) not in served:
                e.waited_steps += 1
        self.stats["planned_steps"] += 1
