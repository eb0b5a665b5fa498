"""Batched LM serving engine: continuous-batching decode over a fixed slot
pool (a port of the reference's ``serve/engine.py``).

One decode step advances every slot a token per call; prompts enter free
slots by chunked prefill (C prompt tokens per slot per launch) or token by
token; finished requests release their slot.  The KV cache lives on the
engine's device in the policy's compute dtype; the host keeps positions
and emitted tokens and drains one (slots,) token vector per step.
Admission goes through the port's ``serve/scheduler.Scheduler``
(deadlines, priorities, admission bound), with ``max_new_tokens`` as the
backlog weight.

Differences from the reference: the parameters are cast to the compute
dtype once, at construction (the reference casts inside its compiled
step); the cache is updated in place; there is no device mesh.  Every
attention call runs the CUDA kernels on ``device="cuda"`` (the default)
and their plain versions on ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.serve.scheduler import Rejection, Scheduler, SchedulerConfig
from repro_torch.substrate.precision import get_policy, tree_map
from repro_torch.train import steps as steps_lib


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                # -1: never stops early
    priority: int = 0               # higher wins slot admission
    deadline_s: Optional[float] = None   # latency SLA from submit
    # filled by the engine:
    tokens: Optional[list] = None
    done: bool = False
    status: str = "queued"          # "queued" | "done" | "rejected"
    error: Optional[dict] = None
    # absolute SLA deadline (engine clock), kept so in-flight requests can
    # be expired mid-decode (the scheduler stops tracking a request once
    # pop_next hands it to a slot)
    _abs_deadline: Optional[float] = None


class ServeEngine:
    """Slot-based continuous batching on one decode step function.

    ``prefill``: "chunked" runs C prompt tokens per slot in one batched
    ``prefill_chunk`` launch (token-identical to sequential); "sequential"
    feeds the prompt through decode steps.  ``stats`` counts prefill
    launches and decode steps (each runs every layer once)."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 512,
                 policy_name: str = "f32",
                 sched: Optional[SchedulerConfig] = None,
                 clock=time.monotonic, prefill: str = "chunked",
                 prefill_chunk: int = 128, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda') needs a CUDA card; "
                               "pass device='cpu' to run the plain path")
        self.cfg = cfg
        self.model = api.get_model(cfg)
        self.policy = get_policy(policy_name)
        self.slots = slots
        self.max_len = max_len
        self.params = self.policy.cast_to_compute(
            tree_map(lambda t: t.to(self.device), params))

        self._decode = steps_lib.make_serve_step(self.model, cfg, self.policy)
        if prefill not in ("chunked", "sequential"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        self.prefill_mode = prefill
        self._chunk = max(1, min(prefill_chunk, max_len))
        if prefill == "chunked":
            self._prefill_fn = steps_lib.make_prefill_chunk_step(
                self.model, cfg, self.policy)
        # the cache holds activations: the policy's compute dtype
        self.cache_dtype = self.policy.compute_dtype
        self.cache = self.model.init_cache(cfg, slots, max_len,
                                           self.cache_dtype, self.device)
        self.pos = np.zeros((slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.cur_tok = np.zeros((slots, 1), np.int32)
        self.clock = clock
        self.scheduler = Scheduler(sched or SchedulerConfig(), clock=clock)
        self.rejected: List[Request] = []
        self._finished: List[Request] = []
        self.stats = {"prefill_launches": 0, "decode_steps": 0}

    # -- host API ----------------------------------------------------------

    def submit(self, req: Request):
        req.tokens = []
        deadline = (self.clock() + float(req.deadline_s)
                    if req.deadline_s is not None else None)
        req._abs_deadline = deadline
        res = self.scheduler.admit(req, rid=req.rid,
                                   n_events=req.max_new_tokens,
                                   priority=req.priority, deadline=deadline)
        for item, rej in res.rejections:
            self._reject(item, rej)

    def run(self, max_steps: int = 10_000):
        """Drive until queue + slots drain (or max_steps)."""
        for _ in range(max_steps):
            self._sweep_slot_deadlines()
            self._fill_slots()
            if all(r is None for r in self.slot_req):
                break
            self._step()
        return self._finished

    # -- internals -----------------------------------------------------------

    def _reject(self, req: Request, rej):
        req.status = "rejected"
        req.error = rej.to_dict()
        self.rejected.append(req)

    def _sweep_slot_deadlines(self):
        """Expire in-flight requests whose SLA deadline has passed: the
        scheduler only expires queued ones, so without this sweep a request
        that blows its deadline mid-decode would hold its slot to the end
        and be delivered late anyway."""
        now = self.clock()
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None or req._abs_deadline is None:
                continue
            if now > req._abs_deadline:
                self._reject(req, Rejection(
                    rid=req.rid, reason="deadline",
                    detail=f"deadline exceeded mid-decode after "
                           f"{len(req.tokens)} tokens", t=now,
                    priority=req.priority))
                req.done = True
                self.slot_req[s] = None

    def _fill_slots(self):
        for item, rej in self.scheduler.expire():
            self._reject(item, rej)
        newly = []
        for s in range(self.slots):
            if self.slot_req[s] is None:
                req = self.scheduler.pop_next()
                if req is None:
                    break
                self.slot_req[s] = req
                newly.append((s, req))
        if not newly:
            return
        if self.prefill_mode == "chunked":
            self._prefill_chunked(newly)
        else:
            for s, req in newly:
                self._prefill_slot(s, req)

    def _merge_slot(self, new_cache, old_cache, slot: int):
        """Slot ``slot``'s rows from ``new_cache``, every other row from
        ``old_cache``: written into ``old_cache``, which is returned.  The
        cache's batch axis is 1 ((L, B, T, KH, D))."""
        for name, old in old_cache.items():
            old[:, slot] = new_cache[name][:, slot]
        return old_cache

    def _zero_slot(self, slot: int):
        for t in self.cache.values():
            t[:, slot] = 0

    def _prefill_slot(self, s: int, req: Request):
        """Sequential prefill: feed the prompt through decode steps for this
        slot.  The other slots' rows are snapshotted and restored, since
        every decode step writes every slot's row."""
        self._zero_slot(s)
        snapshot = {k: t.clone() for k, t in self.cache.items()}
        self.pos[s] = 0
        for t in req.prompt:
            self.cur_tok[s, 0] = t
            self._step(active_slot=s)
        self.cache = self._merge_slot(self.cache, snapshot, s)
        # after the prompt, cur_tok[s] holds the model's first sampled token
        req.tokens.append(int(self.cur_tok[s, 0]))

    def _prefill_chunked(self, pairs):
        """Batched chunked prefill: every newly admitted prompt in
        ceil(prompt_len / chunk) ``prefill_chunk`` launches in all (the new
        slots share each launch).  Inactive rows (lens = 0) are left alone
        inside the model, so no snapshot is needed.  Token-identical to
        :meth:`_prefill_slot`."""
        prompts = {}
        for s, req in pairs:
            self._zero_slot(s)
            self.pos[s] = 0
            prompts[s] = np.asarray(req.prompt, np.int32).reshape(-1)
        C = self._chunk
        offset = {s: 0 for s in prompts}
        first_tok = {}
        while any(offset[s] < len(prompts[s]) for s in prompts):
            tokens = np.zeros((self.slots, C), np.int32)
            lens = np.zeros((self.slots,), np.int32)
            for s, p in prompts.items():
                n = min(C, len(p) - offset[s])
                if n > 0:
                    tokens[s, :n] = p[offset[s]:offset[s] + n]
                    lens[s] = n
            nxt, self.cache = self._prefill_fn(self.params, tokens,
                                               self.cache, self.pos.copy(),
                                               lens)
            self.stats["prefill_launches"] += 1
            nxt = nxt.cpu().numpy()
            for s in prompts:
                n = int(lens[s])
                if n == 0:
                    continue
                self.pos[s] += n
                offset[s] += n
                if offset[s] >= len(prompts[s]):
                    first_tok[s] = int(nxt[s])
        for s, req in pairs:
            # empty prompt: nothing was sampled; keep the slot's stale
            # cur_tok, as the sequential path does
            tok = first_tok.get(s, int(self.cur_tok[s, 0]))
            self.cur_tok[s, 0] = tok
            req.tokens.append(tok)

    def _step(self, active_slot: Optional[int] = None):
        """One global decode step (all slots advance; inactive slots'
        outputs are ignored and their writes are idempotent)."""
        nxt, self.cache = self._decode(self.params, self.cur_tok.copy(),
                                       self.cache, self.pos.copy())
        self.stats["decode_steps"] += 1
        nxt = nxt.cpu().numpy()
        for s in range(self.slots):
            req = self.slot_req[s]
            if active_slot is not None and s != active_slot:
                continue
            self.pos[s] += 1
            if req is None:
                continue
            if active_slot is None:
                req.tokens.append(int(nxt[s]))
            self.cur_tok[s, 0] = nxt[s]
            if (len(req.tokens) >= req.max_new_tokens
                    or (req.eos_id >= 0 and req.tokens
                        and req.tokens[-1] == req.eos_id)
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                req.status = "done"
                self._finished.append(req)
                self.slot_req[s] = None
