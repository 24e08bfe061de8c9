"""Continuous-batching scheduler with SLO tiers.

Counterpart of ``flexflow_tpu/serve/scheduler.py``.  The unit of
batching is the SLOT, one lane of the engine's fixed-width decode step.
Requests are admitted FIFO within a tier into free slots, each with a
KV-block reservation for its whole budget (prompt + max new tokens),
charged net of re-attached shared prefix blocks.  A request whose
budget could never fit the pool is rejected at submit with a reason; a
queued request past its ``deadline_ms`` is expired with a reason; under
sustained SLO pressure the engine sheds the queued batch tier
(:meth:`ContinuousBatchingScheduler.shed_batch_queue`).  A finished
request releases its slot and blocks at once, and the next queued
request takes them.

Interactive requests admit ahead of the batch tier.  When one waits with
no admissible slot, the scheduler PREEMPTS a batch request
(:meth:`ContinuousBatchingScheduler._preempt_one`): the most recently
admitted batch DECODE request spills its live K/V to host
(:meth:`PagedKVCache.spill`), else a mid-PREFILL batch request drops its
partial K/V; either way its slot and blocks are released and it
re-queues at the FRONT of the batch tier as ``PREEMPTED``.  On
re-admission a spilled request restores its K/V bit for bit (prefix
blocks re-attach from the index) and rejoins decode mid-stream; a
dropped one prefills again.  Spill and restore run in :meth:`admit`,
between windows, after the window's one host sync.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from flexflow_tpu_torch.serve.kvcache import PagedKVCache

__all__ = ["Request", "RequestState", "ContinuousBatchingScheduler", "TIERS"]

TIERS = ("interactive", "batch")


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a token budget, an optional EOS,
    a tenant/tier label, and the latency bookkeeping of the report."""

    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    id: int = -1
    eos_id: Optional[int] = None
    arrival_s: float = 0.0  # open-loop arrival offset (traffic.py)
    tenant: str = "default"
    tier: str = "batch"  # "interactive" | "batch"
    deadline_ms: Optional[float] = None  # queue-wait deadline; None = wait
    session: Optional[str] = None  # multi-turn session id (traffic.py)

    # --- filled in by the scheduler/engine ---
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0  # prompt positions with live KV so far
    finish_reason: Optional[str] = None  # "eos" | "length" | "rejected: ..."
    preemptions: int = 0
    kv_spill: Optional[Dict[str, Any]] = None  # spill payload while PREEMPTED
    shared_prefix_pos: int = 0  # prompt positions served from shared blocks
    t_submit: Optional[float] = None
    arrival_abs_s: Optional[float] = None  # engine clock: t0 + arrival_s
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    t_enqueued: Optional[float] = None  # run-relative time of the last enqueue

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens {self.max_new_tokens} < 1")
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r}")

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def max_len(self) -> int:
        """Positions this request may ever occupy (= KV reservation)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done_tokens(self) -> int:
        return len(self.tokens)

    def latency_ms(self) -> Dict[str, Optional[float]]:
        ttft = None
        if self.t_first_token is not None and self.arrival_abs_s is not None:
            ttft = (self.t_first_token - self.arrival_abs_s) * 1e3
        tpot = None
        if self.t_done is not None and self.t_first_token is not None and len(self.tokens) > 1:
            tpot = (self.t_done - self.t_first_token) / (len(self.tokens) - 1) * 1e3
        return {"ttft_ms": ttft, "tpot_ms": tpot}


class ContinuousBatchingScheduler:
    """Tiered FIFO admission of :class:`Request`s into ``slots`` decode
    lanes backed by a :class:`PagedKVCache` (see the module docstring)."""

    def __init__(self, slots: int, kvcache: PagedKVCache) -> None:
        if kvcache.slots != slots:
            raise ValueError(f"cache has {kvcache.slots} slots, scheduler {slots}")
        self.slots = slots
        self.kv = kvcache
        self._queues: Dict[str, deque] = {t: deque() for t in TIERS}
        self.free_slots: deque = deque(range(slots))
        self.active: Dict[int, Request] = {}  # slot -> request
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.preemptions = 0  # spill or drop events
        self.expired = 0  # deadline_ms expiries while queued
        self.shed = 0  # batch requests shed under SLO pressure
        self._next_id = 0

    @property
    def queue(self) -> List[Request]:
        """Pending requests in admission order (interactive first)."""
        return [r for t in TIERS for r in self._queues[t]]

    # --- submission --------------------------------------------------------
    def submit(self, req: Request, now: float = 0.0) -> Request:
        """Queue a request, or reject it when its budget could never be
        served by this cache (it comes back REJECTED; nothing raises)."""
        if req.id < 0:
            req.id = self._next_id
        self._next_id = max(self._next_id, req.id) + 1
        req.t_submit = now
        req.t_enqueued = now
        if not self.kv.fits_with_sharing(req.max_len, req.prompt):
            self._reject(req, now)
            return req
        req.state = RequestState.QUEUED
        self._queues[req.tier].append(req)
        return req

    def _reject(self, req: Request, now: float) -> None:
        total, shared = self.kv.blocks_needed(req.max_len, req.prompt)
        reason = (
            f"rejected: max_len {req.max_len} needs {total} blocks, pool holds "
            f"{self.kv.allocatable_blocks} (table limit {self.kv.max_seq_len} positions)"
        )
        if shared > 0:
            reason += (
                f"; {shared} shared prefix blocks discounted, "
                f"{total - shared} private blocks still exceed the pool"
            )
        else:
            reason += "; never fits (no shared prefix applies)"
        req.state = RequestState.REJECTED
        req.finish_reason = reason
        req.t_done = now
        self.rejected.append(req)

    # --- admission ---------------------------------------------------------
    def _place(self, req: Request, now: float) -> None:
        slot = self.free_slots.popleft()
        if req.kv_spill is not None:
            # a preempted request resumes: its K/V comes back bit for bit
            # and it rejoins decode (its prompt was ingested before the spill)
            self.kv.restore(slot, req.kv_spill, req.max_len, prompt=req.prompt)
            req.kv_spill = None
            req.state = RequestState.DECODE
            req.prefill_pos = req.prompt_len
        else:
            self.kv.reserve(slot, req.max_len, prompt=req.prompt)
            req.state = RequestState.PREFILL
            # shared prefix blocks already hold these positions' K/V; prefill
            # starts past them, never past the last prompt token
            req.prefill_pos = req.shared_prefix_pos = min(
                self.kv.shared_len(slot), req.prompt_len - 1
            )
        req.slot = slot
        if req.t_admitted is None:
            req.t_admitted = now
        self.active[slot] = req

    def _admit_tier(self, tier: str, now: float) -> List[Request]:
        out: List[Request] = []
        q = self._queues[tier]
        while q and self.free_slots:
            req = q[0]
            if not self.kv.fits_with_sharing(req.max_len, req.prompt):
                # the shared blocks that justified queueing were evicted
                q.popleft()
                self._reject(req, now)
                continue
            if not self.kv.can_reserve(req.max_len, req.prompt):
                break
            q.popleft()
            self._place(req, now)
            out.append(req)
        return out

    def _preempt_one(self, now: float) -> bool:
        """Free one slot for a waiting interactive request.  The victim is
        the most recently admitted batch DECODE request (the least sunk
        work lost), whose live K/V spills to host; else a mid-PREFILL
        batch request, which drops its partial K/V and prefills again.
        Returns False when no batch request holds a slot."""
        decode_victims = [r for r in self.active.values()
                          if r.tier == "batch" and r.state is RequestState.DECODE]
        prefill_victims = [r for r in self.active.values()
                           if r.tier == "batch" and r.state is RequestState.PREFILL]
        pool = decode_victims or prefill_victims
        if not pool:
            return False
        victim = max(pool, key=lambda r: (r.t_admitted or 0.0, r.slot))
        slot = victim.slot
        del self.active[slot]
        if victim.state is RequestState.DECODE:
            # positions written so far: the prompt and one per decode step
            # taken (the latest token is the next step's input, no K/V yet)
            live = victim.prompt_len + max(0, victim.done_tokens - 1)
            victim.kv_spill = self.kv.spill(slot, live)
        else:
            self.kv.release(slot)
            victim.kv_spill = None
            victim.prefill_pos = 0
        self.free_slots.append(slot)
        victim.slot = -1
        victim.state = RequestState.PREEMPTED
        victim.preemptions += 1
        self.preemptions += 1
        victim.t_enqueued = now
        self._queues["batch"].appendleft(victim)  # it resumes first
        return True

    def _expire(self, now: float) -> int:
        """Reject every queued request past its ``deadline_ms`` with a
        reason; runs before admission so an expired head never blocks."""
        n = 0
        for q in self._queues.values():
            keep = deque()
            while q:
                req = q.popleft()
                waited_ms = (now - (req.t_submit or 0.0)) * 1e3
                if req.deadline_ms is not None and waited_ms > req.deadline_ms:
                    req.state = RequestState.REJECTED
                    req.finish_reason = (
                        f"rejected: deadline {req.deadline_ms:.0f} ms exceeded while "
                        f"queued (waited {waited_ms:.0f} ms, tier {req.tier!r})"
                    )
                    req.t_done = now
                    self.rejected.append(req)
                    self.expired += 1
                    n += 1
                else:
                    keep.append(req)
            q.extend(keep)
        return n

    def shed_batch_queue(self, now: float, reason: str) -> int:
        """Reject every QUEUED batch-tier request with ``reason`` (which
        names the pressure that triggered the shed).  Active slots and the
        interactive tier are left alone.  Returns how many were shed."""
        q = self._queues["batch"]
        n = len(q)
        while q:
            req = q.popleft()
            req.state = RequestState.REJECTED
            req.finish_reason = f"rejected: shed ({reason})"
            req.t_done = now
            self.rejected.append(req)
        self.shed += n
        return n

    def admit(self, now: float = 0.0) -> List[Request]:
        """Admit queue heads into free slots while both a slot and the KV
        reservation are available, interactive tier first."""
        self._expire(now)
        out = self._admit_tier("interactive", now)
        while self._queues["interactive"]:
            if not self._preempt_one(now):
                break
            out.extend(self._admit_tier("interactive", now))
        out.extend(self._admit_tier("batch", now))
        return out

    def finish(self, req: Request, now: float, reason: str) -> None:
        """Release the request's slot and blocks; the next :meth:`admit`
        can hand them to a queued request."""
        if self.active.get(req.slot) is not req:
            raise ValueError(f"request {req.id} is not active in slot {req.slot}")
        del self.active[req.slot]
        self.kv.release(req.slot)
        self.free_slots.append(req.slot)
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.t_done = now
        req.slot = -1
        self.finished.append(req)

    # --- introspection -----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def occupancy(self) -> float:
        return len(self.active) / float(self.slots)

    def decode_slots(self) -> List[int]:
        return sorted(s for s, r in self.active.items() if r.state is RequestState.DECODE)

    def prefill_slots(self) -> List[int]:
        return sorted(s for s, r in self.active.items() if r.state is RequestState.PREFILL)

    @property
    def idle(self) -> bool:
        return self.queue_depth == 0 and not self.active

    def tenant_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant aggregates over everything this scheduler has seen."""
        out: Dict[str, Dict[str, Any]] = {}

        def row(r: Request) -> Dict[str, Any]:
            d = out.setdefault(r.tenant, {
                "finished": 0, "rejected": 0, "expired": 0, "active": 0,
                "queued": 0, "preemptions": 0, "tokens": 0, "ttft_ms": [],
                "tier": None,
            })
            d["tier"] = r.tier
            return d

        for r in self.finished:
            d = row(r)
            d["finished"] += 1
            d["tokens"] += r.done_tokens
            d["preemptions"] += r.preemptions
            ttft = r.latency_ms()["ttft_ms"]
            if ttft is not None:
                d["ttft_ms"].append(ttft)
        for r in self.rejected:
            d = row(r)
            d["rejected"] += 1
            if (r.finish_reason or "").startswith("rejected: deadline"):
                d["expired"] += 1
        for r in self.active.values():
            row(r)["active"] += 1
        for r in self.queue:
            row(r)["queued"] += 1
        return out
