"""Synthetic open-loop traffic generator.

Counterpart of ``flexflow_tpu/serve/traffic.py``, draw for draw: the
same :class:`TrafficSpec` gives the same prompts, budgets, arrival
times, tenants and tiers as the JAX generator (numpy's
``default_rng(seed)`` on both sides).

Open loop: arrivals are independent of completions (exponential gaps at
``rate_rps``; ``rate_rps <= 0`` puts every request at t=0), so queue
depth under overload is a real signal.  ``burst_factor > 1``
Markov-modulates the rate between an ON and an OFF state.  Tenant
fields prepend a per-tenant system prompt (the traffic prefix sharing
exists for), split requests round-robin across tenants, mark the first
``ceil(tenants * interactive_frac)`` tenants as the interactive tier,
and ``session_turns > 1`` makes follow-up turns extend the previous
turn's prompt.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from flexflow_tpu_torch.serve.scheduler import Request

__all__ = ["TrafficSpec", "synthetic_requests", "multi_tenant_requests"]


class _ArrivalClock:
    """One arrival time per call.  ``burst_factor == 1.0`` draws one
    exponential per arrival and nothing else; the bursty branch adds one
    uniform per arrival for the on/off flip."""

    _FLIP_P = 0.25  # per-arrival state-flip probability

    def __init__(self, spec: "TrafficSpec", rng: np.random.Generator) -> None:
        if spec.burst_factor <= 0:
            raise ValueError(f"burst_factor {spec.burst_factor} must be > 0")
        self._spec, self._rng = spec, rng
        self._t = 0.0
        self._on = True  # bursts start hot

    def next(self) -> float:
        spec, rng = self._spec, self._rng
        if spec.rate_rps <= 0:
            return self._t
        if spec.burst_factor == 1.0:
            self._t += float(rng.exponential(1.0 / spec.rate_rps))
            return self._t
        if rng.random() < self._FLIP_P:
            self._on = not self._on
        rate = spec.rate_rps * (spec.burst_factor if self._on else 1.0 / spec.burst_factor)
        self._t += float(rng.exponential(1.0 / rate))
        return self._t


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Identity of one synthetic workload."""

    n_requests: int = 16
    seed: int = 0
    rate_rps: float = 0.0
    prompt_len: Tuple[int, int] = (4, 12)  # inclusive range
    max_new: Tuple[int, int] = (4, 24)  # inclusive range
    vocab: int = 256
    tenants: int = 1
    shared_prefix: int = 0  # per-tenant system-prompt tokens
    interactive_frac: float = 0.0  # fraction of tenants on the SLO tier
    burst_factor: float = 1.0
    session_turns: int = 1

    @property
    def identity(self) -> str:
        """Seed + shape as one string; tenant, burst and session fields
        are appended only when not at their defaults."""
        s = (
            f"seed{self.seed}/n{self.n_requests}"
            f"/p{self.prompt_len[0]}-{self.prompt_len[1]}"
            f"/g{self.max_new[0]}-{self.max_new[1]}"
            f"/r{self.rate_rps:g}/v{self.vocab}"
        )
        if self.tenants != 1 or self.shared_prefix or self.interactive_frac:
            s += f"/t{self.tenants}/sp{self.shared_prefix}/i{self.interactive_frac:g}"
        if self.burst_factor != 1.0:
            s += f"/b{self.burst_factor:g}"
        if self.session_turns != 1:
            s += f"/st{self.session_turns}"
        return s


def synthetic_requests(spec: TrafficSpec) -> List[Request]:
    """Deterministic workload for ``spec``.  Specs with tenant or session
    fields go through :func:`multi_tenant_requests`."""
    if (spec.tenants != 1 or spec.shared_prefix or spec.interactive_frac
            or spec.session_turns != 1):
        return multi_tenant_requests(spec)
    rng = np.random.default_rng(spec.seed)
    clock = _ArrivalClock(spec, rng)
    out: List[Request] = []
    for i in range(spec.n_requests):
        t = clock.next()
        plen = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        gen = int(rng.integers(spec.max_new[0], spec.max_new[1] + 1))
        prompt = rng.integers(0, spec.vocab, size=(plen,)).astype(np.int32)
        out.append(Request(prompt=prompt, max_new_tokens=gen, id=i, arrival_s=t))
    return out


def multi_tenant_requests(spec: TrafficSpec) -> List[Request]:
    """Deterministic multi-tenant workload (see the module docstring)."""
    rng = np.random.default_rng(spec.seed)
    nt = max(1, int(spec.tenants))
    n_inter = 0
    if spec.interactive_frac > 0:
        n_inter = min(nt, max(1, int(np.ceil(nt * spec.interactive_frac))))
    sys_prompts = [
        rng.integers(0, spec.vocab, size=(spec.shared_prefix,)).astype(np.int32)
        for _ in range(nt)
    ]
    clock = _ArrivalClock(spec, rng)
    out: List[Request] = []
    turns = max(1, int(spec.session_turns))
    n_turn = [0] * nt
    prev_prompt: List[np.ndarray] = list(sys_prompts)
    for i in range(spec.n_requests):
        # per-request draws (t, plen, gen, tail) in the same order with
        # sessions on or off
        t = clock.next()
        j = i % nt
        plen = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        gen = int(rng.integers(spec.max_new[0], spec.max_new[1] + 1))
        tail = rng.integers(0, spec.vocab, size=(plen,)).astype(np.int32)
        session = None
        if turns > 1:
            s_idx, turn = divmod(n_turn[j], turns)
            session = f"tenant{j}:s{s_idx}"
            base = sys_prompts[j] if turn == 0 else prev_prompt[j]
            prompt = np.concatenate([base, tail])
            prev_prompt[j] = prompt
            n_turn[j] += 1
        else:
            prompt = np.concatenate([sys_prompts[j], tail])
        out.append(Request(
            prompt=prompt, max_new_tokens=gen, id=i, arrival_s=t,
            tenant=f"tenant{j}",
            tier="interactive" if j < n_inter else "batch",
            session=session,
        ))
    return out
