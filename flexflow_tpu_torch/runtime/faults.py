"""Deterministic fault injection for the fit and serve loops.

Counterpart of ``flexflow_tpu/runtime/faults.py``.  A :class:`FaultPlan`
(``--fault-plan``) names which fault fires at which step, and two hooks
inject it where a real failure would surface: the top of
``Executor.train_step`` (site ``fit``, keyed on the executor's step
count, so a ``device_loss`` at step N raises before step N changes
anything) and the top of ``ServeEngine._window`` (site ``serve``).

Spec grammar (comma-separated events), the JAX package's::

    [site:]kind@step[:arg]
    [site:]kind@~lo-hi[:arg]     # step drawn from [lo, hi] by the seed

``site`` is ``fit`` (the default; keyed on the executor's step) or
``serve`` (keyed on ``ServeEngine.windows``).  Kinds:

* ``device_loss``: raise :class:`InjectedFault` (a ``RuntimeError``, as a
  real device error is) out of the step or window;
* ``loader_stall``: sleep ``arg`` seconds (default 0.05) on the host;
* ``sigterm``: ``os.kill(os.getpid(), SIGTERM)``, which the engine's
  handler turns into a drain.  The port refuses to send it when no
  handler is installed (the default action would kill the process);
* ``dcn_degrade``: set ``dcn_degraded`` on the executor or engine and
  sleep ``arg`` seconds;
* ``nan_grads`` (fit site only): multiply one parameter by NaN in place,
  a device op with no host sync, so the next step's loss and gradients
  turn non-finite.

The random form resolves when the spec is parsed, from the plan's seed,
with the JAX package's generator: the same ``(spec, seed)`` gives the
same events in both packages.  With no plan installed each hook costs
one call and one ``is None`` check.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "FAULT_KINDS",
    "FAULT_SITES",
    "FaultEvent",
    "FaultPlan",
    "InjectedFault",
    "configure_faults_from_config",
    "get_fault_plan",
    "set_fault_plan",
]

FAULT_KINDS = ("device_loss", "loader_stall", "nan_grads", "sigterm", "dcn_degrade")
FAULT_SITES = ("fit", "serve")


class InjectedFault(RuntimeError):
    """An injected failure, raised where the real one would surface."""

    def __init__(self, kind: str, step: int, site: str):
        self.kind = kind
        self.step = step
        self.site = site
        super().__init__(f"injected fault {kind!r} at {site} step {step} (--fault-plan)")


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault.  ``fired`` latches, so an event injects once
    even when the run passes its step again."""

    kind: str
    step: int
    site: str = "fit"
    arg: float = 0.0
    fired: bool = False

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; kinds: {FAULT_KINDS}")
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; sites: {FAULT_SITES}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "nan_grads" and self.site != "fit":
            raise ValueError("nan_grads faults only apply at the fit site "
                             "(serving has no gradients)")


class FaultPlan:
    """A seeded, ordered set of :class:`FaultEvent`\\ s and the two hooks."""

    def __init__(self, events: List[FaultEvent], seed: int = 0, spec: str = "") -> None:
        self.events = list(events)
        self.seed = int(seed)
        self.spec = spec

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the grammar of the module docstring; ``@~lo-hi`` steps are
        drawn here from ``seed``."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            site, body = "fit", raw
            head, sep, tail = raw.partition(":")
            if sep and head in FAULT_SITES:
                site, body = head, tail
            kind, sep, rest = body.partition("@")
            if not sep:
                raise ValueError(
                    f"fault event {raw!r} lacks '@step' (grammar: [site:]kind@step[:arg])")
            step_s, _, arg_s = rest.partition(":")
            if step_s.startswith("~"):
                lo, _, hi = step_s[1:].partition("-")
                lo_i, hi_i = int(lo), int(hi or lo)
                step = int(rng.integers(lo_i, hi_i + 1))
            else:
                step = int(step_s)
            events.append(FaultEvent(kind=kind, step=step, site=site,
                                     arg=float(arg_s) if arg_s else 0.0))
        events.sort(key=lambda e: (e.site, e.step))
        return cls(events, seed=seed, spec=spec)

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        """Load a JSON plan: ``{"seed": 0, "events": [{"kind", "step",
        "site", "arg"}, ...]}`` or ``{"seed": 0, "spec": "..."}``."""
        with open(path) as f:
            doc = json.load(f)
        seed = int(doc.get("seed", 0))
        if "spec" in doc:
            return cls.parse(doc["spec"], seed=seed)
        events = [
            FaultEvent(kind=e["kind"], step=int(e["step"]), site=e.get("site", "fit"),
                       arg=float(e.get("arg", 0.0)))
            for e in doc.get("events", ())
        ]
        events.sort(key=lambda e: (e.site, e.step))
        return cls(events, seed=seed, spec=f"file:{path}")

    @property
    def identity(self) -> str:
        """Stable description of the plan for run metadata."""
        ev = ";".join(
            f"{e.site}:{e.kind}@{e.step}" + (f":{e.arg:g}" if e.arg else "")
            for e in self.events
        )
        return f"seed{self.seed}[{ev}]"

    def _due(self, site: str, step: int) -> Optional[FaultEvent]:
        for e in self.events:
            if e.site == site and not e.fired and e.step <= step:
                e.fired = True
                return e
        return None

    def on_train_step(self, ex) -> None:
        """Called at the top of ``Executor.train_step``, keyed on
        ``ex._step_count``."""
        ev = self._due("fit", ex._step_count)
        if ev is not None:
            self._inject(ev, ex)

    def on_serve_window(self, engine) -> None:
        """Called at the top of ``ServeEngine._window``, keyed on
        ``engine.windows``."""
        ev = self._due("serve", engine.windows)
        if ev is not None:
            self._inject(ev, engine)

    def _inject(self, ev: FaultEvent, target) -> None:
        if ev.kind == "device_loss":
            raise InjectedFault(ev.kind, ev.step, ev.site)
        if ev.kind == "loader_stall":
            time.sleep(ev.arg or 0.05)
            return
        if ev.kind == "nan_grads":
            leaf = next(t for ws in target.params.values() for t in ws.values())
            with torch.no_grad():
                leaf.mul_(float("nan"))
            return
        if ev.kind == "sigterm":
            if signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, signal.SIG_IGN, None):
                raise RuntimeError(
                    f"fault plan: sigterm at {ev.site} step {ev.step} but no SIGTERM handler "
                    f"is installed (ServeEngine.run installs one on the main thread); "
                    f"refusing to kill the process")
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if ev.kind == "dcn_degrade":
            target.dcn_degraded = True
            if ev.arg:
                time.sleep(ev.arg)


# --- the process-wide plan -----------------------------------------------------
_PLAN: Optional[FaultPlan] = None


def get_fault_plan() -> Optional[FaultPlan]:
    """The installed plan, or ``None`` (the hook checks exactly this)."""
    return _PLAN


def set_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` for the process (``None`` removes it)."""
    global _PLAN
    _PLAN = plan
    return _PLAN


def configure_faults_from_config(cfg) -> Optional[FaultPlan]:
    """Install the plan of ``cfg.fault_plan`` (a JSON plan file when the
    path exists, else a spec string parsed with ``cfg.seed``).  An unset
    field leaves the current plan alone."""
    spec = getattr(cfg, "fault_plan", None)
    if not spec:
        return _PLAN
    if os.path.exists(spec):
        return set_fault_plan(FaultPlan.from_file(spec))
    return set_fault_plan(FaultPlan.parse(spec, seed=getattr(cfg, "seed", 0)))
