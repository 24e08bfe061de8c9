"""Preemption, drain and resume, the fault plan, the watchdog, shedding and
the driver's flags: the port against the JAX package, on the CPU.

The model is tests/test_torch_serve.py's: a JAX ``gpt_decoder`` (2
layers, hidden 32, 4 heads, ff 64, vocab 31, seq 48) whose weights are
carried into the port's ``GPTDecoder``.  The JAX engine gets the copying
``jnp`` shim of that file, an attribute of the test's own engine object,
so that its streams are steady.  Scenarios are the JAX package's own
(tests/test_serve_multitenant.py, tests/test_resilience.py): every
stream must equal the JAX engine's, and where the JAX test holds one
against the dense solo decode, that too.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig, FFModel  # noqa: E402
from flexflow_tpu.models.gpt_decode import gpt_generate_cached  # noqa: E402
from flexflow_tpu.models.transformer import gpt_decoder  # noqa: E402
from flexflow_tpu.obs import read_metrics  # noqa: E402
from flexflow_tpu.runtime import faults as jfaults  # noqa: E402
from flexflow_tpu.serve import ServeEngine as JaxEngine  # noqa: E402
from flexflow_tpu.serve.engine import load_drain as jax_load_drain  # noqa: E402
from flexflow_tpu.serve.kvcache import PagedKVCache as JaxKV  # noqa: E402
from flexflow_tpu.serve.scheduler import ContinuousBatchingScheduler as JaxSched  # noqa: E402
from flexflow_tpu.serve.scheduler import Request as JaxRequest  # noqa: E402
from flexflow_tpu_torch.models.transformer import GPTDecoder, load_jax_params  # noqa: E402
from flexflow_tpu_torch.runtime.faults import (  # noqa: E402
    FaultPlan,
    InjectedFault,
    get_fault_plan,
    set_fault_plan,
)
from flexflow_tpu_torch.serve import (  # noqa: E402
    ContinuousBatchingScheduler,
    PagedKVCache,
    Request,
    RequestState,
    ServeEngine,
    load_drain,
)
from flexflow_tpu_torch.serve.driver import main as driver_main  # noqa: E402

SLOTS, SEQ, VOCAB = 4, 48, 31
SHAPE = dict(hidden=32, heads=4, ff_dim=64, num_layers=2, vocab=VOCAB)


@pytest.fixture(autouse=True)
def _one_thread_and_no_plan():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
    set_fault_plan(None)


@pytest.fixture(scope="module")
def jax_model():
    cfg = FFConfig(batch_size=SLOTS, compute_dtype="float32")
    m = FFModel(cfg)
    gpt_decoder(m, SLOTS, SEQ, use_flash=False, **SHAPE)
    m.compile(seed=0)
    return m


@pytest.fixture()
def port_model(jax_model):
    m = GPTDecoder(seq=SEQ, device="cpu", **SHAPE)
    load_jax_params(m, {layer: {leaf: np.asarray(v) for leaf, v in leaves.items()}
                        for layer, leaves in jax_model.executor.params.items()})
    return m


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies its host argument first (see
    tests/test_torch_serve.py: the JAX window loop advances a host
    buffer that a queued step may still read)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, a, *args, **kwargs):
        return jnp.asarray(np.array(a, copy=True), *args, **kwargs)


def _jax_engine(model, **kw):
    eng = JaxEngine(model, attn="gather", **kw)
    eng._jnp = _CopyingJnp()
    return eng


def _solo(model, prompt, max_new):
    """Greedy solo decode on the JAX dense session."""
    out, _ = gpt_generate_cached(model, np.tile(np.asarray(prompt)[None], (SLOTS, 1)), max_new)
    return [int(t) for t in out[0, len(prompt):]]


def _streams(reqs):
    return {r.id: [int(t) for t in r.tokens] for r in reqs}


# ------------------------------------------------------------------ scheduler
def _sched_state(s):
    return (
        {slot: (r.id, r.state.value, r.prefill_pos, r.preemptions) for slot, r in s.active.items()},
        [(r.id, r.state.value, r.prefill_pos, r.kv_spill is None) for r in s.queue],
        sorted(s.free_slots), s.preemptions,
    )


def test_scheduler_preempts_batch_for_interactive_as_jax():
    """The JAX scenario: a mid-prefill batch request is the victim, drops
    its K/V, re-queues at the front of its tier and prefills again."""
    scheds = [
        (JaxSched(1, JaxKV(2, 2, 4, slots=1, block_size=8, max_seq_len=32)), JaxRequest),
        (ContinuousBatchingScheduler(1, PagedKVCache(2, 2, 4, slots=1, block_size=8,
                                                     max_seq_len=32, device="cpu")), Request),
    ]
    reqs = []
    for s, cls in scheds:
        b = s.submit(cls(prompt=np.arange(4), max_new_tokens=4, tier="batch"))
        assert s.admit() == [b] and b.state.value == "prefill"
        i = s.submit(cls(prompt=np.arange(3), max_new_tokens=4, tier="interactive"))
        assert s.admit() == [i] and i.slot == 0
        assert b.state.value == "preempted" and b.kv_spill is None and b.prefill_pos == 0
        assert b.preemptions == 1 and s.preemptions == 1 and s.queue == [b]
        reqs.append((b, i))
    assert _sched_state(scheds[0][0]) == _sched_state(scheds[1][0])
    for (s, _), (b, i) in zip(scheds, reqs):
        s.finish(i, now=1.0, reason="length")
        assert s.admit() == [b] and b.state.value == "prefill"
        s.kv.check_invariants()
    assert _sched_state(scheds[0][0]) == _sched_state(scheds[1][0])


def test_scheduler_spills_decode_victim_and_restores_it_as_jax():
    """Two batch requests decode; an interactive arrival preempts the most
    recently admitted one (the later slot on a tie), whose K/V spills; it
    restores bit for bit and rejoins decode once the slot frees."""
    kw = dict(slots=2, block_size=4, max_seq_len=32)
    jkv, tkv = JaxKV(2, 2, 4, **kw), PagedKVCache(2, 2, 4, device="cpu", **kw)
    js, ts = JaxSched(2, jkv), ContinuousBatchingScheduler(2, tkv)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 50, n) for n in (6, 9, 5)]
    pair = []
    for s, cls in ((js, JaxRequest), (ts, Request)):
        b = [s.submit(cls(prompt=prompts[j], max_new_tokens=8, id=j), now=0.0) for j in range(2)]
        s.admit(now=0.0)
        for r, n in zip(b, (3, 5)):  # as the engine leaves them: n tokens decoded
            r.state, r.prefill_pos = type(r.state).DECODE, r.prompt_len
            r.tokens = list(range(1, n + 1))
        pair.append(b)
    k = rng.standard_normal(tuple(jkv.cache_k.shape)).astype(np.float32)
    v = rng.standard_normal(tuple(jkv.cache_k.shape)).astype(np.float32)
    jkv.cache_k, jkv.cache_v = jnp.asarray(k), jnp.asarray(v)
    tkv.cache_k.copy_(torch.from_numpy(k))
    tkv.cache_v.copy_(torch.from_numpy(v))
    live = prompts[1].size + 4  # the victim's prompt and 4 decode writes
    before = [np.asarray(x) for x in tkv.gather_dense(1, live)]
    inter = []
    for s, cls in ((js, JaxRequest), (ts, Request)):
        inter.append(s.submit(cls(prompt=prompts[2], max_new_tokens=4, id=9,
                                  tier="interactive"), now=0.5))
        s.admit(now=0.5)
    assert _sched_state(js) == _sched_state(ts)
    (_, jb1), (_, tb1) = pair
    assert tb1.state is RequestState.PREEMPTED and tb1.kv_spill["length"] == live
    for name in ("k", "v"):
        for layer in ("layer0", "layer1"):
            assert (np.asarray(jb1.kv_spill["layers"][layer][name]).tobytes()
                    == tb1.kv_spill["layers"][layer][name].tobytes())
    for s, i in ((js, inter[0]), (ts, inter[1])):
        s.finish(i, now=1.0, reason="length")
        s.admit(now=1.0)
    assert _sched_state(js) == _sched_state(ts)
    assert tb1.state is RequestState.DECODE and tb1.prefill_pos == tb1.prompt_len
    assert tb1.kv_spill is None and tkv.spill_copies == 1 and tkv.restore_copies == 1
    after = [np.asarray(x) for x in tkv.gather_dense(tb1.slot, live)]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(before, after))
    tkv.check_invariants()


def test_shed_batch_queue_rejects_truthfully_as_jax():
    out = []
    for sched_cls, kv_cls, req_cls, extra in (
            (JaxSched, JaxKV, JaxRequest, {}),
            (ContinuousBatchingScheduler, PagedKVCache, Request, {"device": "cpu"})):
        sched = sched_cls(2, kv_cls(2, 4, 8, slots=2, block_size=8, max_seq_len=64, **extra))
        reqs = [sched.submit(req_cls(prompt=np.arange(4), max_new_tokens=8, id=i))
                for i in range(2)]
        reqs.append(sched.submit(req_cls(prompt=np.arange(4), max_new_tokens=8, id=2,
                                         tier="interactive")))
        n = sched.shed_batch_queue(0.0, "slo pressure")
        assert n == 2 and sched.shed == 2
        for r in reqs[:2]:
            assert r.state.value == "rejected"
            assert "shed" in r.finish_reason and "slo pressure" in r.finish_reason
        assert [r.id for r in sched.queue] == [2]  # interactive is never shed
        out.append([(r.id, r.finish_reason) for r in sched.rejected])
    assert out[0] == out[1]


# ------------------------------------------------------------------ engine: preemption
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_preemption_spill_restore_streams_equal_jax(jax_model, port_model, kv_dtype, tmp_path):
    """tests/test_serve_multitenant.py::test_preemption_spill_restore_bit_identical
    on the port: two batch decodes hold both slots, an interactive request
    lands mid-flight and preempts one; every stream equals the JAX
    engine's (and, in float32, its solo decode)."""
    kw = dict(slots=2, block_size=8, sync_every=2, kv_dtype=kv_dtype)
    engines = {"jax": _jax_engine(jax_model, **kw),
               "port": ServeEngine(port_model, device="cpu", metrics_out=str(tmp_path / "m.jsonl"),
                                   **kw)}
    got = {}
    for name, eng in engines.items():
        rng = np.random.default_rng(5)
        b0 = eng.submit(rng.integers(0, VOCAB, size=(4,)).astype(np.int32), 30,
                        tenant="acme", tier="batch")
        b1 = eng.submit(rng.integers(0, VOCAB, size=(4,)).astype(np.int32), 30,
                        tenant="acme", tier="batch")
        eng.sched.admit()
        eng._t0 = eng._now()
        for _ in range(6):
            eng._window()
        assert b0.state.value == b1.state.value == "decode"
        it = eng.submit(rng.integers(0, VOCAB, size=(3,)).astype(np.int32), 6,
                        tenant="vip", tier="interactive")
        rep = eng.run()
        assert rep.requests_finished == 3 and rep.requests_rejected == 0
        assert eng.sched.preemptions == 1 and b1.preemptions == 1
        assert it.preemptions == 0 and b0.preemptions == 0
        assert rep.preemptions == 1 and rep.per_tier["batch"]["preemptions"] == 1
        assert rep.per_tier["interactive"]["ttft_p99_ms"] is not None
        got[name] = (_streams((b0, b1, it)), rep)
    assert got["port"][0] == got["jax"][0]
    if kv_dtype == "fp32":
        for r in (b0, b1, it):
            assert got["port"][0][r.id] == _solo(jax_model, r.prompt, r.max_new_tokens)
    eng, rep = engines["port"], got["port"][1]
    assert rep.host_syncs == rep.windows and eng.host_syncs == 6 + rep.windows
    assert rep.kv_spill_copies == rep.kv_restore_copies == 1
    assert rep.kv_spill_bytes > 0 and rep.kv_restore_bytes >= rep.kv_spill_bytes
    eng.kv.check_invariants()
    serve = [r["metrics"]["serve"] for r in read_metrics(str(tmp_path / "m.jsonl"))]
    assert serve[-1]["preemptions_total"] == 1
    fin = [f for s in serve for f in s["finished"]]
    assert sum(f["preempted"] for f in fin) == 1


def test_preemption_spill_restores_into_another_slot(port_model):
    """Four batch decodes on four slots; two interactive arrivals take two
    of them; the victims come back (each into whatever slot frees) and
    finish with the streams they have when served without interruption."""
    kw = dict(slots=4, block_size=8, sync_every=2, prefill_chunk=8)
    rng = np.random.default_rng(8)
    batch = [(rng.integers(0, VOCAB, size=(int(n),)).astype(np.int32), 20) for n in (5, 9, 3, 12)]
    inter = [(rng.integers(0, VOCAB, size=(4,)).astype(np.int32), 5) for _ in range(2)]
    ref = ServeEngine(port_model, device="cpu", **kw)
    ref_reqs = [Request(prompt=p, max_new_tokens=n, id=i) for i, (p, n) in enumerate(batch)]
    ref.run(ref_reqs)
    eng = ServeEngine(port_model, device="cpu", **kw)
    bs = [eng.submit(p, n, req_id=i) for i, (p, n) in enumerate(batch)]
    eng.sched.admit()
    for _ in range(3):
        eng._window()
    assert all(b.state is RequestState.DECODE for b in bs)
    its = [eng.submit(p, n, req_id=10 + j, tier="interactive") for j, (p, n) in enumerate(inter)]
    rep = eng.run()
    assert rep.preemptions == 2 and sorted(b.preemptions for b in bs) == [0, 0, 1, 1]
    assert _streams(bs) == _streams(ref_reqs)
    assert all(len(r.tokens) == r.max_new_tokens for r in its)
    assert rep.host_syncs == rep.windows
    eng.kv.check_invariants()


# ------------------------------------------------------------------ engine: drain
def _mk_requests(cls=Request, n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, 10))
        out.append(cls(prompt=rng.integers(1, VOCAB, size=plen).astype(np.int64),
                       max_new_tokens=8 + int(rng.integers(0, 6)), id=i))
    return out


def test_sigterm_drain_and_resume_equal_the_undrained_run(jax_model, port_model, tmp_path):
    """tests/test_resilience.py::test_serve_drain_restart_bit_identical on
    the port: a real SIGTERM from the fault plan drains to an ffdrain/1
    file; a fresh engine resumes it; the combined streams equal the
    undrained run's (and the JAX engine's undrained run)."""
    kw = dict(slots=SLOTS, block_size=8, sync_every=4)
    base = _mk_requests()
    ServeEngine(port_model, device="cpu", **kw).run(base)
    want = _streams(base)
    jbase = _mk_requests(JaxRequest)
    _jax_engine(jax_model, **kw).run(jbase)
    assert want == _streams(jbase)

    drain_file = str(tmp_path / "drain.npz")
    handler = signal.getsignal(signal.SIGTERM)
    set_fault_plan(FaultPlan.parse("serve:sigterm@2", seed=0))
    eng2 = ServeEngine(port_model, device="cpu", drain_path=drain_file, **kw)
    reqs = _mk_requests()
    rep2 = eng2.run(reqs)
    set_fault_plan(None)
    assert eng2.sigterm_installed and signal.getsignal(signal.SIGTERM) == handler
    assert eng2.drained and rep2.drained and rep2.windows == 3
    assert os.path.exists(drain_file)
    payload = load_drain(drain_file)
    assert jax_load_drain(drain_file)["schema"] == "ffdrain/1"
    spilled = [d for d in payload["requests"] if d["kv_spill"] is not None]
    assert spilled and rep2.kv_spill_copies == len(spilled)

    eng3 = ServeEngine(port_model, device="cpu", **kw)
    restored = eng3.resume_from_drain(payload)
    rep3 = eng3.run()
    assert rep3.kv_restore_copies == len(spilled) and not rep3.drained
    got = {r.id: list(r.tokens) for r in reqs if r.state is RequestState.FINISHED}
    got.update(_streams(restored))
    assert got == want
    eng3.kv.check_invariants()


def test_jax_drain_file_resumes_on_the_port(jax_model, port_model, tmp_path):
    """The JAX engine drains (asked through request_drain after its second
    window, by a wrapper on this test's engine object) to a file the port
    resumes; the combined streams equal the JAX undrained run's."""
    kw = dict(slots=SLOTS, block_size=8, sync_every=4)
    jbase = _mk_requests(JaxRequest)
    _jax_engine(jax_model, **kw).run(jbase)
    drain_file = str(tmp_path / "jax_drain.npz")
    jeng = _jax_engine(jax_model, drain_path=drain_file, **kw)
    window = jeng._window

    def window_then_drain():
        window()
        if jeng.windows == 2:
            jeng.request_drain()

    jeng._window = window_then_drain
    jreqs = _mk_requests(JaxRequest)
    assert jeng.run(jreqs).drained
    eng = ServeEngine(port_model, device="cpu", **kw)
    restored = eng.resume_from_drain(load_drain(drain_file))
    assert any(r.kv_spill is not None for r in restored)
    eng.run()
    got = {r.id: list(r.tokens) for r in jreqs if r.state.value == "finished"}
    got.update(_streams(restored))
    assert got == _streams(jbase)


def test_resume_refuses_another_schema(port_model):
    eng = ServeEngine(port_model, device="cpu", slots=2, block_size=8)
    with pytest.raises(ValueError, match="ffdrain/1"):
        eng.resume_from_drain({"schema": "ffkv/1", "requests": []})


# ------------------------------------------------------------------ faults
SPECS = [
    "serve:sigterm@3",
    "serve:loader_stall@~2-9:0.01,serve:device_loss@~0-5",
    "serve:dcn_degrade@4:0.5, serve:loader_stall@~1-3",
    "device_loss@~3-40,serve:sigterm@~2-6,nan_grads@7",
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_jax(spec, seed, tmp_path):
    def events(plan):
        return [(e.kind, e.step, e.site, e.arg, e.fired) for e in plan.events]

    tp, jp = FaultPlan.parse(spec, seed=seed), jfaults.FaultPlan.parse(spec, seed=seed)
    assert events(tp) == events(jp) and tp.identity == jp.identity
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": seed, "spec": spec}))
    assert events(FaultPlan.from_file(str(path))) == events(jfaults.FaultPlan.from_file(str(path)))


def test_fault_plan_from_event_file_and_bad_specs(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 3, "events": [
        {"kind": "sigterm", "step": 2, "site": "serve"},
        {"kind": "loader_stall", "step": 1, "site": "serve", "arg": 0.01}]}))
    tp, jp = FaultPlan.from_file(str(path)), jfaults.FaultPlan.from_file(str(path))
    assert tp.identity == jp.identity == "seed3[serve:loader_stall@1:0.01;serve:sigterm@2]"
    for bad in ("serve:sigterm", "serve:melt@3", "serve:nan_grads@1"):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)


def test_fit_site_plan_is_refused():
    """The name predates the fit-site hook; a fit-site plan is now
    accepted and each event fires once, at the top of the step it names
    (``device_loss`` before that step changes anything, ``nan_grads``
    poisoning a weight in place, ``dcn_degrade`` flagging the executor),
    while a plan of bad grammar is still refused."""
    for bad in ("fit:device_loss", "fit:melt@1", "fit:nan_grads@-1"):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)
    plan = FaultPlan.parse("serve:sigterm@3,device_loss@2,fit:dcn_degrade@0,nan_grads@1")
    assert set_fault_plan(plan) is plan and get_fault_plan() is plan
    w = torch.zeros(3)
    ex = types.SimpleNamespace(_step_count=0, params={"l": {"kernel": w}}, dcn_degraded=False)
    plan.on_train_step(ex)
    assert ex.dcn_degraded and not torch.isnan(w).any()
    ex._step_count = 1
    plan.on_train_step(ex)
    assert torch.isnan(w).all()
    ex._step_count = 2
    with pytest.raises(InjectedFault, match="device_loss.*fit step 2"):
        plan.on_train_step(ex)
    plan.on_train_step(ex)  # each event fires once
    assert [e.fired for e in plan.events if e.site == "fit"] == [True, True, True]
    assert [e.fired for e in plan.events if e.site == "serve"] == [False]


def test_serve_faults_inject(port_model):
    eng = ServeEngine(port_model, device="cpu", slots=2, block_size=8, sync_every=2)
    set_fault_plan(FaultPlan.parse("serve:dcn_degrade@0,serve:device_loss@2"))
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.raises(InjectedFault, match="device_loss"):
        eng.run(_mk_requests(n=3))
    assert eng.dcn_degraded and eng.windows == 2
    assert signal.getsignal(signal.SIGTERM) == handler  # restored on the way out


def test_sigterm_without_a_handler_is_refused():
    plan = FaultPlan.parse("serve:sigterm@0")
    old = signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        with pytest.raises(RuntimeError, match="no SIGTERM handler"):
            plan.on_serve_window(types.SimpleNamespace(windows=0))
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL if old is None else old)


# ------------------------------------------------------------------ watchdog, shedding
def test_watchdog_fires_on_slow_windows(port_model):
    eng = ServeEngine(port_model, device="cpu", slots=SLOTS, block_size=8, sync_every=4,
                      watchdog_s=1e-9)
    rep = eng.run(_mk_requests(n=4))
    assert 0 < rep.watchdog_fires <= rep.windows
    eng2 = ServeEngine(port_model, device="cpu", slots=SLOTS, block_size=8, sync_every=4)
    assert eng2.run(_mk_requests(n=4)).watchdog_fires == 0


def test_shedding_under_slo_pressure_as_jax(jax_model, port_model):
    """One slot and an SLO no window meets: after the first window that
    flushes a token, the queued batch tier is shed, in both engines."""
    kw = dict(slots=1, block_size=8, sync_every=4, shed_after_windows=1, slo_ms=1e-9)
    jrep = _jax_engine(jax_model, **kw).run(_mk_requests(JaxRequest, n=4))
    reqs = _mk_requests(n=4)
    rep = ServeEngine(port_model, device="cpu", **kw).run(reqs)
    assert rep.shed == jrep.shed == 3 and rep.requests_rejected == 3
    assert rep.requests_finished == jrep.requests_finished == 1
    assert all(r.finish_reason.startswith("rejected: shed (sustained SLO pressure")
               for r in reqs if r.state is RequestState.REJECTED)


# ------------------------------------------------------------------ driver
def test_driver_drains_resumes_and_reports_preemptions(tmp_path, capsys):
    small = ["--device", "cpu", "--hidden", "16", "--heads", "2", "--ff-dim", "32",
             "--vocab", "40", "--seq", "48", "--max-new", "6:12", "--serve-slots", "2",
             "--serve-block-size", "8", "--tenants", "2", "--interactive-frac", "0.5"]
    f1, f2 = str(tmp_path / "d1.npz"), str(tmp_path / "d2.npz")
    assert driver_main(small + ["--requests", "6", "--serve-drain-file", f1,
                                "--fault-plan", "serve:sigterm@2"]) == 0
    first = json.loads(capsys.readouterr().out.strip())
    assert first["drained"] and first["fault_plan"] == "seed0[serve:sigterm@2]"
    assert os.path.exists(f1) and first["host_syncs"] == first["windows"]
    assert get_fault_plan() is None  # the driver's plan is gone after its run
    assert driver_main(small + ["--requests", "2", "--serve-drain-file", f2,
                                "--resume-drain", f1]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert not out["drained"] and not os.path.exists(f2)
    assert out["resumed_requests"] == 6 - first["requests_finished"]
    assert out["requests_finished"] == out["resumed_requests"] + 2
    for key in ("preemptions", "shed", "watchdog_fires", "kv_spill_copies",
                "kv_restore_copies"):
        assert key in out
    assert set(out["per_tier"]) == {"interactive", "batch"}
    assert all("ttft_p50_ms" in t for t in out["per_tier"].values())
