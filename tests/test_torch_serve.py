"""The port's serve engine against the JAX ``ServeEngine``, on the CPU.

A small JAX ``gpt_decoder`` (2 layers, hidden 32, 4 heads, ff 64, vocab
31, seq 48, 4 slots, as in tests/test_paged_attention.py) is compiled
once per module; its weights are carried into the port's
``GPTDecoder`` with ``load_jax_params``.  Both engines serve the same
``synthetic_requests``: the JAX one with ``attn="gather"``, the port on
``device="cpu"`` (where ``attn="auto"`` is the plain gather).  Greedy
streams must agree token for token and the first-step probabilities to
1e-5 (float32; the two frameworks sum in different orders).
"""

from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from flexflow_tpu import FFConfig, FFModel  # noqa: E402
from flexflow_tpu.models.transformer import gpt_decoder  # noqa: E402
from flexflow_tpu.obs import read_metrics  # noqa: E402
from flexflow_tpu.serve import ServeEngine as JaxEngine  # noqa: E402
from flexflow_tpu.serve import TrafficSpec as JaxSpec  # noqa: E402
from flexflow_tpu.serve import synthetic_requests as jax_requests  # noqa: E402
from flexflow_tpu_torch.models.transformer import GPTDecoder, load_jax_params  # noqa: E402
from flexflow_tpu_torch.serve import ServeEngine, TrafficSpec, synthetic_requests  # noqa: E402
from flexflow_tpu_torch.serve.driver import main as driver_main  # noqa: E402
from flexflow_tpu_torch.serve.scheduler import Request  # noqa: E402

SLOTS, SEQ, VOCAB = 4, 48, 31
SHAPE = dict(hidden=32, heads=4, ff_dim=64, num_layers=2, vocab=VOCAB)
TRAFFIC = dict(n_requests=7, seed=11, prompt_len=(3, 21), max_new=(2, 12), vocab=VOCAB)
ENGINE = dict(slots=SLOTS, block_size=8, prefill_chunk=8, sync_every=3)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_model():
    cfg = FFConfig(batch_size=SLOTS, compute_dtype="float32")
    m = FFModel(cfg)
    gpt_decoder(m, SLOTS, SEQ, use_flash=False, **SHAPE)
    m.compile(seed=0)
    return m


@pytest.fixture(scope="module")
def jax_params(jax_model):
    return {
        layer: {leaf: np.asarray(v) for leaf, v in leaves.items()}
        for layer, leaves in jax_model.executor.params.items()
    }


@pytest.fixture()
def port_model(jax_params):
    m = GPTDecoder(seq=SEQ, device="cpu", **SHAPE)
    load_jax_params(m, jax_params)
    return m


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies its host argument first.

    The JAX engine's window loop stages per-step decode positions with
    ``jnp.asarray(pos)`` and then advances ``pos`` in place while the
    step may still be queued; on the CPU backend ``asarray`` can alias
    the numpy buffer, so the step sometimes reads advanced positions and
    the reference's streams vary from run to run.  Giving the reference
    engine this shim (an attribute of the test's own engine object, not
    a change to the JAX package) makes it deterministic."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return getattr(jnp, name)

    def asarray(self, a, *args, **kwargs):
        import jax.numpy as jnp

        return jnp.asarray(np.array(a, copy=True), *args, **kwargs)


def _streams(reqs):
    return {r.id: [int(t) for t in r.tokens] for r in reqs}


@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16"])
def test_greedy_streams_match_jax_engine(jax_model, port_model, kv_dtype):
    jeng = JaxEngine(jax_model, attn="gather", kv_dtype=kv_dtype, **ENGINE)
    jeng._jnp = _CopyingJnp()
    jreqs = jax_requests(JaxSpec(**TRAFFIC))
    jrep = jeng.run(jreqs)
    teng = ServeEngine(port_model, device="cpu", kv_dtype=kv_dtype, **ENGINE)
    assert teng.attn_kernel == "gather"
    treqs = synthetic_requests(TrafficSpec(**TRAFFIC))
    trep = teng.run(treqs)
    assert trep.requests_finished == jrep.requests_finished == TRAFFIC["n_requests"]
    assert _streams(treqs) == _streams(jreqs)
    assert trep.new_tokens == jrep.new_tokens
    # the window schedule is the JAX engine's, window for window
    assert (trep.windows, trep.decode_steps, trep.prefill_chunks, trep.prefill_dispatches) == (
        jrep.windows, jrep.decode_steps, jrep.prefill_chunks, jrep.prefill_dispatches)
    assert trep.host_syncs == trep.windows
    assert trep.ttft_p50_ms is not None and trep.tpot_p99_ms is not None
    teng.kv.check_invariants()


def _programs_agree(jeng, teng, atol, pool_atol=None):
    """Both engines' programs on identical inputs: a prefill chunk for two
    lanes (one straddling a page), then one decode step on its outputs.
    Next tokens must be equal, probabilities within ``atol``, and the
    pools written within ``pool_atol`` (default ``atol``)."""
    import jax.numpy as jnp

    MB = teng.kv.max_blocks_per_seq
    assert MB == jeng.kv.max_blocks_per_seq
    P = ENGINE["prefill_chunk"]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, VOCAB, size=(SLOTS, P)).astype(np.int32)
    start = np.array([0, 5, 0, 0], np.int32)
    n_valid = np.array([8, 6, 0, 0], np.int32)
    bt = np.zeros((SLOTS, MB), np.int32)
    bt[0, :2] = [3, 1]
    bt[1, :2] = [2, 4]
    res = jeng._prefill(jeng._params_arg, *jeng._kvs(), *map(jnp.asarray, (toks, start, n_valid, bt)))
    jeng._store_kvs(res[2:])
    j_nxt, j_probs = np.asarray(res[0]), np.asarray(res[1])
    t_nxt, t_probs = teng._prefill(*map(torch.from_numpy, (toks, start, n_valid, bt)))
    np.testing.assert_allclose(t_probs.numpy()[:2], j_probs[:2], atol=atol, rtol=0)
    np.testing.assert_array_equal(t_nxt.numpy()[:2], j_nxt[:2])
    pos = np.array([8, 11, 0, 0], np.int32)
    cur = j_nxt.astype(np.int32)
    res = jeng._decode(jeng._params_arg, *jeng._kvs(), *map(jnp.asarray, (cur, pos, bt)))
    t_nxt, t_probs = teng._decode(*map(torch.from_numpy, (cur, pos, bt)))
    np.testing.assert_allclose(t_probs.numpy()[:2], np.asarray(res[1])[:2], atol=atol, rtol=0)
    np.testing.assert_array_equal(t_nxt.numpy()[:2], np.asarray(res[0])[:2])
    for name, j_pool in (("cache_k", res[2]), ("cache_v", res[3])):
        np.testing.assert_allclose(
            getattr(teng.kv, name).float().numpy(), np.asarray(j_pool, np.float32),
            atol=atol if pool_atol is None else pool_atol, rtol=0,
        )


def test_first_step_probs_match_jax(jax_model, port_model):
    _programs_agree(
        JaxEngine(jax_model, attn="gather", **ENGINE),
        ServeEngine(port_model, device="cpu", **ENGINE),
        atol=1e-5,
    )


def _jax_gpt(compute_dtype="float32", attn_bias=False):
    cfg = FFConfig(batch_size=SLOTS, compute_dtype=compute_dtype)
    m = FFModel(cfg)
    with pytest.MonkeyPatch.context() as mp:
        if attn_bias:
            # gpt_decoder builds attention without biases; the JAX
            # ``multihead_attention(bias=True)`` option adds bq/bk/bv/bo
            mp.setattr(FFModel, "multihead_attention", functools.partialmethod(
                FFModel.multihead_attention, bias=True))
        gpt_decoder(m, SLOTS, SEQ, use_flash=False, **SHAPE)
    m.compile(seed=0)
    return m


def _carry(jax_m, **kw):
    params = {
        layer: {leaf: np.asarray(v, np.float32) for leaf, v in leaves.items()}
        for layer, leaves in jax_m.executor.params.items()
    }
    m = GPTDecoder(seq=SEQ, device="cpu", **SHAPE, **kw)
    load_jax_params(m, params)
    return m


def test_bf16_compute_matches_jax():
    """bfloat16 compute: weights cast at use, pools in bfloat16.  The JAX
    gather path takes its attention softmax in bfloat16 and the port's
    plain version in float32, so probabilities agree to 1e-2 (a few
    bfloat16 roundings of values below 1) and next tokens exactly.  The
    pools agree to 5e-2: the second layer's K/V inherit the first layer's
    rounding differences, at values up to ~3 where one bfloat16 step is
    1.6e-2."""
    jm = _jax_gpt("bfloat16")
    teng = ServeEngine(_carry(jm), device="cpu", dtype=torch.bfloat16, **ENGINE)
    assert teng.kv.cache_k.dtype == torch.bfloat16
    _programs_agree(JaxEngine(jm, attn="gather", **ENGINE), teng, atol=1e-2, pool_atol=5e-2)


def test_attention_biases_match_jax():
    """``attn_bias=True`` carries the JAX ``bq/bk/bv/bo`` leaves (made
    non-zero here) and the serve programs apply them."""
    import jax.numpy as jnp

    jm = _jax_gpt(attn_bias=True)
    rng = np.random.default_rng(9)
    for i in range(SHAPE["num_layers"]):
        leaves = jm.executor.params[f"dec{i}_attn"]
        for b in ("bq", "bk", "bv", "bo"):
            leaves[b] = jnp.asarray(0.1 * rng.standard_normal(leaves[b].shape), jnp.float32)
    tm = _carry(jm, attn_bias=True)
    assert tuple(tm.dec1_attn.bo.shape) == (SHAPE["hidden"],)
    _programs_agree(
        JaxEngine(jm, attn="gather", **ENGINE), ServeEngine(tm, device="cpu", **ENGINE),
        atol=1e-5,
    )


def test_scheduler_matches_jax():
    """Admission, FIFO order, rejection, deadline expiry and slot recycling
    on the JAX and the port scheduler, step for step."""
    from flexflow_tpu.serve.kvcache import PagedKVCache as JaxKV
    from flexflow_tpu.serve.scheduler import ContinuousBatchingScheduler as JaxSched
    from flexflow_tpu.serve.scheduler import Request as JaxRequest
    from flexflow_tpu_torch.serve.kvcache import PagedKVCache
    from flexflow_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    kw = dict(slots=2, block_size=4, num_blocks=8, max_seq_len=24)
    js = JaxSched(2, JaxKV(2, 2, 4, **kw))
    ts = ContinuousBatchingScheduler(2, PagedKVCache(2, 2, 4, device="cpu", **kw))
    rng = np.random.default_rng(2)
    shapes = [(5, 4, None), (9, 10, None), (20, 10, None), (6, 3, 500.0), (3, 2, None)]
    prompts = [rng.integers(0, 50, n) for n, _, _ in shapes]

    def state(s):
        return (
            {slot: (r.id, r.state.value, r.prefill_pos) for slot, r in s.active.items()},
            [r.id for r in s.queue],
            [(r.id, r.finish_reason) for r in s.rejected],
            [(r.id, r.finish_reason) for r in s.finished],
            sorted(s.free_slots), s.expired,
        )

    for sched, req_cls in ((js, JaxRequest), (ts, Request)):
        for i, ((_, new, dl), p) in enumerate(zip(shapes, prompts)):
            sched.submit(req_cls(prompt=p, max_new_tokens=new, id=i, deadline_ms=dl), now=0.0)
    assert state(js) == state(ts)
    for sched in (js, ts):
        sched.admit(now=0.1)
    assert state(js) == state(ts)
    for sched in (js, ts):
        sched.finish(sched.active[0], 0.2, "length")
        sched.admit(now=1.0)  # request 3 waited 1000 ms > 500 ms
    assert state(js) == state(ts)
    assert ts.expired == 1 and len(ts.rejected) == 2
    for sched in (js, ts):
        for r in list(sched.active.values()):
            sched.finish(r, 1.1, "eos")
        sched.admit(now=1.2)
    assert state(js) == state(ts)
    ts.kv.check_invariants()


def test_load_jax_params_refuses_mismatches(jax_params):
    m = GPTDecoder(seq=SEQ, device="cpu", **SHAPE)
    missing = {k: dict(v) for k, v in jax_params.items()}
    del missing["dec1_ff0"]["bias"]
    with pytest.raises(ValueError, match="missing.*dec1_ff0.bias"):
        load_jax_params(m, missing)
    extra = {k: dict(v) for k, v in jax_params.items()}
    extra["dec0_attn"]["bq"] = np.zeros(32, np.float32)
    with pytest.raises(ValueError, match="extra.*dec0_attn.bq"):
        load_jax_params(m, extra)
    bad = {k: dict(v) for k, v in jax_params.items()}
    bad["lm_head"]["kernel"] = np.zeros((32, VOCAB + 1), np.float32)
    before = m.lm_head.kernel.detach().clone()
    with pytest.raises(ValueError, match="lm_head.kernel"):
        load_jax_params(m, bad)
    torch.testing.assert_close(m.lm_head.kernel.detach(), before)  # nothing written


def test_parameter_names_and_shapes_match_gpt_decoder(jax_params):
    m = GPTDecoder(seq=SEQ, device="cpu", **SHAPE)
    want = {f"{l}.{k}": v.shape for l, leaves in jax_params.items() for k, v in leaves.items()}
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == want


def test_default_device_without_cuda_raises(monkeypatch, port_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(port_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTDecoder(seq=SEQ, **SHAPE)


def test_explicit_paged_on_cpu_raises(port_model):
    with pytest.raises(ValueError, match="CUDA"):
        ServeEngine(port_model, device="cpu", attn="paged", **ENGINE)


def test_metrics_stream_reads_back_through_jax_reader(port_model, tmp_path):
    path = str(tmp_path / "serve.jsonl")
    eng = ServeEngine(port_model, device="cpu", metrics_out=path, **ENGINE)
    rep = eng.run(synthetic_requests(TrafficSpec(**TRAFFIC)))
    recs = read_metrics(path)
    assert len(recs) == rep.windows
    assert all(r["schema"] == "ffmetrics/1" for r in recs)
    serve = [r["metrics"]["serve"] for r in recs]
    assert sum(s["decode_steps"] for s in serve) == rep.decode_steps
    assert sum(s["prefill_dispatches"] for s in serve) == rep.prefill_dispatches
    assert sum(len(s["finished"]) for s in serve) == rep.requests_finished
    assert {s["attn_kernel"] for s in serve} == {"gather"}


def test_driver_prints_one_json_summary(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    rc = driver_main([
        "--device", "cpu", "--requests", "3", "--hidden", "16", "--heads", "2",
        "--ff-dim", "32", "--vocab", "40", "--seq", "32", "--max-new", "2:5",
        "--serve-block-size", "8", "--metrics-out", str(path),
    ])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["requests_finished"] == 3 and out["host_syncs"] == out["windows"]
    assert out["device"] == "cpu" and out["attn_kernel"] == "gather"
    assert out["attn_launches"] == 0
    assert len(read_metrics(str(path))) == out["windows"]
