"""The port's greedy speculative decoding against the JAX package, on the CPU.

The JAX ``ServeEngine`` (``attn="gather"``) and the port
(``device="cpu"``) get the same weights and the same inputs:

* the draft program (the decode step cut to ``spec_draft_layers``
  layers) must give the same next tokens, and the verify program (all
  layers over k+1 rows per lane, acceptance on the device) the same
  argmax rows, accepted counts, next tokens and next positions, with the
  pools written alike outside the trash block (float32 pools within
  1e-5; quantized pools byte for byte, scales within 1e-6 relative);
* served streams, the window schedule and the draft/accept counts must
  equal the JAX engine's, and each stream must equal the plain greedy
  stream (verify rows compute the full model's argmax, so only tokens it
  agrees with are emitted);
* every window still ends in one host sync, and the window records
  carry the ``spec`` vocabulary.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
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
TRAFFIC = dict(n_requests=6, seed=8, prompt_len=(2, 12), max_new=(4, 12), vocab=VOCAB)
ENGINE = dict(slots=SLOTS, block_size=8, prefill_chunk=8, sync_every=4)


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
def port_model(jax_model):
    params = {
        layer: {leaf: np.asarray(v) for leaf, v in leaves.items()}
        for layer, leaves in jax_model.executor.params.items()
    }
    m = GPTDecoder(seq=SEQ, device="cpu", **SHAPE)
    load_jax_params(m, params)
    return m


def _pools_agree(teng, j_pools):
    """The port's pools against JAX's, outside the trash block 0 (which
    several padded rows write, in no defined order)."""
    kv = teng.kv
    for name, j in zip(("cache_k", "cache_v"), j_pools[:2]):
        t = getattr(kv, name)
        if kv.quantized:
            np.testing.assert_array_equal(
                t.view(torch.uint8).numpy()[:, 1:], np.asarray(j).view(np.uint8)[:, 1:])
        else:
            np.testing.assert_allclose(t.numpy()[:, 1:], np.asarray(j)[:, 1:], atol=1e-5, rtol=0)
    if kv.quantized:
        for name, j in zip(("scale_k", "scale_v"), j_pools[2:]):
            np.testing.assert_allclose(getattr(kv, name).numpy()[:, 1:], np.asarray(j)[:, 1:],
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_draft_and_verify_programs_match_jax(jax_model, port_model, kv_dtype):
    k = 2
    jeng = JaxEngine(jax_model, attn="gather", kv_dtype=kv_dtype, spec_k=k, **ENGINE)
    teng = ServeEngine(port_model, device="cpu", kv_dtype=kv_dtype, spec_k=k, **ENGINE)
    assert teng.spec_draft_layers == jeng.spec_draft_layers == 1
    nq = 4 if teng.kv.quantized else 2  # pools threaded through the JAX programs
    MB = teng.kv.max_blocks_per_seq
    rng = np.random.default_rng(5)
    # a prompt chunk for lanes 0 and 1 (lane 1 straddles a page), then
    # speculative steps from positions 8 and 11; lanes 2, 3 idle
    toks = rng.integers(0, VOCAB, size=(SLOTS, 8)).astype(np.int32)
    start = np.array([0, 5, 0, 0], np.int32)
    n_valid = np.array([8, 6, 0, 0], np.int32)
    bt = np.zeros((SLOTS, MB), np.int32)
    bt[0, :3] = [3, 1, 6]
    bt[1, :3] = [2, 4, 5]
    res = jeng._prefill(jeng._params_arg, *jeng._kvs(),
                        *map(jnp.asarray, (toks, start, n_valid, bt)))
    jeng._store_kvs(res[2:])
    t_cur, _ = teng._prefill(*map(torch.from_numpy, (toks, start, n_valid, bt)))
    cur = np.asarray(res[0]).astype(np.int32)
    np.testing.assert_array_equal(t_cur.numpy()[:2], cur[:2])
    pos0 = np.array([8, 11, 0, 0], np.int32)
    bt_t = torch.from_numpy(bt)
    for _ in range(2):  # two macro steps, the second from the first's outputs
        drafts, c, p = [], cur, pos0
        for _ in range(k):
            res = jeng._draft(jeng._params_arg, *jeng._kvs(), *map(jnp.asarray, (c, p, bt)))
            jeng._store_kvs(res[1:])
            t_d = teng._draft(torch.from_numpy(c), torch.from_numpy(p), bt_t)
            c = np.asarray(res[0]).astype(np.int32)
            np.testing.assert_array_equal(t_d.numpy()[:2], c[:2])
            drafts.append(c)
            p = p + 1
        vt = np.stack([cur] + drafts, axis=1).astype(np.int32)
        res = jeng._verify(jeng._params_arg, *jeng._kvs(), *map(jnp.asarray, (vt, pos0, bt)))
        jeng._store_kvs(res[4:])
        t_res = teng._verify(torch.from_numpy(vt), torch.from_numpy(pos0), bt_t)
        n, acc, nxt, npos = (np.asarray(a) for a in res[:4])
        for got, want in zip(t_res, (n, acc, nxt, npos)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy()[:2], want[:2])
        # acceptance: the longest prefix of drafts that equal the argmax of
        # the row before them
        for b in range(2):
            a = 0
            while a < k and vt[b, a + 1] == n[b, a]:
                a += 1
            assert acc[b] == a and nxt[b] == n[b, a] and npos[b] == pos0[b] + a + 1
        _pools_agree(teng, res[4:4 + nq])
        cur, pos0 = nxt.astype(np.int32), npos.astype(np.int32)


def test_warmup_writes_only_the_trash_block(port_model):
    eng = ServeEngine(port_model, device="cpu", kv_dtype="int8", spec_k=3, **ENGINE)
    assert eng.spec_draft_layers == 1
    for t in (eng.kv.cache_k, eng.kv.cache_v, eng.kv.scale_k, eng.kv.scale_v):
        assert not t[:, 1:].any()
        assert t[:, 0].any()


def _copying(jeng):
    """The JAX engine with the copying ``jnp`` of tests/test_torch_serve.py."""
    from test_torch_serve import _CopyingJnp

    jeng._jnp = _CopyingJnp()
    return jeng


def _streams(reqs):
    return {r.id: [int(t) for t in r.tokens] for r in reqs}


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_spec_streams_match_jax_engine_and_plain_greedy(jax_model, port_model, kv_dtype):
    arm = dict(kv_dtype=kv_dtype, spec_k=2, **ENGINE)
    jeng = _copying(JaxEngine(jax_model, attn="gather", **arm))
    jreqs = jax_requests(JaxSpec(**TRAFFIC))
    jrep = jeng.run(jreqs)
    teng = ServeEngine(port_model, device="cpu", **arm)
    treqs = synthetic_requests(TrafficSpec(**TRAFFIC))
    trep = teng.run(treqs)
    assert trep.requests_finished == jrep.requests_finished == TRAFFIC["n_requests"]
    assert all(len(r.tokens) == r.max_new_tokens for r in treqs)
    assert _streams(treqs) == _streams(jreqs)
    assert (trep.windows, trep.decode_steps, trep.prefill_chunks, trep.prefill_dispatches) == (
        jrep.windows, jrep.decode_steps, jrep.prefill_chunks, jrep.prefill_dispatches)
    assert (trep.spec_k, trep.spec_draft_layers, trep.spec_drafted, trep.spec_accepted) == (
        jrep.spec_k, jrep.spec_draft_layers, jrep.spec_drafted, jrep.spec_accepted)
    assert trep.spec_accepted > 0 and trep.spec_accept_rate == jrep.spec_accept_rate
    assert trep.host_syncs == trep.windows
    assert trep.decode_steps % (arm["spec_k"] + 1) == 0  # macros x (k + 1) programs
    # the same requests without speculation: the same greedy streams
    plain = synthetic_requests(TrafficSpec(**TRAFFIC))
    ServeEngine(port_model, device="cpu", kv_dtype=kv_dtype, **ENGINE).run(plain)
    assert _streams(plain) == _streams(treqs)
    teng.kv.check_invariants()


# with rows past the table's end clipped onto its last page, seeds 0, 2
# and 6 left the plain stream, and every seed's last page lost real K/V
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 6])
def test_spec_rows_past_the_table_end_leave_real_positions_alone(seed, monkeypatch):
    """Budgets that fill the block table (seq 32 = 8 blocks of 4): a
    speculative macro runs up to k rows past the last position, and those
    rows must write the trash block, not the lane's last page.  The port
    only: the JAX engine clips them onto the last page."""
    m = GPTDecoder(seq=32, hidden=32, heads=4, ff_dim=64, num_layers=4, vocab=VOCAB,
                   seed=seed, device="cpu")
    engine = dict(slots=2, block_size=4, prefill_chunk=8, sync_every=4, device="cpu")

    def run(spec_k):
        rng = np.random.RandomState(seed)
        reqs = [Request(prompt=rng.randint(0, VOCAB, n), max_new_tokens=new, id=i)
                for i, (n, new) in enumerate([(20, 12), (17, 15)])]
        eng = ServeEngine(m, spec_k=spec_k, **engine)
        tables = {}
        reserve = eng.kv.reserve

        def spy(slot, seq_len, prompt=None):
            tables[tuple(prompt)] = reserve(slot, seq_len, prompt)
            return tables[tuple(prompt)]

        monkeypatch.setattr(eng.kv, "reserve", spy)
        rep = eng.run(reqs)
        assert rep.requests_finished == 2
        assert [r.prompt_len + r.max_new_tokens for r in reqs] == [32, 32]
        # the last fed token sits at 30: page 7 holds real positions 28-30
        last = {r.id: tables[tuple(r.prompt)][-1] for r in reqs}
        kv = eng.kv
        return _streams(reqs), {i: (kv.cache_k[:, b, :, :3], kv.cache_v[:, b, :, :3])
                                for i, b in last.items()}

    plain, plain_pages = run(0)
    spec, spec_pages = run(3)
    assert spec == plain
    for i, (k, v) in spec_pages.items():
        np.testing.assert_allclose(k.numpy(), plain_pages[i][0].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(v.numpy(), plain_pages[i][1].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("asked, used", [(0, 2), (1, 1), (3, 3), (4, 2), (-3, 2)])
def test_default_draft_depth(asked, used):
    """A draft depth outside 1 .. L-1 falls back to half the depth (at
    least one layer), as the JAX engine does; 4 layers here."""
    m = GPTDecoder(seq=SEQ, device="cpu", **{**SHAPE, "num_layers": 4})
    assert ServeEngine(m, device="cpu", spec_k=1, spec_draft_layers=asked,
                       **ENGINE).spec_draft_layers == used
    off = ServeEngine(m, device="cpu", spec_draft_layers=asked, **ENGINE)
    rep = off.run(synthetic_requests(TrafficSpec(**{**TRAFFIC, "n_requests": 1})))
    assert off.spec_k == 0 and rep.spec_draft_layers == 0 and rep.spec_accept_rate is None


def test_spec_window_records_and_report(port_model, tmp_path):
    path = str(tmp_path / "spec.jsonl")
    eng = ServeEngine(port_model, device="cpu", kv_dtype="fp8", spec_k=3, metrics_out=path,
                      **ENGINE)
    rep = eng.run(synthetic_requests(TrafficSpec(**TRAFFIC)))
    recs = read_metrics(path)
    assert len(recs) == rep.windows == rep.host_syncs
    specs = [r["metrics"]["serve"]["spec"] for r in recs if "spec" in r["metrics"]["serve"]]
    assert len(specs) == rep.windows
    assert {(s["k"], s["draft_layers"]) for s in specs} == {(3, 1)}
    assert sum(s["drafted"] for s in specs) == rep.spec_drafted > 0
    assert sum(s["accepted"] for s in specs) == rep.spec_accepted
    assert rep.spec_accept_rate == rep.spec_accepted / rep.spec_drafted
    d = rep.to_dict()
    assert {"spec_k", "spec_draft_layers", "spec_accept_rate", "spec_drafted",
            "spec_accepted"} <= set(d)


def test_driver_spec_flags(capsys):
    """The README's CPU command: int8 pools and speculative decoding."""
    rc = driver_main(["--device", "cpu", "--serve-kv-dtype", "int8", "--serve-spec-k", "2",
                      "--requests", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["kv_dtype"] == "int8" and out["spec_k"] == 2
    assert out["spec_draft_layers"] == 1 and out["spec_drafted"] > 0
    assert out["requests_finished"] == 4 and out["host_syncs"] == out["windows"]
    assert out["attn_launches"] == 0
