"""``gpt_decoder`` through the port's ``FFModel`` against the JAX
package's, on the CPU: train steps, the broadcast ``embed_add``, the
``parameter`` op, ``sample_next`` and ``gpt_generate``, and the trained
weights served by the port's ``ServeEngine``.

The decoder: 2 layers, hidden 32, 2 heads, ff 64, vocab 97, seq 16,
batch 2; the JAX model compiles on a ``(1, 1)`` mesh and the port takes
its weights through ``set_weights(jax_model.get_weights())``.  Labels
are the next token of each position, (batch * seq, 1), fed to
``train_step`` by hand as ``examples/gpt/gpt.py`` does.

Tolerances: losses within 1e-5 relative over 3 Adam steps, weights
within 1e-4 absolute (Adam's first steps move a weight by about alpha
whatever its gradient's size); ``embed_add`` forward and gradients 1e-6;
generated tokens equal, greedy and sampled; the engine's greedy streams
equal to ``gpt_generate``'s.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import flexflow_tpu.ops  # noqa: E402,F401  (registers the JAX ops)
import flexflow_tpu.obs.health as jhealth  # noqa: E402
import flexflow_tpu.obs.trace as jtrace  # noqa: E402
import flexflow_tpu.ops.pallas.flash_attention as jfa  # noqa: E402
from flexflow_tpu import (  # noqa: E402
    AdamOptimizer, FFConfig, FFModel, LossType, MachineMesh, MetricsType,
)
from flexflow_tpu import fftype as jft  # noqa: E402
from flexflow_tpu import tensor as jtensor  # noqa: E402
from flexflow_tpu.models import transformer as jtr  # noqa: E402
from flexflow_tpu.ops.base import OpContext as JCtx  # noqa: E402
from flexflow_tpu.ops.base import get_op_def as jget  # noqa: E402
from flexflow_tpu_torch import fftype as tft  # noqa: E402
from flexflow_tpu_torch import optimizer as topt  # noqa: E402
from flexflow_tpu_torch import tensor as ttensor  # noqa: E402
from flexflow_tpu_torch.config import FFConfig as TConfig  # noqa: E402
from flexflow_tpu_torch.initializer import GlorotUniform  # noqa: E402
from flexflow_tpu_torch.model import FFModel as TModel  # noqa: E402
from flexflow_tpu_torch.models import transformer as ttr  # noqa: E402
from flexflow_tpu_torch.ops.base import OpContext as TCtx  # noqa: E402
from flexflow_tpu_torch.ops.base import get_op_def as tget  # noqa: E402
from flexflow_tpu_torch.serve import ServeEngine  # noqa: E402
from flexflow_tpu_torch.serve.scheduler import Request  # noqa: E402

B, S, HID, HEADS, FF, LAYERS, VOCAB = 2, 16, 32, 2, 64, 2, 97
SHAPE = dict(hidden=HID, heads=HEADS, ff_dim=FF, num_layers=LAYERS, vocab=VOCAB)


def _quiet_jax(mp):
    """Pallas in interpret mode; a disabled run-health monitor and tracer
    (a JAX model built earlier in the process may have left either on)."""
    mp.setattr(jfa, "INTERPRET", True)
    mp.setattr(jhealth, "_MONITOR", jhealth.HealthMonitor())
    mp.setattr(jtrace, "_TRACER", jtrace.Tracer())


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    _quiet_jax(monkeypatch)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair():
    jm = FFModel(FFConfig(batch_size=B))
    jtr.gpt_decoder(jm, B, S, **SHAPE)
    jm.compile(optimizer=AdamOptimizer(alpha=1e-3),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY], mesh=MachineMesh((1, 1), ("data", "model")),
               seed=0)
    tm = TModel(TConfig(batch_size=B, device="cpu"))
    ttr.gpt_decoder(tm, B, S, **SHAPE)
    tm.compile(topt.AdamOptimizer(alpha=1e-3), metrics=[tft.MetricsType.ACCURACY])
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    tm.set_weights(jm.get_weights())
    return jm, tm


def _batch(seed):
    """A stride-3 cycle per row from a random start; labels: next tokens."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, VOCAB, size=B)
    ids = ((starts[:, None] + np.arange(S)[None, :] * 3) % VOCAB).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).reshape(B * S, 1).astype(np.int32)


@pytest.fixture(scope="module")
def trained():
    """Both models after 3 train steps on the same batches."""
    with pytest.MonkeyPatch.context() as mp:
        _quiet_jax(mp)
        jm, tm = _pair()
        losses = []
        for step in range(3):
            ids, y = _batch(step)
            jl, jmet = jm.executor.train_step([ids], y)
            tl, tmet = tm.executor.train_step([ids], y)
            losses.append((float(jl), float(tl), float(jmet["accuracy"]),
                           float(tmet["accuracy"])))
    return jm, tm, losses


def test_gpt_decoder_train_steps_match_jax(trained):
    jm, tm, losses = trained
    for jl, tl, jacc, tacc in losses:
        assert math.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl)
        assert tacc == pytest.approx(jacc)
    jw, tw = jm.get_weights(), tm.get_weights()
    assert sorted(jw) == sorted(tw)
    assert "pos_embed" in tw and tw["pos_embed"]["value"].shape == (S, HID)
    assert "bias" not in tw["lm_head"]
    for layer in jw:
        for w in jw[layer]:
            assert np.abs(tw[layer][w] - jw[layer][w]).max() <= 1e-4, (layer, w)


def test_weights_fit_the_serving_decoder(trained):
    """The names and shapes ``gpt_decoder`` + ``compile`` create are
    exactly ``GPTDecoder``'s, so ``load_jax_params`` takes them."""
    _, tm, _ = trained
    dec = ttr.GPTDecoder(seq=S, device="cpu", **SHAPE)
    want = {layer: {w: tuple(t.shape) for w, t in ws.items()}
            for layer, ws in dec.param_tree().items()}
    got = {layer: {w: a.shape for w, a in ws.items()} for layer, ws in tm.get_weights().items()}
    assert got == want


def test_embed_add_broadcast_matches_jax():
    """``embed_add``: (B, S, H) token rows plus the (S, H) position table;
    the table's gradient sums over the batch."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, S, HID)).astype(np.float32)
    b = rng.normal(size=(S, HID)).astype(np.float32)
    cot = rng.normal(size=(3, S, HID)).astype(np.float32)
    jl = jtensor.Layer(jft.OperatorType.EW_ADD, "embed_add",
                       [jtensor.Tensor(a.shape), jtensor.Tensor(b.shape)], {})
    tl = ttensor.Layer(tft.OperatorType.EW_ADD, "embed_add",
                       [ttensor.Tensor(a.shape), ttensor.Tensor(b.shape)], {})
    assert tuple(tget(tl.op_type).infer(tl)[0][0]) == (3, S, HID)

    def jf(x, y):
        out = jget(jl.op_type).forward(jl, {}, [x, y], JCtx(training=True))[0]
        return jnp.sum(out * cot), out

    (_, jout), (jga, jgb) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(v.copy()).requires_grad_() for v in (a, b))
    tout = tget(tl.op_type).forward(tl, {}, [ta, tb], TCtx(True, torch.device("cpu")))[0]
    (tout * torch.from_numpy(cot)).sum().backward()
    for got, want in ((tout, jout), (ta.grad, jga), (tb.grad, jgb)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_parameter_op_matches_jax_and_refuses_state():
    """``parameter``: weight ``value`` of the given shape, Glorot uniform by
    default as in the JAX op.  A non-trainable float weight and an integer
    one (zero-initialised) build as executor state, as in the JAX package:
    no gradient and no optimizer slot, and their values match JAX's after
    a training step."""
    attrs = dict(shape=(S, HID), trainable=True)
    jl = jtensor.Layer(jft.OperatorType.WEIGHT, "p", [], dict(attrs, dtype=jft.DataType.FLOAT))
    tl = ttensor.Layer(tft.OperatorType.WEIGHT, "p", [], dict(attrs, dtype=tft.DataType.FLOAT))
    (jw,), (tw,) = jget(jl.op_type).weights(jl), tget(tl.op_type).weights(tl)
    assert (tw.name, tuple(tw.shape)) == (jw.name, tuple(jw.shape)) == ("value", (S, HID))
    assert type(tw.initializer).__name__ == type(jw.initializer).__name__ == "GlorotUniform"
    assert isinstance(tw.initializer, GlorotUniform)
    for trainable, dt in ((False, "FLOAT"), (True, "INT32"), (False, "INT32")):
        a = dict(shape=(S,), trainable=trainable)
        jl = jtensor.Layer(jft.OperatorType.WEIGHT, "p", [],
                           dict(a, dtype=getattr(jft.DataType, dt)))
        tl = ttensor.Layer(tft.OperatorType.WEIGHT, "p", [],
                           dict(a, dtype=getattr(tft.DataType, dt)))
        (jw,), (tw,) = jget(jl.op_type).weights(jl), tget(tl.op_type).weights(tl)
        assert tw.trainable is jw.trainable is False
        assert type(tw.initializer).__name__ == type(jw.initializer).__name__

    def build(m, ft):
        x = m.create_tensor((2, HID))
        w = m.parameter((S, HID), name="pos")
        frozen = m.parameter((HID,), trainable=False, name="frozen")
        m.parameter((S,), dtype=ft.DataType.INT32, name="ids")
        h = m.add(m.dense(x, S, name="proj"), m.reduce_mean(w, axes=[1], name="wmean"),
                  name="mix")
        m.softmax(m.dense(m.add(x, frozen, name="shift"), S, name="head"), name="probs")
        return h

    jm = FFModel(FFConfig(batch_size=2))
    build(jm, jft)
    jm.compile(optimizer=AdamOptimizer(alpha=1e-3),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               mesh=MachineMesh((1, 1), ("data", "model")), seed=0)
    tm = TModel(TConfig(device="cpu", batch_size=2))
    out = build(tm, tft)
    assert out.shape == (2, S) and tm.layers[1].op_type is tft.OperatorType.WEIGHT
    tm.compile(topt.AdamOptimizer(alpha=1e-3))
    ex = tm.executor
    assert sorted(ex.state) == ["frozen", "ids"] and "pos" in ex.params
    assert ex.state["ids"]["value"].dtype == torch.int32
    assert not any(t.requires_grad for ws in ex.state.values() for t in ws.values())
    assert sorted(ex.opt_state_by_name()["m"]) == sorted(ex.params)  # no slot for state
    tm.set_weights(jm.get_weights())
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, HID)).astype(np.float32)
    y = rng.integers(0, S, size=(2, 1)).astype(np.int32)
    jloss = float(jm.executor.train_step([x], y)[0])
    tloss = float(ex.train_step([x], y)[0])
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    jw, tw = jm.get_weights(), tm.get_weights()
    assert sorted(jw) == sorted(tw)
    for ln in jw:
        for wn in jw[ln]:
            np.testing.assert_allclose(tw[ln][wn], np.asarray(jw[ln][wn]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tw["ids"]["value"], np.zeros(S, np.int32))


@pytest.mark.parametrize("kind", ["greedy", "sampled", "top_k", "top_p"])
def test_sample_next_draws_as_jax(kind):
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(VOCAB) * 0.3, size=4).astype(np.float32)
    kw = {"greedy": dict(temperature=0.0), "sampled": dict(temperature=0.7),
          "top_k": dict(temperature=1.0, top_k=5),
          "top_p": dict(temperature=1.2, top_p=0.6)}[kind]
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        want = jtr.sample_next(probs, rng=jr, **kw)
        got = ttr.sample_next(probs, rng=tr, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["greedy", "sampled", "top_k", "top_p"])
def test_gpt_generate_matches_jax(kind, trained):
    jm, tm, _ = trained
    kw = {"greedy": {}, "sampled": dict(temperature=0.8, seed=3),
          "top_k": dict(temperature=1.0, top_k=5, seed=4),
          "top_p": dict(temperature=1.0, top_p=0.9, seed=5)}[kind]
    prompt = _batch(7)[0][:, :5]
    want = jtr.gpt_generate(jm, prompt, 8, **kw)
    got = ttr.gpt_generate(tm, prompt, 8, **kw)
    assert got.shape == (B, 13)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds the compiled sequence"):
        ttr.gpt_generate(tm, prompt, S)


def test_serve_engine_on_trained_weights_streams_as_gpt_generate(trained):
    """The weights ``gpt_decoder`` trained, served by the paged engine
    (the gather path on the CPU): greedy streams equal ``gpt_generate``'s."""
    _, tm, _ = trained
    dec = ttr.GPTDecoder(seq=S, device="cpu", **SHAPE)
    ttr.load_jax_params(dec, tm.get_weights())
    prompt = _batch(11)[0][:, :6]
    want = ttr.gpt_generate(tm, prompt, 8)[:, 6:]
    eng = ServeEngine(dec, device="cpu", slots=B, block_size=4, prefill_chunk=4, sync_every=3)
    reqs = [Request(prompt=prompt[b].copy(), max_new_tokens=8, id=b) for b in range(B)]
    rep = eng.run(reqs)
    assert rep.requests_finished == B
    for b, r in enumerate(reqs):
        assert [int(t) for t in r.tokens] == want[b].tolist()


def test_gpt_driver_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch", "--train", "--model", "gpt2", "--device",
         "cpu", "--layers", "2", "--hidden", "32", "--heads", "2", "--ff-dim", "64", "--seq",
         "32", "--batch", "2", "--vocab", "97", "--steps", "3", "--generate", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["model"] == "gpt2" and rec["steps"] == 3 and len(rec["losses"]) == 3
    assert all(math.isfinite(v) for v in rec["losses"])
    assert np.array(rec["generated"]).shape == (2, 4)
    assert rec["flash_launches"] == {"fwd": 0, "dq": 0, "dkv": 0} and rec["device"] == "cpu"
