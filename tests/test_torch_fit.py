"""The port's training loop against the JAX package's, on the CPU:
``FFModel.fit`` and ``eval`` with the token front end, the loaders,
``ffckpt/2`` checkpoints in both directions, and kill-and-resume.

The model is ``transformer_encoder`` on tokens (``token_ids`` through
``tok_embed``, plus the ``pos_embed`` input): 2 layers, hidden 32, 2
heads, ff 64, vocab 97, seq 16, batch 4, 4 classes, 24 samples (6
batches an epoch).  The JAX model compiles on a ``(1, 1)`` mesh; the
port takes its weights through ``set_weights(jax_model.get_weights())``.
The JAX ``fit`` is held to its Python loaders (``native_available``
patched to False): its native C++ loader shuffles with its own
generator, and the port's order is the Python ``SingleDataLoader``'s.
Its fault plan, run-health monitor and tracer are patched to none or
disabled ones for each test.

Tolerances: the embedding, forward and gradient, 1e-6 absolute; the
loaders' order exact; ``fit`` over 2 epochs (SGD) per-epoch metrics
within 1e-5 relative and final weights within 1e-5 absolute of the JAX
``fit``; ``eval`` within 1e-5 with exactly one host sync; checkpoints
equal bit for bit after a load in either package; a resume in the other
package within 1e-5 of the JAX package's uninterrupted run; a
kill-and-resume in the port bit-identical to the port's uninterrupted
run.
"""

from __future__ import annotations

import json
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

import flexflow_tpu.model as jmodel  # noqa: E402
import flexflow_tpu.obs.health as jhealth  # noqa: E402
import flexflow_tpu.obs.trace as jtrace  # noqa: E402
import flexflow_tpu.ops  # noqa: E402,F401  (registers the JAX ops)
import flexflow_tpu.ops.pallas.flash_attention as jfa  # noqa: E402
import flexflow_tpu.runtime.faults as jfaults  # noqa: E402
import flexflow_tpu.runtime.native as jnative  # noqa: E402
from flexflow_tpu import (  # noqa: E402
    AdamOptimizer, FFConfig, FFModel, LossType, MachineMesh, MetricsType, SGDOptimizer,
)
from flexflow_tpu import dataloader as jdl  # noqa: E402
from flexflow_tpu import fftype as jft  # noqa: E402
from flexflow_tpu import tensor as jtensor  # noqa: E402
from flexflow_tpu.models.transformer import transformer_encoder  # noqa: E402
from flexflow_tpu.ops.base import OpContext as JCtx  # noqa: E402
from flexflow_tpu.ops.base import get_op_def as jget  # noqa: E402
import flexflow_tpu_torch.model as tmodel  # noqa: E402
import flexflow_tpu_torch.runtime.faults as tfaults  # noqa: E402
from flexflow_tpu_torch import dataloader as tdl  # noqa: E402
from flexflow_tpu_torch import fftype as tft  # noqa: E402
from flexflow_tpu_torch import optimizer as topt  # noqa: E402
from flexflow_tpu_torch import tensor as ttensor  # noqa: E402
from flexflow_tpu_torch.config import FFConfig as TConfig  # noqa: E402
from flexflow_tpu_torch.model import CheckpointError, FFModel as TModel  # noqa: E402
from flexflow_tpu_torch.models.transformer import (  # noqa: E402
    transformer_encoder as t_encoder,
)
from flexflow_tpu_torch.ops.base import OpContext as TCtx  # noqa: E402
from flexflow_tpu_torch.ops.base import get_op_def as tget  # noqa: E402
from flexflow_tpu_torch.runtime.faults import FaultPlan, InjectedFault  # noqa: E402

B, S, HID, HEADS, FF, LAYERS, VOCAB, CLASSES, N = 4, 16, 32, 2, 64, 2, 97, 4, 24
ENC = dict(batch=B, seq=S, hidden=HID, heads=HEADS, ff_dim=FF, num_layers=LAYERS,
           vocab=VOCAB, num_classes=CLASSES)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setattr(jfaults, "_PLAN", None)
    monkeypatch.setattr(tfaults, "_PLAN", None)
    # a disabled run-health monitor and tracer: a JAX model built earlier in
    # the process with either on leaves it installed, and an enabled monitor
    # forces the JAX fit's K to 1
    monkeypatch.setattr(jhealth, "_MONITOR", jhealth.HealthMonitor())
    monkeypatch.setattr(jtrace, "_TRACER", jtrace.Tracer())
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(n, S)).astype(np.int32)
    pos = (rng.normal(size=(n, S, HID)) * 0.1).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(n, 1)).astype(np.int32)
    return [ids, pos], y


def _jopt(kind):
    return {"sgd": lambda: SGDOptimizer(lr=0.05), "momentum": lambda: SGDOptimizer(
        lr=0.05, momentum=0.9), "adam": lambda: AdamOptimizer(alpha=1e-3)}[kind]()


def _topt(kind):
    return {"sgd": lambda: topt.SGDOptimizer(lr=0.05), "momentum": lambda: topt.SGDOptimizer(
        lr=0.05, momentum=0.9), "adam": lambda: topt.AdamOptimizer(alpha=1e-3)}[kind]()


def _jax_model(opt="sgd"):
    jm = FFModel(FFConfig(batch_size=B))
    transformer_encoder(jm, **ENC)
    jm.compile(optimizer=_jopt(opt), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
               mesh=MachineMesh((1, 1), ("data", "model")), seed=0)
    return jm


def _port_model(opt="sgd", weights=None, dropout=0.0, **config):
    tm = TModel(TConfig(batch_size=B, device="cpu", **config))
    t_encoder(tm, dropout=dropout, **ENC)
    tm.compile(_topt(opt), metrics=[tft.MetricsType.ACCURACY,
                                    tft.MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    if weights is not None:
        tm.set_weights(weights)
    return tm


def _max_diff(a, b):
    assert sorted(a) == sorted(b)
    return max(float(np.abs(np.asarray(a[l][w], np.float64) - b[l][w]).max())
               for l in a for w in a[l])


def _record_perf(monkeypatch, module):
    """Every PerfMetrics the module's fit makes, in order."""
    made = []

    class Recorded(module.PerfMetrics):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(module, "PerfMetrics", Recorded)
    return made


# ------------------------------------------------------------------ embedding
@pytest.mark.parametrize("aggr", ["NONE", "SUM", "AVG"])
def test_embedding_forward_and_gradient_match_jax(aggr):
    """Out-of-range ids (negative and past the table) clamp to the
    boundary rows, and their gradient lands there, as in the JAX op."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-4, VOCAB + 4, size=(3, 7)).astype(np.int32)
    ids[0, :2] = [-1, VOCAB]
    table = rng.normal(size=(VOCAB, 8)).astype(np.float32)
    attrs = dict(num_entries=VOCAB, out_dim=8)
    jl = jtensor.Layer(jft.OperatorType.EMBEDDING, "emb",
                       [jtensor.Tensor((3, 7), jft.DataType.INT32)],
                       dict(attrs, aggr=getattr(jft.AggrMode, aggr)))
    tl = ttensor.Layer(tft.OperatorType.EMBEDDING, "emb",
                       [ttensor.Tensor((3, 7), tft.DataType.INT32)],
                       dict(attrs, aggr=getattr(tft.AggrMode, aggr)))
    jdef, tdef = jget(jl.op_type), tget(tl.op_type)
    assert [(w.name, tuple(w.shape)) for w in jdef.weights(jl)] == [
        (w.name, tuple(w.shape)) for w in tdef.weights(tl)]
    out_shape = tuple(tdef.infer(tl)[0][0])
    cot = rng.normal(size=out_shape).astype(np.float32)

    def jf(tab):
        out = jdef.forward(jl, {"kernel": tab}, [jnp.asarray(ids)], JCtx(training=True))[0]
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(table))
    tt = torch.from_numpy(table.copy()).requires_grad_()
    tout = tdef.forward(tl, {"kernel": tt}, [torch.from_numpy(ids)],
                        TCtx(True, torch.device("cpu")))[0]
    (tout * torch.from_numpy(cot)).sum().backward()
    assert tout.shape == out_shape == jout.shape
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=0)
    assert float(tt.grad[0].abs().sum()) > 0 and float(tt.grad[-1].abs().sum()) > 0


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_gather_forward_and_gradient_match_jax(dim):
    """``FFModel.gather`` builds the same layer in both packages, and the
    op's output and its gradient into ``data`` match the JAX op's
    (``take_along_axis``), repeated indices included."""
    rng = np.random.default_rng(4)
    data = rng.normal(size=(4, 5, 6)).astype(np.float32)
    ishape = {0: (3, 5, 6), 1: (4, 7, 6), -1: (4, 5, 9)}[dim]
    index = rng.integers(0, data.shape[dim], size=ishape).astype(np.int32)
    jm, tm = FFModel(FFConfig(batch_size=4)), TModel(TConfig(batch_size=4, device="cpu"))
    jout = jm.gather(jm.create_tensor(data.shape, jft.DataType.FLOAT),
                     jm.create_tensor(ishape, jft.DataType.INT32), dim=dim)
    tout = tm.gather(tm.create_tensor(data.shape, tft.DataType.FLOAT),
                     tm.create_tensor(ishape, tft.DataType.INT32), dim=dim)
    jl, tl = jm.layers[-1], tm.layers[-1]
    assert (tl.name, tl.op_type.name, tl.attrs) == (jl.name, jl.op_type.name, jl.attrs)
    assert tuple(tout.shape) == tuple(jout.shape) == ishape
    cot = rng.normal(size=ishape).astype(np.float32)

    def jf(d):
        out = jget(jl.op_type).forward(jl, {}, [d, jnp.asarray(index)], JCtx(training=True))[0]
        return jnp.sum(out * cot), out

    (_, jo), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(data))
    td = torch.from_numpy(data.copy()).requires_grad_()
    to = tget(tl.op_type).forward(tl, {}, [td, torch.from_numpy(index)],
                                  TCtx(True, torch.device("cpu")))[0]
    (to * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=0)


# ------------------------------------------------------------------ loaders
@pytest.mark.parametrize("shuffle,depth,seed", [(True, 0, 0), (True, 2, 5), (False, 2, 0)])
def test_loader_order_matches_jax_over_three_epochs(shuffle, depth, seed):
    x = np.arange(22 * 3).reshape(22, 3)
    y = np.arange(22)
    jit = jdl.BatchIterator([jdl.SingleDataLoader(a, 4, None, None, shuffle=shuffle, seed=seed)
                             for a in (x, y)], prefetch_depth=depth)
    tit = tdl.BatchIterator([tdl.SingleDataLoader(a, 4, shuffle=shuffle, seed=seed)
                             for a in (x, y)], prefetch_depth=depth)
    assert tit.num_batches == jit.num_batches == 5
    orders = []
    for _ in range(3):
        jit.reset()
        tit.reset()
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb) == 5
        for (jx, jy), (tx, ty) in zip(jb, tb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(tx[:, 0] // 3, ty)  # rows stay aligned
        orders.append(np.concatenate([b[1] for b in tb]))
    assert shuffle == (not np.array_equal(orders[0], orders[1]))


def test_prefetcher_places_ahead_and_keeps_order():
    placed = []
    pf = tdl.DevicePrefetcher(iter(range(7)), lambda b: placed.append(b) or b * 10, depth=3)
    seen = []
    for v in pf:
        seen.append(v)
        assert len(placed) >= min(7, len(seen) + 2)  # up to 3 staged ahead
    assert seen == [v * 10 for v in range(7)]


# ------------------------------------------------------------------ fit / eval
@pytest.mark.parametrize("k", [1, 4])
def test_fit_matches_jax_per_epoch_and_in_weights(k, monkeypatch):
    xs, y = _data()
    jm = _jax_model()
    tm = _port_model(weights=jm.get_weights())
    jmade, tmade = _record_perf(monkeypatch, jmodel), _record_perf(monkeypatch, tmodel)
    jpm = jm.fit(xs, y, epochs=2, shuffle=True, seed=3, verbose=False, metrics_sync_every=k)
    tpm = tm.fit(xs, y, epochs=2, shuffle=True, seed=3, verbose=False, metrics_sync_every=k)
    assert isinstance(tpm, tmodel.PerfMetrics)
    jep, tep = jmade[-2:], tmade[-2:]
    assert tep[-1] is tpm and jep[-1] is jpm
    for je, te in zip(jep, tep):
        assert te.train_all == je.train_all == N
        assert te.train_correct == je.train_correct
        assert te.sparse_cce_loss == pytest.approx(je.sparse_cce_loss, rel=1e-5)
    # K = 1: one sync a step; K = 4 over 6 batches: flushes after batches 4 and 6
    assert tm.executor.host_syncs == jm.executor.host_syncs == (12 if k == 1 else 4)
    assert tm.executor._step_count == jm.executor._step_count == 12
    assert _max_diff(tm.get_weights(), jm.get_weights()) <= 1e-5


def test_fit_default_k_syncs_once_an_epoch():
    xs, y = _data()
    tm = _port_model()
    tm.fit(xs, y, epochs=2, verbose=False)
    assert tm.executor.host_syncs == 2


def test_profiling_flushes_every_step_as_jax_does(monkeypatch):
    """``profiling`` forces K = 1 over an explicit K, in both packages."""
    xs, y = _data()
    jm = FFModel(FFConfig(batch_size=B, profiling=True))
    transformer_encoder(jm, **ENC)
    jm.compile(optimizer=_jopt("sgd"), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
               mesh=MachineMesh((1, 1), ("data", "model")), seed=0)
    tm = _port_model(weights=jm.get_weights(), profiling=True)
    jpm = jm.fit(xs, y, epochs=1, verbose=False, metrics_sync_every=4)
    tpm = tm.fit(xs, y, epochs=1, verbose=False, metrics_sync_every=4)
    assert tm.executor.host_syncs == jm.executor.host_syncs == N // B
    assert tm.executor.host_stall_s > 0
    assert tpm.train_correct == jpm.train_correct
    assert tpm.sparse_cce_loss == pytest.approx(jpm.sparse_cce_loss, rel=1e-5)


def test_eval_pads_the_tail_and_matches_jax():
    xs, y = _data(n=10, seed=4)
    jm = _jax_model()
    tm = _port_model(weights=jm.get_weights())
    s0 = tm.executor.host_syncs
    tpm = tm.eval(xs, y)
    jpm = jm.eval(xs, y)
    assert tm.executor.host_syncs - s0 == 1
    assert tpm.train_all == jpm.train_all == 10
    assert tpm.train_correct == jpm.train_correct
    assert tpm.sparse_cce_loss == pytest.approx(jpm.sparse_cce_loss, rel=1e-5)
    # the padded rows do not count: the tail's two rows alone
    probs = tm.eval_batch([np.concatenate([a[8:], a[9:10], a[9:10]]) for a in xs]).numpy()
    tail = _port_model(weights=jm.get_weights()).eval([a[8:] for a in xs], y[8:])
    want = -np.log(np.maximum(probs[np.arange(2), y[8:, 0]], 1e-12)).sum()
    assert tail.train_all == 2
    assert tail.sparse_cce_loss == pytest.approx(want, rel=1e-5)


def test_token_front_end_train_step_matches_jax():
    xs, y = _data()
    jm = _jax_model("adam")
    tm = _port_model("adam", weights=jm.get_weights())
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    for i in range(3):
        bx = [a[i * B:(i + 1) * B] for a in xs]
        jl, _ = jm.executor.train_step(bx, y[i * B:(i + 1) * B])
        tl, _ = tm.executor.train_step(bx, y[i * B:(i + 1) * B])
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert _max_diff(tm.get_weights(), jm.get_weights()) <= 1e-4


@pytest.mark.parametrize("arg", ["recompile_state", "recovery", "health"])
def test_fit_refuses_what_is_not_ported(arg):
    xs, y = _data()
    tm = _port_model(**({"health": "restore"} if arg == "health" else {}))
    kw = {} if arg == "health" else {arg: object()}
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item"):
        tm.fit(xs, y, epochs=1, verbose=False, **kw)
    assert tm.executor._step_count == 0


# ------------------------------------------------------------------ checkpoints
def _opt_tree(model, jax_side):
    if jax_side:
        st = model.executor.opt_state
        return {k: jax.tree.map(np.asarray, v) if isinstance(v, dict) else int(v)
                for k, v in st.items()}
    named = model.executor.opt_state_by_name()
    return {k: {l: {w: t.numpy() for w, t in ws.items()} for l, ws in v.items()}
            if isinstance(v, dict) else v for k, v in named.items()}


def _assert_same_state(tm, jm):
    tw, jw = tm.get_weights(), jm.get_weights()
    assert _max_diff(tw, jw) == 0.0
    to, jo = _opt_tree(tm, False), _opt_tree(jm, True)
    assert sorted(to) == sorted(jo) and to["step"] == jo["step"]
    for slot in to:
        if slot != "step":
            assert _max_diff(to[slot], jo[slot]) == 0.0
    assert tm.executor._step_count == jm.executor._step_count


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_in_the_other_package(writer, tmp_path, monkeypatch):
    """A checkpoint written mid-fit (with its cursor) by one package loads
    in the other: weights, Adam moments, step and cursor equal, digest
    verified."""
    xs, y = _data()
    ck = str(tmp_path / "ck.npz")
    jm = _jax_model("adam")
    tm = _port_model("adam", weights=jm.get_weights())
    src = tm if writer == "port" else jm
    src.fit(xs, y, epochs=1, shuffle=True, verbose=False, checkpoint_every=4, checkpoint_path=ck)
    with np.load(ck) as z:
        manifest = json.loads(bytes(z["meta/manifest"]).decode())
        assert z["opt_scalar/step"].dtype == np.int32
    assert manifest["schema"] == "ffckpt/2" and manifest["step"] == 4
    assert manifest["loader"] == {"epoch": 0, "batch": 4, "shuffle": True, "seed": 0,
                                  "batches": 6}
    dst = jm if writer == "port" else tm
    got = dst.load_checkpoint(ck)
    assert got["digest"] == manifest["digest"] and got["loader"] == manifest["loader"]
    # the writer has gone two steps past its checkpoint: load it back too
    src.load_checkpoint(ck)
    _assert_same_state(tm, jm)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume_continues_on_the_jax_trajectory(writer, tmp_path, monkeypatch):
    """A run killed by ``device_loss@8`` in one package resumes in the
    other from its step-6 checkpoint and ends within 1e-5 of the JAX
    package's uninterrupted run (SGD with momentum: its moments cross
    too)."""
    xs, y = _data()
    ck = str(tmp_path / "ck.npz")
    ref = _jax_model("momentum")
    w0 = ref.get_weights()
    ref.fit(xs, y, epochs=2, shuffle=True, verbose=False)
    if writer == "jax":
        killed = _jax_model("momentum")
        monkeypatch.setattr(jfaults, "_PLAN", jfaults.FaultPlan.parse("fit:device_loss@8"))
        with pytest.raises(jfaults.InjectedFault):
            killed.fit(xs, y, epochs=2, shuffle=True, verbose=False, checkpoint_every=3,
                       checkpoint_path=ck)
        monkeypatch.setattr(jfaults, "_PLAN", None)
        resumed = _port_model("momentum")
    else:
        killed = _port_model("momentum", weights=w0)
        monkeypatch.setattr(tfaults, "_PLAN", FaultPlan.parse("fit:device_loss@8"))
        with pytest.raises(InjectedFault):
            killed.fit(xs, y, epochs=2, shuffle=True, verbose=False, checkpoint_every=3,
                       checkpoint_path=ck)
        monkeypatch.setattr(tfaults, "_PLAN", None)
        resumed = _jax_model("momentum")
    assert killed.executor._step_count == 8
    resumed.fit(xs, y, epochs=2, shuffle=True, verbose=False, resume=ck)
    assert resumed.executor._step_count == 12
    assert _max_diff(resumed.get_weights(), ref.get_weights()) <= 1e-5


def _flat(model):
    named = model.executor.opt_state_by_name()
    out = {f"params/{l}/{w}": a for l, ws in model.get_weights().items() for w, a in ws.items()}
    for slot, tree in named.items():
        if slot != "step":
            out.update({f"opt/{slot}/{l}/{w}": t.numpy().copy() for l, ws in tree.items()
                        for w, t in ws.items()})
    return out, named["step"], model.executor._step_count


@pytest.mark.parametrize("kill,every", [(9, 2), (7, 6), (6, 6)],
                         ids=["mid_epoch", "epoch_edge", "at_the_checkpoint"])
def test_kill_and_resume_is_bit_identical(kill, every, tmp_path, monkeypatch):
    """Adam, dropout 0.1 (keyed on the step count), shuffle: a run killed
    at step ``kill`` and resumed from its last checkpoint (step 8 mid
    epoch 2; step 6, the end of epoch 1, for the other two) ends bit for
    bit where the uninterrupted run ends."""
    xs, y = _data()
    ck = str(tmp_path / "ck.npz")
    ref = _port_model("adam", dropout=0.1)
    w0 = ref.get_weights()
    ref.fit(xs, y, epochs=2, shuffle=True, seed=2, verbose=False)
    monkeypatch.setattr(tfaults, "_PLAN", FaultPlan.parse(f"device_loss@{kill}"))
    killed = _port_model("adam", weights=w0, dropout=0.1)
    with pytest.raises(InjectedFault, match=f"fit step {kill}"):
        killed.fit(xs, y, epochs=2, shuffle=True, seed=2, verbose=False,
                   checkpoint_every=every, checkpoint_path=ck)
    assert killed.executor._step_count == kill
    monkeypatch.setattr(tfaults, "_PLAN", None)
    resumed = _port_model("adam", dropout=0.1)
    cursor = resumed.load_checkpoint(ck)["loader"]
    assert cursor["batch"] == (2 if kill == 9 else 6) and cursor["epoch"] == (1 if kill == 9 else 0)
    resumed = _port_model("adam", dropout=0.1, resume_from=ck)
    resumed.fit(xs, y, epochs=2, shuffle=True, seed=2, verbose=False)
    (rf, rstep, rcount), (gf, gstep, gcount) = _flat(ref), _flat(resumed)
    assert rstep == gstep == rcount == gcount == 12
    assert sorted(rf) == sorted(gf)
    for key in rf:
        np.testing.assert_array_equal(gf[key], rf[key], err_msg=key)


@pytest.mark.parametrize("change", ["shuffle", "seed", "batches"])
def test_resume_refuses_a_changed_data_order(change, tmp_path, monkeypatch):
    xs, y = _data()
    ck = str(tmp_path / "ck.npz")
    monkeypatch.setattr(tfaults, "_PLAN", FaultPlan.parse("device_loss@5"))
    with pytest.raises(InjectedFault):
        _port_model().fit(xs, y, epochs=2, shuffle=True, verbose=False, checkpoint_every=2,
                          checkpoint_path=ck)
    monkeypatch.setattr(tfaults, "_PLAN", None)
    kw = dict(epochs=2, shuffle=True, seed=0, verbose=False, resume=ck)
    if change == "shuffle":
        kw["shuffle"] = False
    elif change == "seed":
        kw["seed"] = 1
    else:
        xs, y = [a[:B * 3] for a in xs], y[:B * 3]
    fresh = _port_model()
    with pytest.raises(CheckpointError, match="data order would diverge" if change != "batches"
                       else "batches/epoch"):
        fresh.fit(xs, y, **kw)


@pytest.mark.parametrize("damage", ["torn", "digest", "manifest"])
def test_damaged_checkpoint_is_refused_before_any_write(damage, tmp_path):
    xs, y = _data()
    m = _port_model("adam")
    m.executor.train_step([a[:B] for a in xs], y[:B])
    path = m.save_checkpoint(str(tmp_path / "ck"))
    assert path.endswith(".npz") and not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    if damage == "torn":
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
        match = "torn or truncated"
    else:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        if damage == "digest":
            key = next(k for k in flat if k.startswith("params/"))
            flat[key] = flat[key] + 1.0
            match = "sha256:"
        else:
            flat["meta/manifest"] = np.frombuffer(b"{not json", np.uint8)
            match = "unreadable manifest"
        with open(path, "wb") as f:
            np.savez(f, **flat)
    fresh = _port_model("adam")
    before = _flat(fresh)
    with pytest.raises(CheckpointError, match=match):
        fresh.load_checkpoint(path)
    after = _flat(fresh)
    assert after[1:] == before[1:]
    for key in before[0]:
        np.testing.assert_array_equal(after[0][key], before[0][key])


def test_checkpoint_of_another_shape_is_refused_before_any_write(tmp_path):
    m = _port_model("adam")
    path = m.save_checkpoint(str(tmp_path / "ck.npz"))
    other = TModel(TConfig(batch_size=B, device="cpu"))
    t_encoder(other, **dict(ENC, ff_dim=FF * 2))
    other.compile(topt.AdamOptimizer())
    before = other.get_weights()
    with pytest.raises(ValueError, match="shape"):
        other.load_checkpoint(path)
    assert _max_diff(other.get_weights(), before) == 0.0


def test_checkpoint_writer_surfaces_a_failed_write(tmp_path):
    xs, y = _data()
    m = _port_model()
    bad = str(tmp_path / "missing_dir" / "ck.npz")
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        m.fit(xs, y, epochs=1, verbose=False, checkpoint_every=1, checkpoint_path=bad)


# ------------------------------------------------------------------ the driver
def _driver(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "flexflow_tpu_torch", "--train", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


SMALL = ("--device", "cpu", "--layers", "2", "--hidden", "32", "--heads", "2", "--ff-dim",
         "64", "--seq", "16", "--batch", "4", "--classes", "4", "--vocab", "97",
         "--samples", "24", "--eval-samples", "10", "--shuffle")


def test_fit_driver_kills_and_resumes_on_the_cpu(tmp_path):
    ck = str(tmp_path / "ck.npz")
    full = _driver("--fit", *SMALL)
    killed = _driver("--fit", *SMALL, "--checkpoint-every", "4", "--checkpoint-path", ck,
                     "--fault-plan", "device_loss@10")
    resumed = _driver("--fit", *SMALL, "--resume", ck)
    assert full.returncode == 0 and resumed.returncode == 0, full.stderr + resumed.stderr
    assert killed.returncode == 1
    recs = [json.loads(o.stdout.strip().splitlines()[-1]) for o in (full, killed, resumed)]
    assert recs[0]["steps"] == 12 and recs[0]["host_syncs"] == 2 and recs[0]["fault"] is None
    assert recs[0]["eval_samples"] == 10 and recs[0]["eval_host_syncs"] == 1
    assert "device_loss" in recs[1]["fault"] and recs[1]["step_count"] == 10
    assert recs[2]["steps"] == 4 and recs[2]["step_count"] == 12
    assert recs[2]["eval_loss"] == recs[0]["eval_loss"]
    assert recs[2]["eval_accuracy"] == recs[0]["eval_accuracy"]
    assert recs[0]["flash_launches"] == {"fwd": 0, "dq": 0, "dkv": 0}


def test_fit_driver_profiles_and_refuses_a_health_mode(capsys):
    """``--profiling`` gives one counted sync a step, and the line carries
    the host's wait in them; ``--health restore`` is refused, not
    ignored."""
    from flexflow_tpu_torch.runtime import driver

    assert driver.main(["--fit", *SMALL, "--eval-samples", "0", "--epochs", "1",
                        "--profiling"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["steps"] == rec["host_syncs"] == 6
    assert rec["host_stall_s"] > 0
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 6"):
        driver.main(["--fit", *SMALL, "--epochs", "1", "--health", "restore"])
