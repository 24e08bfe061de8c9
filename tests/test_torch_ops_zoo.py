"""The single-device op set, executor state, the losses and metrics, and
the flash kernels' row chunking, against the JAX package on the CPU.

Each op runs alone in both packages on the same seeded numpy inputs and
weights (layers built with the same attributes, their declared weights
compared by name and shape): forward outputs and the gradients of
``sum(out * cotangent)`` in every float input and weight within 1e-6,
absolute up to a magnitude of 1 and relative to the tensor's largest
value above it (``pow``'s gradient reaches 20, where float32's spacing
is 2e-6), as ``test_gather_forward_and_gradient_match_jax`` holds the
gather op.  BatchNorm's running stats and ``Cache``'s state are compared
after 2 training steps of a small model in both packages, and ride
``get_weights`` / ``set_weights`` and ``ffckpt/2`` checkpoints both ways.
MoE dispatch (capacity positions, the capacity cut, the dense dispatch
mask, slots) is compared exactly and the load-balance loss within 1e-6.
The flash kernels' B * H chunking is checked with ``GRID_Y_MAX``
patched small: the launches a call makes, and the attention op taking
the flash path past the limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import flexflow_tpu.obs.health as jhealth  # noqa: E402
import flexflow_tpu.obs.trace as jtrace  # noqa: E402
import flexflow_tpu.ops  # noqa: E402,F401  (registers the JAX ops)
import flexflow_tpu.ops.moe as jmoe  # noqa: E402
import flexflow_tpu.runtime.faults as jfaults  # noqa: E402
from flexflow_tpu import (  # noqa: E402
    FFConfig, FFModel, LossType, MachineMesh, MetricsType, SGDOptimizer,
)
from flexflow_tpu import fftype as jft  # noqa: E402
from flexflow_tpu import loss as jloss  # noqa: E402
from flexflow_tpu import metrics as jmetrics  # noqa: E402
from flexflow_tpu import tensor as jtensor  # noqa: E402
from flexflow_tpu.ops.base import OpContext as JCtx  # noqa: E402
from flexflow_tpu.ops.base import get_op_def as jget  # noqa: E402
import flexflow_tpu_torch.ops.attention as tattn  # noqa: E402
import flexflow_tpu_torch.ops.cuda.flash_attention as tfa  # noqa: E402
import flexflow_tpu_torch.ops.moe as tmoe  # noqa: E402
import flexflow_tpu_torch.runtime.faults as tfaults  # noqa: E402
from flexflow_tpu_torch import fftype as tft  # noqa: E402
from flexflow_tpu_torch import initializer as tinit  # noqa: E402
from flexflow_tpu_torch import loss as tloss  # noqa: E402
from flexflow_tpu_torch import metrics as tmetrics  # noqa: E402
from flexflow_tpu_torch import optimizer as topt  # noqa: E402
from flexflow_tpu_torch import tensor as ttensor  # noqa: E402
from flexflow_tpu_torch.config import FFConfig as TConfig  # noqa: E402
from flexflow_tpu_torch.model import FFModel as TModel  # noqa: E402
from flexflow_tpu_torch.ops.base import OpContext as TCtx  # noqa: E402
from flexflow_tpu_torch.ops.base import get_op_def as tget  # noqa: E402

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(jfaults, "_PLAN", None)
    monkeypatch.setattr(tfaults, "_PLAN", None)
    monkeypatch.setattr(jhealth, "_MONITOR", jhealth.HealthMonitor())
    monkeypatch.setattr(jtrace, "_TRACER", jtrace.Tracer())
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _is_float(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _dt(ft, a):
    return {np.dtype(np.float32): ft.DataType.FLOAT,
            np.dtype(np.int32): ft.DataType.INT32}[np.asarray(a).dtype]


def _layers(op, inputs, attrs):
    """The op's layer in both packages; ``attrs(ft)`` gives the attributes
    with each package's enums."""
    jl = jtensor.Layer(getattr(jft.OperatorType, op), "l",
                       [jtensor.Tensor(a.shape, _dt(jft, a)) for a in inputs], attrs(jft))
    tl = ttensor.Layer(getattr(tft.OperatorType, op), "l",
                       [ttensor.Tensor(a.shape, _dt(tft, a)) for a in inputs], attrs(tft))
    return jl, tl


def _weights(jl, tl, rng):
    """Seeded weights for the op, after checking that both packages
    declare the same names, shapes and trainability."""
    jw, tw = jget(jl.op_type).weights(jl), tget(tl.op_type).weights(tl)
    assert [(w.name, tuple(w.shape), w.trainable) for w in jw] == [
        (w.name, tuple(w.shape), w.trainable) for w in tw]
    out = {}
    for w in tw:
        a = rng.normal(size=w.shape).astype(np.float32)
        if w.name == "running_var":
            a = np.abs(a) + 0.5
        out[w.name] = a
    return out


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=ATOL * scale, rtol=0)


def check_op(op, inputs, attrs=lambda ft: {}, training=True, seed=0):
    """Forward and gradient of one op in both packages (see the module
    docstring); returns the port's outputs."""
    rng = np.random.default_rng(seed)
    jl, tl = _layers(op, inputs, attrs)
    params = _weights(jl, tl, rng)
    jdef, tdef = jget(jl.op_type), tget(tl.op_type)
    shapes = [(tuple(s), d) for s, d in tdef.infer(tl)]
    assert [(s, d.value) for s, d in shapes] == [(tuple(s), d.value) for s, d in jdef.infer(jl)]
    cots = [rng.normal(size=s).astype(np.float32) if d.value.startswith("float") else None
            for s, d in shapes]
    fi = [i for i, a in enumerate(inputs) if _is_float(a)]
    pnames = sorted(params)

    def jf(fl_in, ps):
        ins = [jnp.asarray(a) for a in inputs]
        for i, v in zip(fi, fl_in):
            ins[i] = v
        outs = jdef.forward(jl, dict(zip(pnames, ps)), ins, JCtx(training=training))
        tot = sum((jnp.sum(o * c) for o, c in zip(outs, cots) if c is not None), jnp.float32(0))
        return tot, outs

    (_, jouts), (jgi, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(inputs[i]) for i in fi], [jnp.asarray(params[n]) for n in pnames])
    tins = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in fi:
        tins[i].requires_grad_()
    tps = {n: torch.from_numpy(params[n].copy()).requires_grad_() for n in pnames}
    touts = tdef.forward(tl, tps, tins, TCtx(training, torch.device("cpu")))
    tot = sum(((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots) if c is not None),
              torch.zeros(()))
    if tot.requires_grad:
        tot.backward()
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        _close(t.detach().float().numpy(), j)
    # an input or weight the output does not depend on has no gradient
    # in PyTorch and a zero one in JAX
    for t, g in [(tins[i], g) for i, g in zip(fi, jgi)] + [(tps[n], g) for n, g in zip(
            pnames, jgp)]:
        _close(np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy(), g)
    return touts


def _normal(*shape, seed=1, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


# ---------------------------------------------------------------- elementwise
UNARY = {"RELU": {}, "SIGMOID": {}, "TANH": {}, "ELU": {}, "GELU": {}, "EXP": {}, "SIN": {},
         "COS": {}, "RSQRT": {}, "IDENTITY": {}, "POW": {"exponent": 3.0},
         "SCALAR_MULTIPLY": {"scalar": 1.5}, "SCALAR_ADD": {"scalar": -0.25},
         "SCALAR_SUB": {"scalar": 2.0}, "SCALAR_TRUE_DIV": {"scalar": 4.0}}


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_op_matches_jax(op):
    x = _normal(3, 5, 7)
    if op == "RSQRT":
        x = np.abs(x) + 0.5
    check_op(op, [x], lambda ft: dict(UNARY[op]))


@pytest.mark.parametrize("op", ["EW_ADD", "EW_SUB", "EW_MUL", "EW_DIV", "EW_MAX", "EW_MIN"])
def test_binary_op_matches_jax_with_broadcast(op):
    a, b = _normal(2, 3, 4), _normal(3, 4, seed=2)
    if op == "EW_DIV":
        b = np.sign(b) * (np.abs(b) + 0.5)
    check_op(op, [a, b])


@pytest.mark.parametrize("to", ["BFLOAT16", "INT32"])
def test_cast_matches_jax(to):
    check_op("CAST", [_normal(4, 6, scale=3.0)], lambda ft: dict(dtype=getattr(ft.DataType, to)))


# ---------------------------------------------------------------- tensor ops
def test_concat_matches_jax():
    check_op("CONCAT", [_normal(2, 3, 4), _normal(2, 5, 4, seed=2)], lambda ft: dict(axis=1))


@pytest.mark.parametrize("axis", [0, 2])
def test_split_matches_jax(axis):
    x = _normal(4, 3, 6)
    sizes = (1, 3) if axis == 0 else (2, 1, 3)
    check_op("SPLIT", [x], lambda ft: dict(sizes=sizes, axis=axis))


def test_transpose_matches_jax():
    check_op("TRANSPOSE", [_normal(2, 3, 4, 5)], lambda ft: dict(perm=(0, 2, 3, 1)))


def test_reverse_matches_jax():
    check_op("REVERSE", [_normal(3, 4, 5)], lambda ft: dict(axis=1))


@pytest.mark.parametrize("keepdims", [False, True])
def test_reduce_sum_matches_jax(keepdims):
    check_op("REDUCE_SUM", [_normal(3, 4, 5)], lambda ft: dict(axes=(0, 2), keepdims=keepdims))


def test_top_k_breaks_ties_as_lax_top_k():
    """Values with repeats: equal values come out in index order, the
    lower index first, as ``lax.top_k`` gives them."""
    x = np.random.default_rng(4).integers(0, 4, size=(6, 9)).astype(np.float32)
    vals, idx = check_op("TOPK", [x], lambda ft: dict(k=4, sorted=True))
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx.dtype == torch.int32


def test_noop_and_flat_match_jax():
    check_op("NOOP", [_normal(2, 3)])
    check_op("FLAT", [_normal(2, 3, 4, 5)])


def test_batch_matmul_matches_jax():
    check_op("BATCHMATMUL", [_normal(2, 3, 4, 5), _normal(2, 3, 5, 6, seed=2)])


def test_rms_norm_matches_jax():
    check_op("RMS_NORM", [_normal(2, 5, 8)], lambda ft: dict(eps=1e-6))


# ---------------------------------------------------------------- conv ops
@pytest.mark.parametrize("case", ["plain", "strided_relu", "grouped", "no_bias"])
def test_conv2d_matches_jax(case):
    """HWIO kernels of the JAX layout, permuted at use."""
    kw = {"plain": dict(out_channels=6, kernel_h=3, kernel_w=3, stride_h=1, stride_w=1,
                        padding_h=1, padding_w=1),
          "strided_relu": dict(out_channels=5, kernel_h=3, kernel_w=5, stride_h=2, stride_w=3,
                               padding_h=1, padding_w=2),
          "grouped": dict(out_channels=8, kernel_h=3, kernel_w=3, stride_h=1, stride_w=1,
                          padding_h=0, padding_w=1, groups=4),
          "no_bias": dict(out_channels=4, kernel_h=1, kernel_w=1, stride_h=1, stride_w=1,
                          padding_h=0, padding_w=0, use_bias=False)}[case]

    def attrs(ft):
        act = ft.ActiMode.RELU if case == "strided_relu" else ft.ActiMode.NONE
        return dict(kw, activation=act)

    check_op("CONV2D", [_normal(2, 4, 9, 11)], attrs)


@pytest.mark.parametrize("pool", ["MAX", "AVG"])
@pytest.mark.parametrize("pad", [0, 1])
def test_pool2d_matches_jax(pool, pad):
    """Max pads with -inf; average divides by kh * kw whatever the padding."""
    def attrs(ft):
        return dict(kernel_h=3, kernel_w=3, stride_h=2, stride_w=2, padding_h=pad,
                    padding_w=pad, pool_type=getattr(ft.PoolType, pool),
                    activation=ft.ActiMode.NONE)

    check_op("POOL2D", [_normal(2, 3, 9, 8)], attrs)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_matches_jax(training, relu):
    """Training normalises with the batch's biased variance, eval with the
    running stats; the state update uses the same biased variance."""
    x = _normal(4, 3, 5, 6, scale=2.0, shift=0.5)
    check_op("BATCHNORM", [x], lambda ft: dict(relu=relu), training=training)
    jl, tl = _layers("BATCHNORM", [x], lambda ft: dict(relu=relu))
    params = _weights(jl, tl, np.random.default_rng(0))
    js = jget(jl.op_type).state_update(jl, {k: jnp.asarray(v) for k, v in params.items()},
                                       [jnp.asarray(x)])
    ts = tget(tl.op_type).state_update(tl, {k: torch.from_numpy(v) for k, v in params.items()},
                                       [torch.from_numpy(x)])
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=ATOL, rtol=0)


# ---------------------------------------------------------------- MoE ops
def _assign(t=12, n=4, k=2, seed=5):
    """Distinct top-k experts per token, skewed toward expert 0."""
    rng = np.random.default_rng(seed)
    rows = [rng.choice(n, size=k, replace=False, p=[0.55, 0.15, 0.15, 0.15]) for _ in range(t)]
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 2.0])
def test_moe_dispatch_and_capacity_cut_match_jax(alpha):
    assign = _assign()
    t, k = assign.shape
    cap = tmoe.expert_capacity(t, 4, k, alpha)
    assert cap == jmoe.expert_capacity(t, 4, k, alpha)
    jd, jp, jw = jmoe.make_dispatch(jnp.asarray(assign), 4, cap)
    td, tp, tw = tmoe.make_dispatch(torch.from_numpy(assign), 4, cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    js, jwi = jmoe.dispatch_indices(jnp.asarray(assign), 4, cap)
    ts, twi = tmoe.dispatch_indices(torch.from_numpy(assign), 4, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the cut: every expert keeps at most cap slots, and the dropped slots
    # are the latest (token-major) ones of their expert
    for e in range(4):
        kept = tw.numpy()[assign == e]
        assert kept.sum() == min(cap, (assign == e).sum())
        assert np.all(np.diff(kept.astype(int)) <= 0)
    if alpha == 0.5:
        assert not tw.all()  # something is dropped at this capacity


def test_moe_aux_loss_matches_jax():
    rng = np.random.default_rng(6)
    probs = rng.dirichlet(np.ones(4), size=12).astype(np.float32)
    assign = _assign()
    j = jmoe.Aggregate.aux_loss(jnp.asarray(probs), jnp.asarray(assign), 4)
    t = tmoe.Aggregate.aux_loss(torch.from_numpy(probs), torch.from_numpy(assign), 4)
    np.testing.assert_allclose(float(t), float(j), atol=ATOL, rtol=0)


def test_group_by_matches_jax():
    outs = check_op("GROUP_BY", [_normal(12, 6), _assign()],
                    lambda ft: dict(n_experts=4, alpha=1.0))
    assert len(outs) == 4


@pytest.mark.parametrize("op", ["AGGREGATE", "AGGREGATE_SPEC"])
def test_aggregate_matches_jax(op):
    assign = _assign()
    cap = tmoe.expert_capacity(12, 4, 2, 1.0)
    rng = np.random.default_rng(8)
    gates = rng.dirichlet(np.ones(2), size=12).astype(np.float32)
    full = rng.dirichlet(np.ones(4), size=12).astype(np.float32)
    experts = [_normal(cap, 6, seed=10 + e) for e in range(4)]
    check_op(op, [gates, assign, assign, full] + experts, lambda ft: dict(n=4, lambda_bal=0.04))


def test_experts_matches_jax():
    rng = np.random.default_rng(9)
    gates = rng.dirichlet(np.ones(2), size=12).astype(np.float32)
    full = rng.dirichlet(np.ones(4), size=12).astype(np.float32)
    check_op("EXPERTS", [_normal(12, 6), _assign(), gates, full],
             lambda ft: dict(n_experts=4, hidden=5, alpha=1.0, lambda_bal=0.04))


# ---------------------------------------------------------------- losses, metrics
LOSSES = ["CATEGORICAL_CROSSENTROPY", "SPARSE_CATEGORICAL_CROSSENTROPY",
          "MEAN_SQUARED_ERROR_AVG_REDUCE", "MEAN_SQUARED_ERROR_SUM_REDUCE", "IDENTITY"]


def _labels(kind, rng, probs):
    if kind == "SPARSE_CATEGORICAL_CROSSENTROPY":
        return rng.integers(0, probs.shape[1], size=(probs.shape[0], 1)).astype(np.int32)
    if kind == "CATEGORICAL_CROSSENTROPY":
        return np.eye(probs.shape[1], dtype=np.float32)[rng.integers(0, probs.shape[1],
                                                                     probs.shape[0])]
    return rng.normal(size=probs.shape).astype(np.float32)


@pytest.mark.parametrize("kind", LOSSES)
def test_loss_and_its_gradient_match_jax(kind):
    rng = np.random.default_rng(11)
    probs = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    y = _labels(kind, rng, probs)
    jfn = jloss.get_loss_fn(getattr(jft.LossType, kind))
    tfn = tloss.get_loss_fn(getattr(tft.LossType, kind))
    jv, jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(y)))(jnp.asarray(probs))
    tp = torch.from_numpy(probs.copy()).requires_grad_()
    tv = tfn(tp, torch.from_numpy(y))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", LOSSES[:4])
def test_metrics_match_jax(kind):
    rng = np.random.default_rng(12)
    probs = rng.dirichlet(np.ones(5), size=8).astype(np.float32)
    y = _labels(kind, rng, probs)
    names = ["ACCURACY", "CATEGORICAL_CROSSENTROPY", "MEAN_SQUARED_ERROR",
             "ROOT_MEAN_SQUARED_ERROR", "MEAN_ABSOLUTE_ERROR"]
    if kind == "SPARSE_CATEGORICAL_CROSSENTROPY":
        names = ["ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY"]
    jm = jmetrics.Metrics(getattr(jft.LossType, kind), [getattr(jft.MetricsType, n)
                                                        for n in names])
    tm = tmetrics.Metrics(getattr(tft.LossType, kind), [getattr(tft.MetricsType, n)
                                                        for n in names])
    jv = jm.compute(jnp.asarray(probs), jnp.asarray(y))
    tv = tm.compute(torch.from_numpy(probs), torch.from_numpy(y))
    assert sorted(tv) == sorted(jv)
    for key in jv:
        np.testing.assert_allclose(float(tv[key]), float(jv[key]), atol=ATOL, rtol=1e-6)


def test_float_and_one_hot_labels_keep_their_dtype_through_place_batch():
    tm = TModel(TConfig(batch_size=2, device="cpu"))
    tm.softmax(tm.dense(tm.create_tensor((2, 3)), 4))
    tm.compile(topt.SGDOptimizer(lr=0.1), loss_type=tft.LossType.CATEGORICAL_CROSSENTROPY)
    x = np.ones((2, 3), np.float32)
    for y in (np.eye(4, dtype=np.float32)[:2], np.eye(4, dtype=np.float64)[:2]):
        _, placed = tm.executor.place_batch([x, y])
        assert placed.dtype == torch.from_numpy(y).dtype
        np.testing.assert_array_equal(placed.numpy(), y)


def test_constant_and_uniform_initializers():
    gen = torch.Generator().manual_seed(0)
    c = tinit.ConstantInitializer(0.25)(gen, (3, 4), torch.float32)
    assert torch.equal(c, torch.full((3, 4), 0.25))
    u = tinit.UniformInitializer(0, -0.1, 0.3)(gen, (2000,), torch.float32)
    assert float(u.min()) >= -0.1 and float(u.max()) < 0.3
    assert abs(float(u.mean()) - 0.1) < 0.01
    n = tinit.NormInitializer(0, 1.0, 0.5)(gen, (4000,), torch.float32)
    assert abs(float(n.mean()) - 1.0) < 0.05 and abs(float(n.std()) - 0.5) < 0.05


# ---------------------------------------------------------------- executor state
B_STATE = 4


def _state_model(pkg):
    """conv -> batch_norm -> cache -> pool -> flat -> dense -> softmax,
    plus an integer and a frozen float ``parameter``."""
    if pkg == "jax":
        m, ft = FFModel(FFConfig(batch_size=B_STATE)), jft
    else:
        m, ft = TModel(TConfig(batch_size=B_STATE, device="cpu")), tft
    x = m.create_tensor((B_STATE, 3, 8, 8))
    t = m.conv2d(x, 6, 3, 3, 1, 1, 1, 1, name="conv")
    t = m.batch_norm(t, name="bn")
    t = m.cache(t, name="cache")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, ft.PoolType.AVG, name="pool")
    t = m.flat(t, name="flat")
    frozen = m.parameter((t.shape[1],), trainable=False, name="frozen")
    m.parameter((3,), dtype=ft.DataType.INT32, name="table")
    t = m.add(t, frozen, name="shift")
    t = m.dense(t, 5, name="head")
    m.softmax(t, name="probs")
    if pkg == "jax":
        m.compile(optimizer=SGDOptimizer(lr=0.1),
                  loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[MetricsType.ACCURACY], mesh=MachineMesh((1, 1), ("data", "model")),
                  seed=0)
    else:
        m.compile(topt.SGDOptimizer(lr=0.1), metrics=[tft.MetricsType.ACCURACY])
    return m


def _state_batches():
    rng = np.random.default_rng(13)
    return [(rng.normal(size=(B_STATE, 3, 8, 8)).astype(np.float32) * 2 + 1,
             rng.integers(0, 5, size=(B_STATE, 1)).astype(np.int32)) for _ in range(2)]


def _max_diff(a, b):
    assert sorted(a) == sorted(b) and all(sorted(a[k]) == sorted(b[k]) for k in a)
    return max(float(np.abs(np.asarray(a[l][w], np.float64) - b[l][w]).max())
               for l in a for w in a[l])


def test_batch_norm_and_cache_state_match_jax_after_two_steps():
    """Non-trainable weights are state in both packages: no gradient and
    no optimizer slot; after 2 steps the running stats, the cached batch
    and every parameter agree, and the state moved."""
    jm, tm = _state_model("jax"), _state_model("torch")
    tm.set_weights(jm.get_weights())
    ex = tm.executor
    assert sorted(ex.state) == ["bn", "cache", "frozen", "table"]
    assert sorted(ex.state["bn"]) == ["running_mean", "running_var"]
    assert ex.state["table"]["value"].dtype == torch.int32
    assert all(not t.requires_grad for ws in ex.state.values() for t in ws.values())
    assert sorted(ex.opt_state_by_name()) == ["step"]  # plain SGD keeps no slot
    assert ("bn", "running_mean") not in ex.param_names()
    assert tm.num_parameters() == jm.num_parameters
    before = tm.get_weights()
    batches = _state_batches()
    jl = [float(jm.executor.train_step([x], y)[0]) for x, y in batches]
    tl = [float(tm.executor.train_step([x], y)[0]) for x, y in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=0)
    jw, tw = jm.get_weights(), tm.get_weights()
    assert _max_diff(jw, tw) <= 1e-5
    assert float(np.abs(tw["cache"]["cached"]).max()) > 0
    assert float(np.abs(tw["bn"]["running_mean"] - before["bn"]["running_mean"]).max()) > 1e-3
    assert float(np.abs(tw["bn"]["running_var"] - before["bn"]["running_var"]).max()) > 1e-3
    np.testing.assert_array_equal(tw["frozen"]["value"], before["frozen"]["value"])
    # eval normalises with the running stats, in both packages
    x = batches[0][0]
    np.testing.assert_allclose(tm.eval_batch([x]).numpy(), np.asarray(jm.eval_batch([x])),
                               atol=1e-5, rtol=0)


def test_cache_holds_the_last_training_batch():
    """A cache on the graph input holds exactly the last training batch;
    an eval forward leaves it alone."""
    tm = TModel(TConfig(batch_size=B_STATE, device="cpu"))
    t = tm.cache(tm.create_tensor((B_STATE, 6)), name="cache")
    tm.softmax(tm.dense(t, 3))
    tm.compile(topt.SGDOptimizer(lr=0.1))
    rng = np.random.default_rng(15)
    xs = [rng.normal(size=(B_STATE, 6)).astype(np.float32) for _ in range(3)]
    for x in xs[:2]:
        tm.executor.train_step([x], np.zeros((B_STATE, 1), np.int32))
    np.testing.assert_array_equal(tm.get_weights()["cache"]["cached"], xs[1])
    tm.eval_batch([xs[2]])
    np.testing.assert_array_equal(tm.get_weights()["cache"]["cached"], xs[1])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_with_state_loads_across_packages(tmp_path, direction):
    """``ffckpt/2`` carries state under ``state/<layer>/<weight>``: a
    checkpoint of either package loads into the other bit for bit, and
    training on from it agrees."""
    jm, tm = _state_model("jax"), _state_model("torch")
    batches = _state_batches()
    if direction == "jax_to_port":
        jm.executor.train_step(*[[batches[0][0]], batches[0][1]])
        path = jm.save_checkpoint(str(tmp_path / "j"))
        with np.load(path) as z:
            assert "state/bn/running_var" in z.files and "state/cache/cached" in z.files
        tm.load_checkpoint(path)
    else:
        tm.executor.train_step([batches[0][0]], batches[0][1])
        path = tm.save_checkpoint(str(tmp_path / "t"))
        with np.load(path) as z:
            assert "state/bn/running_var" in z.files and "state/table/value" in z.files
            assert z["state/table/value"].dtype == np.int32
        jm.load_checkpoint(path)
    jw, tw = jm.get_weights(), tm.get_weights()
    assert _max_diff(jw, tw) == 0.0
    assert tm.executor._step_count == jm.executor._step_count == 1
    jl = float(jm.executor.train_step([batches[1][0]], batches[1][1])[0])
    tl = float(tm.executor.train_step([batches[1][0]], batches[1][1])[0])
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=0)
    assert _max_diff(jm.get_weights(), tm.get_weights()) <= 1e-5


def test_kill_and_resume_with_state_is_bit_identical(tmp_path):
    """A checkpoint after step 1 resumes in a fresh port model to the
    uninterrupted run's parameters, state and step bit for bit."""
    batches = _state_batches() + _state_batches()[::-1]
    ref = _state_model("torch")
    for x, y in batches:
        ref.executor.train_step([x], y)
    first = _state_model("torch")  # the same seed: the same initial weights
    first.executor.train_step([batches[0][0]], batches[0][1])
    path = first.save_checkpoint(str(tmp_path / "k"))
    resumed = _state_model("torch")
    resumed.load_checkpoint(path)
    for x, y in batches[1:]:
        resumed.executor.train_step([x], y)
    a, b = ref.get_weights(), resumed.get_weights()
    assert _max_diff(a, b) == 0.0
    assert resumed.executor._step_count == ref.executor._step_count == len(batches)


# ---------------------------------------------------------------- flash rows
def test_flash_launches_chunk_b_times_h_past_the_grid_limit(monkeypatch):
    """A call over B * H rows launches its kernel once per chunk of at
    most ``GRID_Y_MAX`` rows, with each chunk's first row, and counts as
    one launch."""
    monkeypatch.setattr(tfa, "GRID_Y_MAX", 5)
    assert tfa.bh_chunks(12) == [(0, 5), (5, 5), (10, 2)]
    assert tfa.bh_chunks(5) == [(0, 5)]
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tfa, "_stream", lambda device: 7)
    monkeypatch.setitem(tfa.LAUNCHES, "fwd", 0)
    q = torch.zeros(3, 4, 128, 64)
    ptrs = (16, 32, 48, 64, 80)
    tfa._launch("fwd", fake, ptrs, q, 256, True, 0.0, 3, 0)
    assert [(c[5], c[6]) for c in calls] == [(0, 5), (5, 5), (10, 2)]
    assert all(c[:5] == ptrs and c[7:10] == (128, 256, 64) and c[-1] == 7 for c in calls)
    assert tfa.LAUNCHES["fwd"] == 1


def test_attention_takes_flash_past_the_grid_limit(monkeypatch):
    """B * H above the (patched) limit: ``check_inputs`` accepts it, the
    attention op takes the flash path, and the plain flash forward and
    backward match the reference's."""
    monkeypatch.setattr(tfa, "GRID_Y_MAX", 3)
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, 128, 64)).astype(np.float32))
               for _ in range(3))
    tfa.check_inputs(q, k, v)
    assert tfa.kernel_takes(128, 128, 64, torch.float32)
    taken = []
    real = tattn.flash_attention

    def spy(*args, **kwargs):
        taken.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    tm = TModel(TConfig(batch_size=2, device="cpu"))
    x = tm.create_tensor((2, 128, 256))
    tm.multihead_attention(x, x, x, 256, 4, name="attn")
    tm.compile(topt.SGDOptimizer(lr=0.1), loss_type=tft.LossType.IDENTITY)
    tm.executor.train_step([rng.normal(size=(2, 128, 256)).astype(np.float32)],
                           np.zeros((2, 1), np.float32))
    assert taken == [(2, 4, 128, 64)]
    out = tfa.flash_attention(q.requires_grad_(), k, v, causal=True)
    ref = torch.softmax((q @ k.transpose(-1, -2) / 8.0).masked_fill(
        torch.ones(128, 128, dtype=torch.bool).triu(1), float("-inf")), -1) @ v
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5, rtol=0)
