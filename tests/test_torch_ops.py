"""Each ported op against its JAX ``OpDef.forward``, on the CPU.

The same numpy inputs and weights go through the JAX op (``jax.numpy``
on the CPU; the flash case runs the Pallas kernel in interpret mode) and
the port's op, built from the same layer attributes.  float32 throughout;
tolerance 1e-5 relative to max |JAX value| plus 1e-6 absolute (the two
libraries reduce in different orders).  Also: the sparse CCE loss and
the accuracy metric, one SGD and one Adam update (with weight decay)
against the JAX optimizers, dropout's rate, and the import-time registry.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import flexflow_tpu.ops  # noqa: E402,F401  (registers the JAX ops)
import flexflow_tpu.ops.pallas.flash_attention as jfa  # noqa: E402
import flexflow_tpu_torch.ops  # noqa: E402,F401  (registers the port's ops)
from flexflow_tpu import fftype as jft  # noqa: E402
from flexflow_tpu import loss as jloss  # noqa: E402
from flexflow_tpu import metrics as jmetrics  # noqa: E402
from flexflow_tpu import optimizer as jopt  # noqa: E402
from flexflow_tpu import tensor as jtensor  # noqa: E402
from flexflow_tpu.ops.base import OpContext as JCtx  # noqa: E402
from flexflow_tpu.ops.base import get_op_def as jget  # noqa: E402
from flexflow_tpu_torch import fftype as tft  # noqa: E402
from flexflow_tpu_torch import loss as tloss  # noqa: E402
from flexflow_tpu_torch import metrics as tmetrics  # noqa: E402
from flexflow_tpu_torch import optimizer as topt  # noqa: E402
from flexflow_tpu_torch import tensor as ttensor  # noqa: E402
from flexflow_tpu_torch.ops.base import OpContext as TCtx  # noqa: E402
from flexflow_tpu_torch.ops.base import all_ops, get_op_def as tget  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + atol


def _convert(attrs, ft):
    """Attribute values with the JAX enums swapped for the port's."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (jft.ActiMode, tft.ActiMode)):
            v = getattr(ft.ActiMode, v.name)
        out[k] = v
    return out


def _run_both(op: str, shapes, attrs, seed=0, same_input=False, training=False):
    """The op ``op`` (an OperatorType name) on float32 inputs of
    ``shapes``; returns (JAX outputs, port outputs)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if same_input:
        xs = [xs[0]] * len(shapes)
    jl = jtensor.Layer(getattr(jft.OperatorType, op), "op",
                       [jtensor.Tensor(s) for s in shapes], _convert(attrs, jft))
    tl = ttensor.Layer(getattr(tft.OperatorType, op), "op",
                       [ttensor.Tensor(s) for s in shapes], _convert(attrs, tft))
    jdef, tdef = jget(jl.op_type), tget(tl.op_type)
    jw, tw = jdef.weights(jl), tdef.weights(tl)
    assert [(w.name, tuple(w.shape)) for w in jw] == [(w.name, tuple(w.shape)) for w in tw]
    params = {w.name: rng.standard_normal(w.shape).astype(np.float32) * 0.2 for w in jw}
    jx = [jnp.asarray(x) for x in xs]
    tx = [torch.from_numpy(x) for x in xs]
    if same_input:
        jx, tx = [jx[0]] * len(jx), [tx[0]] * len(tx)
    jout = jdef.forward(jl, {k: jnp.asarray(v) for k, v in params.items()}, jx,
                        JCtx(training=training))
    tout = tdef.forward(tl, {k: torch.from_numpy(v) for k, v in params.items()}, tx,
                        TCtx(training, CPU, torch.Generator().manual_seed(seed)))
    assert [tuple(s) for s, _ in tdef.infer(tl)] == [tuple(t.shape) for t in tout]
    return jout, tout


OP_CASES = {
    "linear": ("LINEAR", [(2, 5, 8)], dict(out_dim=16)),
    "linear_relu": ("LINEAR", [(2, 5, 8)], dict(out_dim=16, activation=jft.ActiMode.RELU)),
    "linear_sigmoid": ("LINEAR", [(4, 8)], dict(out_dim=3, activation=jft.ActiMode.SIGMOID)),
    "linear_tanh": ("LINEAR", [(4, 8)], dict(out_dim=3, activation=jft.ActiMode.TANH)),
    "linear_gelu": ("LINEAR", [(2, 5, 8)], dict(out_dim=16, activation=jft.ActiMode.GELU)),
    "linear_gelu_no_bias": ("LINEAR", [(2, 5, 8)],
                            dict(out_dim=16, activation=jft.ActiMode.GELU, use_bias=False)),
    "layer_norm": ("LAYERNORM", [(2, 5, 8)], dict(axes=(2,))),
    "layer_norm_two_axes": ("LAYERNORM", [(2, 5, 8)], dict(axes=(1, 2), eps=1e-3)),
    "layer_norm_no_affine": ("LAYERNORM", [(2, 5, 8)],
                             dict(axes=(2,), elementwise_affine=False)),
    "softmax": ("SOFTMAX", [(4, 10)], dict(dim=-1)),
    "softmax_dim1": ("SOFTMAX", [(2, 5, 8)], dict(dim=1)),
    "reduce_mean": ("REDUCE_MEAN", [(2, 5, 8)], dict(axes=(1,))),
    "reduce_mean_keepdims": ("REDUCE_MEAN", [(2, 5, 8)], dict(axes=(1, 2), keepdims=True)),
    "reduce_mean_batch_axis": ("REDUCE_MEAN", [(2, 5, 8)], dict(axes=(0,))),
    "reshape": ("RESHAPE", [(2, 5, 8)], dict(shape=(10, 8))),
    "add": ("EW_ADD", [(2, 5, 8), (2, 5, 8)], {}),
    "add_broadcast": ("EW_ADD", [(2, 5, 8), (5, 8)], {}),
    "attention_self_sdpa": ("MULTIHEAD_ATTENTION", [(2, 16, 32)] * 3,
                            dict(embed_dim=32, num_heads=4, use_flash=False)),
    "attention_self_causal_bias": ("MULTIHEAD_ATTENTION", [(2, 16, 32)] * 3,
                                   dict(embed_dim=32, num_heads=4, causal=True, bias=True,
                                        use_flash=False)),
    "attention_cross_kdim": ("MULTIHEAD_ATTENTION", [(2, 8, 32), (2, 12, 24), (2, 12, 24)],
                             dict(embed_dim=32, num_heads=2, kdim=8, vdim=8, bias=True)),
    "attention_self_flash": ("MULTIHEAD_ATTENTION", [(1, 128, 128)] * 3,
                             dict(embed_dim=128, num_heads=2, use_flash=True)),
    "attention_self_flash_causal": ("MULTIHEAD_ATTENTION", [(1, 128, 128)] * 3,
                                    dict(embed_dim=128, num_heads=2, causal=True, bias=True,
                                         use_flash=True)),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_forward_matches_jax(name):
    op, shapes, attrs = OP_CASES[name]
    self_attn = op == "MULTIHEAD_ATTENTION" and len(set(shapes)) == 1
    jout, tout = _run_both(op, shapes, attrs, same_input=self_attn)
    assert len(jout) == len(tout)
    rtol = 2e-5 if "flash" in name else 1e-5
    for j, t in zip(jout, tout):
        _close(t, j, rtol=rtol)


def test_reshape_keeps_a_smaller_runtime_batch():
    tl = ttensor.Layer(tft.OperatorType.RESHAPE, "r", [ttensor.Tensor((4, 5, 8))],
                       dict(shape=(4, 40)))
    out = tget(tl.op_type).forward(tl, {}, [torch.zeros(2, 5, 8)], TCtx(False, CPU))[0]
    assert out.shape == (2, 40)


@pytest.mark.parametrize("label_shape", [(6,), (6, 1)])
def test_sparse_cce_and_accuracy_match_jax(label_shape):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, :] = [1.0, 0, 0, 0, 0]  # a zero probability hits the 1e-12 clamp
    labels = rng.integers(0, 5, size=label_shape).astype(np.int32)
    labels.reshape(-1)[0] = 3
    want = jloss.sparse_categorical_crossentropy(jnp.asarray(probs), jnp.asarray(labels))
    got = tloss.sparse_categorical_crossentropy(torch.from_numpy(probs),
                                                torch.from_numpy(labels))
    _close(got, want)
    kinds = [jft.MetricsType.ACCURACY, jft.MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY]
    jm = jmetrics.Metrics(jft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, kinds).compute(
        jnp.asarray(probs), jnp.asarray(labels))
    tm = tmetrics.Metrics(tft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                          [getattr(tft.MetricsType, k.name) for k in kinds]).compute(
        torch.from_numpy(probs), torch.from_numpy(labels))
    assert sorted(jm) == sorted(tm)
    for k in jm:
        _close(tm[k], jm[k])


def _tree(rng):
    return {"l0": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                   "bias": rng.standard_normal(3).astype(np.float32)},
            "l1": {"scale": rng.standard_normal(5).astype(np.float32)}}


def _flat(tree):
    """Leaves in one fixed order (layer, then weight name)."""
    return [tree[l][w] for l in sorted(tree) for w in sorted(tree[l])]


OPT_CASES = {
    "sgd": (jopt.SGDOptimizer(lr=0.1), topt.SGDOptimizer(lr=0.1)),
    "sgd_wd": (jopt.SGDOptimizer(lr=0.1, weight_decay=0.01),
               topt.SGDOptimizer(lr=0.1, weight_decay=0.01)),
    "sgd_momentum": (jopt.SGDOptimizer(lr=0.05, momentum=0.9, weight_decay=1e-3),
                     topt.SGDOptimizer(lr=0.05, momentum=0.9, weight_decay=1e-3)),
    "sgd_nesterov": (jopt.SGDOptimizer(lr=0.05, momentum=0.9, nesterov=True),
                     topt.SGDOptimizer(lr=0.05, momentum=0.9, nesterov=True)),
    "adam": (jopt.AdamOptimizer(alpha=1e-3), topt.AdamOptimizer(alpha=1e-3)),
    "adam_wd": (jopt.AdamOptimizer(alpha=1e-2, weight_decay=0.05, beta1=0.8),
                topt.AdamOptimizer(alpha=1e-2, weight_decay=0.05, beta1=0.8)),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizer_updates_match_jax(name):
    """Three updates with fresh gradients each; parameters and moments
    compared after every one (1e-6 relative)."""
    jo, to = OPT_CASES[name]
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jp = {l: {w: jnp.asarray(a) for w, a in ws.items()} for l, ws in params.items()}
    tp = [torch.from_numpy(a.copy()) for a in _flat(params)]
    js, ts = jo.init_state(jp), to.init_state(tp)
    for _ in range(3):
        g = _tree(rng)
        jp, js = jo.update(jp, {l: {w: jnp.asarray(a) for w, a in ws.items()}
                                for l, ws in g.items()}, js)
        to.update(tp, [torch.from_numpy(a) for a in _flat(g)], ts)
        for t, j in zip(tp, _flat(jp)):
            _close(t, j, rtol=1e-6)
        assert ts["step"] == int(js["step"])
        for key in ("m", "v"):
            if key in js:
                for t, j in zip(ts[key], _flat(js[key])):
                    _close(t, j, rtol=1e-6)


def test_dropout_rate_and_eval_identity():
    tl = ttensor.Layer(tft.OperatorType.DROPOUT, "d", [ttensor.Tensor((64, 256))],
                       dict(rate=0.25))
    x = torch.ones(64, 256)
    op = tget(tl.op_type)
    assert op.forward(tl, {}, [x], TCtx(False, CPU))[0] is x
    y = op.forward(tl, {}, [x], TCtx(True, CPU, torch.Generator().manual_seed(0)))[0]
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))


def test_every_ported_op_is_registered():
    names = {t.name for t in all_ops()}
    assert names >= {"LINEAR", "LAYERNORM", "SOFTMAX", "DROPOUT", "EW_ADD", "REDUCE_MEAN",
                     "RESHAPE", "MULTIHEAD_ATTENTION"}
    for t in all_ops():  # the port's op vocabulary is the JAX one, by value
        assert getattr(jft.OperatorType, t.name).value == t.value
