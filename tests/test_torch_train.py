"""The training slice as a whole: the port's encoder train step against
the JAX ``FFModel``, on the CPU.

The JAX ``transformer_encoder`` (hidden 128, 2 heads of 64, ff 128,
2 layers, seq 128, batch 2, 8 classes, raw (batch, seq, hidden) input)
compiles on a ``(1, 1)`` mesh with its flash kernel in interpret mode;
the port builds the same graph, takes the JAX weights through
``set_weights(jax_model.get_weights())``, and both take 4 steps on the
same numpy batch.  Head dim 64 keeps the port on its flash path (the
kernels' plain versions on the CPU) while the JAX side runs its Pallas
kernels.

Tolerances: float32, losses within 1e-5 relative and every weight within
1e-4 absolute after the last step; bfloat16 compute, losses within 5e-2
relative and weights within 1e-2 (the two frameworks round activations
to bfloat16 at different places, and Adam's first steps move each weight
by about alpha whatever the gradient's size).  Also: ``use_flash=False``
(both sides on ``sdpa``), SGD, the LM head (``reshape`` to
(batch * seq, vocab)), ``set_weights``'s refusals, mixed precision
keeping float32 masters, and the ``--train`` driver.
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

import torch  # noqa: E402

import flexflow_tpu.ops.pallas.flash_attention as jfa  # noqa: E402
from flexflow_tpu import (  # noqa: E402
    AdamOptimizer, FFConfig, FFModel, LossType, MachineMesh, MetricsType, SGDOptimizer,
)
from flexflow_tpu.models.transformer import transformer_encoder  # noqa: E402
from flexflow_tpu_torch import fftype as tft  # noqa: E402
from flexflow_tpu_torch import optimizer as topt  # noqa: E402
from flexflow_tpu_torch.config import FFConfig as TConfig  # noqa: E402
from flexflow_tpu_torch.model import FFModel as TModel  # noqa: E402
from flexflow_tpu_torch.models.transformer import (  # noqa: E402
    transformer_encoder as t_encoder,
)
from flexflow_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402

B, S, HID, HEADS, FF, LAYERS, CLASSES, STEPS = 2, 128, 128, 2, 128, 2, 8, 4
ENC = dict(batch=B, seq=S, hidden=HID, heads=HEADS, ff_dim=FF, num_layers=LAYERS,
           raw_input=True)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(dtype="float32", opt="adam", use_flash=True, num_classes=CLASSES, vocab=32000):
    """The JAX model and the port's, with the JAX weights carried over."""
    jopt = AdamOptimizer(alpha=1e-3) if opt == "adam" else SGDOptimizer(lr=0.05)
    topt_ = topt.AdamOptimizer(alpha=1e-3) if opt == "adam" else topt.SGDOptimizer(lr=0.05)
    jm = FFModel(FFConfig(batch_size=B, compute_dtype=dtype))
    transformer_encoder(jm, num_classes=num_classes, vocab=vocab, use_flash=use_flash, **ENC)
    jm.compile(optimizer=jopt, loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY], mesh=MachineMesh((1, 1), ("data", "model")),
               seed=0)
    tm = TModel(TConfig(batch_size=B, compute_dtype=dtype, device="cpu"))
    t_encoder(tm, num_classes=num_classes, vocab=vocab, use_flash=use_flash, **ENC)
    tm.compile(topt_, metrics=[tft.MetricsType.ACCURACY])
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    tm.set_weights(jm.get_weights())
    return jm, tm


def _batch(labels_shape, n_labels, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, HID)).astype(np.float32)
    y = rng.integers(0, n_labels, size=labels_shape).astype(np.int32)
    return x, y


CASES = {
    # name: (compute dtype, optimizer, use_flash, loss rel tol, weight abs tol)
    "float32_adam_flash": ("float32", "adam", True, 1e-5, 1e-4),
    "float32_adam_sdpa": ("float32", "adam", False, 1e-5, 1e-4),
    "float32_sgd_flash": ("float32", "sgd", True, 1e-5, 1e-4),
    "bfloat16_adam_flash": ("bfloat16", "adam", True, 5e-2, 1e-2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_steps_match_jax(name):
    dtype, opt, use_flash, loss_tol, w_tol = CASES[name]
    jm, tm = _pair(dtype, opt, use_flash)
    x, y = _batch((B, 1), CLASSES)
    launches = dict(tfa.LAUNCHES)
    for _ in range(STEPS):
        jl, jmet = jm.executor.train_step([x], y)
        tl, tmet = tm.executor.train_step([x], y)
        assert isinstance(tl, torch.Tensor) and tl.dtype == torch.float32
        assert abs(float(tl) - float(jl)) <= loss_tol * abs(float(jl))
        assert float(tmet["accuracy"]) == pytest.approx(float(jmet["accuracy"]))
    assert tfa.LAUNCHES == launches  # CPU tensors: the plain versions, no kernel
    jw, tw = jm.get_weights(), tm.get_weights()
    assert sorted(jw) == sorted(tw)
    for layer in jw:
        for w in jw[layer]:
            assert np.abs(tw[layer][w] - jw[layer][w]).max() <= w_tol, (layer, w)
    # mixed precision keeps float32 masters and moments
    ex = tm.executor
    assert all(p.dtype == torch.float32 for p in ex.param_list())
    for key in ("m", "v"):
        assert all(t.dtype == torch.float32 for t in ex.opt_state.get(key, []))


def test_lm_head_with_reshape_matches_jax():
    """The LM-head variant: dense to the vocab, reshape to
    (batch * seq, vocab), softmax, loss over every position."""
    vocab = 16
    jm, tm = _pair(num_classes=None, vocab=vocab)
    x, y = _batch((B * S, 1), vocab)
    for _ in range(2):
        jl, _ = jm.executor.train_step([x], y)
        tl, _ = tm.executor.train_step([x], y)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    probs = tm.executor.forward([x])
    assert probs.shape == (B * S, vocab)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jm.eval_batch([x])), atol=1e-5)


def _weights(tm):
    return {l: dict(ws) for l, ws in tm.get_weights().items()}


@pytest.mark.parametrize("change", ["missing", "extra", "misshaped"])
def test_set_weights_refuses_before_writing(change):
    tm = TModel(TConfig(device="cpu"))
    t_encoder(tm, batch=2, seq=8, hidden=16, heads=2, ff_dim=16, num_layers=1, num_classes=4,
              raw_input=True)
    tm.compile(topt.AdamOptimizer())
    before = _weights(tm)
    bad = _weights(tm)
    for ws in bad.values():
        for w in ws:
            ws[w] = ws[w] + 1.0
    if change == "missing":
        del bad["enc0_attn"]["wo"]
    elif change == "extra":
        bad["enc0_attn"]["bq"] = np.zeros(16, np.float32)
    else:
        bad["cls_head"]["kernel"] = np.zeros((16, 5), np.float32)
    with pytest.raises(ValueError, match="set_weights"):
        tm.set_weights(bad)
    after = _weights(tm)
    for layer in before:
        for w in before[layer]:
            np.testing.assert_array_equal(after[layer][w], before[layer][w])


def test_token_embedding_front_end_is_not_ported():
    """The name predates the token front end's port; the test now holds it
    against JAX: ``raw_input=False`` builds ``token_ids`` -> ``tok_embed``
    plus the ``pos_embed`` input -> ``embed_add``, carries the JAX weights
    (the embedding table included) and trains to the same losses, ids
    past the vocabulary included (they clamp to the last row)."""
    enc = dict(batch=2, seq=8, hidden=16, heads=2, ff_dim=16, num_layers=1, vocab=11,
               num_classes=3)
    jm = FFModel(FFConfig(batch_size=2))
    transformer_encoder(jm, **enc)
    jm.compile(optimizer=AdamOptimizer(alpha=1e-3),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               mesh=MachineMesh((1, 1), ("data", "model")), seed=0)
    tm = TModel(TConfig(batch_size=2, device="cpu"))
    t_encoder(tm, **enc)
    tm.compile(topt.AdamOptimizer(alpha=1e-3))
    assert [l.name for l in tm.layers][:3] == ["tok_embed", "embed_add", "enc0_attn"]
    assert [t.name for t in tm.graph_inputs] == ["token_ids", "pos_embed"]
    assert tm.graph_inputs[0].dtype is tft.DataType.INT32
    tm.set_weights(jm.get_weights())
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 13, size=(2, 8)).astype(np.int32)
    pos = rng.normal(size=(2, 8, 16)).astype(np.float32)
    y = rng.integers(0, 3, size=(2, 1)).astype(np.int32)
    for _ in range(3):
        jl, _ = jm.executor.train_step([ids, pos], y)
        tl, _ = tm.executor.train_step([ids, pos], y)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jw, tw = jm.get_weights(), tm.get_weights()
    assert np.abs(tw["tok_embed"]["kernel"] - jw["tok_embed"]["kernel"]).max() <= 1e-4


def _driver(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "flexflow_tpu_torch", "--train", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_train_driver_on_the_cpu_prints_one_json_line():
    out = _driver("--device", "cpu", "--layers", "1", "--hidden", "128", "--heads", "2",
                  "--ff-dim", "128", "--seq", "128", "--batch", "2", "--classes", "8",
                  "--steps", "3")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu" and rec["num_layers"] == 1 and rec["hidden"] == 128
    assert len(rec["losses"]) == 3 and all(np.isfinite(rec["losses"]))
    assert rec["losses"][-1] < rec["losses"][0]
    assert rec["flash_launches"] == {"fwd": 0, "dq": 0, "dkv": 0}
    assert rec["samples_per_s"] > 0 and rec["step_ms_median"] > 0


def test_train_driver_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _driver("--layers", "1", "--steps", "1")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout == ""
