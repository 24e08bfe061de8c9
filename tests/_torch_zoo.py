"""The model zoo cases shared by ``test_torch_models_zoo.py``,
``test_torch_cnn_zoo.py`` and ``test_torch_inception_zoo.py``: each
model through the port's ``FFModel.fit`` against the JAX package's, on
the CPU.

Sizes are the JAX zoo tests' (``tests/test_model_zoo.py``): batch 2 for
the CNNs, AlexNet and ResNet (layers 1, 1, 1, 1) at 64x64, ResNeXt-50 at
64x64, InceptionV3 at 75x75; narrow MLP, DLRM, XDL and CANDLE-Uno widths;
the MoE models at the JAX tests' expert counts.  Each JAX model compiles
on a ``(1, 1)`` mesh; the port takes its weights through
``set_weights(jax_model.get_weights())``; both ``fit`` 3 batches of
seeded numpy data (one epoch, no shuffle), and each ``train_step`` call
of either ``fit`` is recorded.  The JAX ``fit`` is held to its Python
loaders (``native_available`` patched to False).

Tolerances: the 3 losses within 1e-5 relative, the weights after them
within 1e-4 absolute.  The cases are split over three files so that each
file runs in well under 90 s on one CPU thread: most of the time is the
JAX package's compile.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import flexflow_tpu.obs.health as jhealth  # noqa: E402
import flexflow_tpu.obs.trace as jtrace  # noqa: E402
import flexflow_tpu.ops  # noqa: E402,F401  (registers the JAX ops)
import flexflow_tpu.runtime.faults as jfaults  # noqa: E402
import flexflow_tpu.runtime.native as jnative  # noqa: E402
from flexflow_tpu import (  # noqa: E402
    AdamOptimizer, FFConfig, FFModel, LossType, MachineMesh, SGDOptimizer,
)
from flexflow_tpu import models as jzoo  # noqa: E402
from flexflow_tpu.models.candle_uno import INPUT_FEATURES  # noqa: E402
import flexflow_tpu_torch.runtime.faults as tfaults  # noqa: E402
from flexflow_tpu_torch import fftype as tft  # noqa: E402
from flexflow_tpu_torch import models as tzoo  # noqa: E402
from flexflow_tpu_torch import optimizer as topt  # noqa: E402
from flexflow_tpu_torch.config import FFConfig as TConfig  # noqa: E402
from flexflow_tpu_torch.model import FFModel as TModel  # noqa: E402
from flexflow_tpu_torch.models.dlrm_data import synthetic_dlrm  # noqa: E402

STEPS = 3
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def zoo_setup(monkeypatch):
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setattr(jfaults, "_PLAN", None)
    monkeypatch.setattr(tfaults, "_PLAN", None)
    monkeypatch.setattr(jhealth, "_MONITOR", jhealth.HealthMonitor())
    monkeypatch.setattr(jtrace, "_TRACER", jtrace.Tracer())
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _images(batch, size, classes, seed=0):
    rng = np.random.default_rng(seed)
    n = STEPS * batch
    x = rng.normal(size=(n, 3, size, size)).astype(np.float32)
    y = rng.integers(0, classes, size=(n, 1)).astype(np.int32)
    return [x], y


def _features(batch, dim, classes, seed=0):
    rng = np.random.default_rng(seed)
    n = STEPS * batch
    return ([rng.normal(size=(n, dim)).astype(np.float32)],
            rng.integers(0, classes, size=(n, 1)).astype(np.int32))


def _candle_data(batch, shapes, seed=0):
    rng = np.random.default_rng(seed)
    n = STEPS * batch
    xs = [rng.normal(size=(n, shapes[ft])).astype(np.float32) for ft in INPUT_FEATURES.values()]
    return xs, rng.normal(size=(n, 1)).astype(np.float32)


SPARSE, MSE = "SPARSE_CATEGORICAL_CROSSENTROPY", "MEAN_SQUARED_ERROR_AVG_REDUCE"
CANDLE_SHAPES = {"dose": 1, "cell.rnaseq": 64, "drug.descriptors": 128}

# name: (builder name, batch, builder kwargs, loss, optimizer, data)
CASES = {
    "mlp": ("mlp", 4, dict(in_dim=32, hidden_dims=(24, 16), num_classes=10), SPARSE, "sgd",
            lambda: _features(4, 32, 10)),
    "alexnet": ("alexnet", 2, dict(num_classes=10, height=64, width=64), SPARSE, "sgd",
                lambda: _images(2, 64, 10)),
    "resnet": ("resnet", 2, dict(num_classes=10, layers=(1, 1, 1, 1), height=64, width=64),
               SPARSE, "sgd", lambda: _images(2, 64, 10)),
    "resnext50": ("resnext50", 2, dict(num_classes=10, height=64, width=64), SPARSE, "sgd",
                  lambda: _images(2, 64, 10)),
    "inception_v3": ("inception_v3", 2, dict(num_classes=10, height=75, width=75), SPARSE,
                     "sgd", lambda: _images(2, 75, 10)),
    "dlrm": ("dlrm", 8, dict(embedding_sizes=(1024, 1024, 512), sparse_feature_size=16,
                             bag_size=2, mlp_bot=(4, 16, 16), mlp_top=(64, 16, 2)), MSE, "sgd",
             lambda: synthetic_dlrm(STEPS * 8, (1024, 1024, 512), bag_size=2)),
    "xdl": ("xdl", 8, dict(embedding_sizes=(512, 512), sparse_feature_size=16, mlp=(32, 2)),
            MSE, "sgd", lambda: synthetic_dlrm(STEPS * 8, (512, 512), arch="xdl")),
    "candle_uno": ("candle_uno", 4, dict(dense_layers=(32, 32), dense_feature_layers=(32, 32),
                                         feature_shapes=CANDLE_SHAPES), MSE, "sgd",
                   lambda: _candle_data(4, CANDLE_SHAPES)),
    "moe_classifier": ("moe_classifier", 16, dict(in_dim=32, num_exp=4, num_select=2,
                                                  hidden=16, num_classes=10), SPARSE, "adam",
                       lambda: _features(16, 32, 10)),
    "moe_classifier_fused": ("moe_classifier", 16, dict(in_dim=32, num_exp=4, num_select=2,
                                                        hidden=16, num_classes=10, fused=True),
                             SPARSE, "adam", lambda: _features(16, 32, 10)),
    "moe_encoder": ("moe_encoder", 4, dict(seq=8, hidden=16, heads=2, num_layers=1, num_exp=4,
                                           num_select=2, num_classes=8), SPARSE, "adam",
                    lambda: _seq_data(4, 8, 16, 8)),
}


def _seq_data(batch, seq, hidden, classes, seed=0):
    rng = np.random.default_rng(seed)
    n = STEPS * batch
    return ([rng.normal(size=(n, seq, hidden)).astype(np.float32)],
            rng.integers(0, classes, size=(n, 1)).astype(np.int32))


def _recorded(ex):
    """Wrap ``ex.train_step`` so that each call's loss is kept."""
    losses = []
    step = ex.train_step

    def train_step(*args, **kwargs):
        loss, m = step(*args, **kwargs)
        losses.append(loss)
        return loss, m

    ex.train_step = train_step
    return losses


def _fit_both(case):
    builder, batch, kw, loss, opt, data = CASES[case]
    xs, y = data()
    jm = FFModel(FFConfig(batch_size=batch))
    getattr(jzoo, builder)(jm, batch, **kw)
    jopt = SGDOptimizer(lr=0.01) if opt == "sgd" else AdamOptimizer(alpha=1e-3)
    jm.compile(optimizer=jopt, loss_type=getattr(LossType, loss),
               mesh=MachineMesh((1, 1), ("data", "model")), seed=0)
    tm = TModel(TConfig(batch_size=batch, device="cpu"))
    getattr(tzoo, builder)(tm, batch, **kw)
    topt_ = topt.SGDOptimizer(lr=0.01) if opt == "sgd" else topt.AdamOptimizer(alpha=1e-3)
    tm.compile(topt_, loss_type=getattr(tft.LossType, loss))
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    tm.set_weights(jm.get_weights())
    jl, tl = _recorded(jm.executor), _recorded(tm.executor)
    jm.fit(xs, y, batch_size=batch, epochs=1, verbose=False)
    tm.fit(xs, y, batch_size=batch, epochs=1, verbose=False)
    return jm, tm, [float(v) for v in jl], [float(v) for v in tl]


def check_fits_as_jax(case):
    """``fit`` both packages' ``case`` over 3 batches; hold the losses
    and the weights after them to the tolerances."""
    jm, tm, jl, tl = _fit_both(case)
    assert len(tl) == len(jl) == STEPS
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    jw, tw = jm.get_weights(), tm.get_weights()
    assert sorted(jw) == sorted(tw)
    worst = max(float(np.abs(np.asarray(jw[l][w], np.float64) - tw[l][w]).max())
                for l in jw for w in jw[l])
    assert worst <= WEIGHT_ATOL, worst
