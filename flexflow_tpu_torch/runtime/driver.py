"""``python -m flexflow_tpu_torch --train [flags]``: the encoder train driver.

Counterpart of ``examples/transformer/bert.py`` and of the ``bench.py``
``run_bench`` main path: build ``transformer_encoder`` (raw
(batch, seq, hidden) input, pooled classifier), compile with Adam and
sparse categorical cross-entropy, and take ``--steps`` steps on one
seeded numpy batch.  Prints one JSON line: the loss of every step,
samples/s and the median step time over the steps after the first, the
flash-kernel launches, and the device.

The defaults are BERT-Base at seq 512, batch 16, 64 classes, on
``--device cuda``.  ``--device cpu`` runs the plain PyTorch path (pass
small widths there); without a CUDA device the default raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from flexflow_tpu_torch.fftype import LossType, MetricsType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models.transformer import BERT_BASE, transformer_encoder
from flexflow_tpu_torch.ops.cuda import flash_attention as fa
from flexflow_tpu_torch.optimizer import AdamOptimizer

__all__ = ["build_model", "make_batch", "run", "main"]

LR = 1e-4  # Adam's alpha, as in run_bench
SEED = 0


def build_model(*, batch: int, seq: int, hidden: int, heads: int, ff_dim: int, num_layers: int,
                num_classes: int, compute_dtype: str, lr: float, use_flash: bool, seed: int,
                device) -> FFModel:
    """The encoder compiled with Adam(alpha=lr) and sparse CCE, weights
    drawn from ``seed``."""
    model = FFModel(FFConfig(batch_size=batch, compute_dtype=compute_dtype, seed=seed,
                             device=str(device)))
    transformer_encoder(model, batch=batch, seq=seq, hidden=hidden, heads=heads, ff_dim=ff_dim,
                        num_layers=num_layers, num_classes=num_classes, use_flash=use_flash,
                        raw_input=True)
    model.compile(optimizer=AdamOptimizer(alpha=lr),
                  loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[MetricsType.ACCURACY])
    return model


def make_batch(batch: int, seq: int, hidden: int, num_classes: int, seed: int):
    """One numpy batch, as ``run_bench`` makes it: normal inputs, uniform
    integer labels of shape (batch, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, seq, hidden)).astype(np.float32)
    y = rng.integers(0, num_classes, size=(batch, 1)).astype(np.int32)
    return x, y


def run(model: FFModel, x, y, steps: int) -> dict:
    """``steps`` train steps on one batch placed on the device once.  The
    driver synchronises after each step to time it; the losses are read
    back once, after the last step."""
    ex = model.executor
    dev = ex.device
    xs, ys = ex.place(x), ex.place(y)
    cuda = dev.type == "cuda"
    losses: List[torch.Tensor] = []
    times: List[float] = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _ = ex.train_step([xs], ys)
        if cuda:
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    timed = times[1:] or times
    step_s = statistics.median(timed)
    return {
        "losses": [float(v) for v in torch.stack(losses).cpu()],
        "step_ms_median": step_s * 1e3,
        "step_ms": [t * 1e3 for t in times],
        "samples_per_s": x.shape[0] / step_s,
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m flexflow_tpu_torch --train")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--hidden", type=int, help="override BERT-Base's width")
    p.add_argument("--heads", type=int)
    p.add_argument("--ff-dim", type=int)
    p.add_argument("--layers", type=int)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--classes", type=int, default=64)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32")
    a = p.parse_args(argv)

    dev = resolve_device(a.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(BERT_BASE)
    for key, val in (("hidden", a.hidden), ("heads", a.heads), ("ff_dim", a.ff_dim),
                     ("num_layers", a.layers)):
        if val is not None:
            cfg[key] = val
    model = build_model(batch=a.batch, seq=a.seq, num_classes=a.classes,
                        compute_dtype=a.compute_dtype, lr=LR, use_flash=True, seed=SEED,
                        device=dev, **cfg)
    x, y = make_batch(a.batch, a.seq, cfg["hidden"], a.classes, SEED)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    res = run(model, x, y, a.steps)
    print(json.dumps({
        **cfg, "batch": a.batch, "seq": a.seq, "classes": a.classes,
        "compute_dtype": a.compute_dtype, "steps": a.steps,
        **res, "parameters": model.num_parameters(), "flash_launches": dict(fa.LAUNCHES),
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }), flush=True)
    return 0
