"""``python -m flexflow_tpu_torch --train [flags]``: the train drivers.

Three modes, each printing one JSON line with the flash-kernel launches
and the device:

* default: the ``bench.py`` ``run_bench`` main path.  Build
  ``transformer_encoder`` (raw (batch, seq, hidden) input, pooled
  classifier), compile with Adam and sparse categorical cross-entropy,
  and take ``--steps`` steps on one seeded numpy batch: the loss of
  every step, samples/s and the median step time over the steps after
  the first.
* ``--fit``: the encoder on tokens (``token_ids`` and a sinusoidal
  ``pos_embed`` input, ``--vocab`` 30522), trained by ``FFModel.fit``
  for ``--epochs`` over ``--samples`` seeded samples, then
  ``FFModel.eval`` over ``--eval-samples`` more: the last epoch's
  metrics, the eval's, host syncs and the seconds the host waited in
  them, and with ``--checkpoint-every`` / ``--checkpoint-path`` /
  ``--resume`` / ``--fault-plan`` the checkpoint and resume path (an
  injected fault ends the run with its error after the line is
  printed).  ``--profiling`` flushes the metrics every step; a
  ``--health`` mode other than ``off`` raises ``NotImplementedError``
  (the run-health monitor is not ported).
* ``--model gpt2``: ``gpt_decoder`` through ``FFModel`` (GPT-2 small,
  ``--vocab`` 50257, batch 4, seq 1024), ``--steps`` train steps on
  next-token labels of a stride-3 cycle as ``examples/gpt/gpt.py`` takes
  them, then ``--generate N`` greedy tokens by ``gpt_generate``.
* the model zoo, one mode per ``examples/`` app, each trained by
  ``FFModel.fit`` on synthetic data drawn from one numpy seed as its
  example draws it, with its example's defaults (:data:`ZOO`):
  ``--model mlp`` (``examples/mlp/mnist_mlp.py``: 784-512-512-10 on
  Gaussian blobs), ``--model alexnet|resnet|resnext50|inception``
  (``examples/cnn/train_cnn.py``; ``--model cnn --arch X`` too,
  ``--size``, ``--classes``), ``--model dlrm|xdl``
  (``examples/dlrm/dlrm.py``; ``--model dlrm --arch xdl`` too,
  ``--embedding-size``, ``--num-tables``, ``--sparse-feature-size``,
  ``--bag-size``, ``--data FILE`` for a local Criteo-format file),
  ``--model candle_uno`` (``examples/candle_uno/candle_uno.py``),
  ``--model moe`` (``examples/moe/moe.py``; ``--fused`` for the batched
  experts op) and ``--model moe_encoder`` (the MoE encoder at hidden 64,
  seq 64).  ``--batch``, ``--epochs``, ``--samples`` and ``--lr``
  override the example's values.

The defaults are BERT-Base widths on ``--device cuda``.  ``--device cpu``
runs the plain PyTorch path (pass small widths there); without a CUDA
device the default raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch import models as zoo
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from flexflow_tpu_torch.fftype import LossType, MetricsType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models.dlrm_data import load_criteo, synthetic_dlrm
from flexflow_tpu_torch.models.transformer import (
    BERT_BASE, GPT2_SMALL, gpt_decoder, gpt_generate, transformer_encoder,
)
from flexflow_tpu_torch.ops.cuda import flash_attention as fa
from flexflow_tpu_torch.optimizer import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.runtime.faults import InjectedFault

__all__ = ["FIT_METRICS", "ZOO", "build_model", "make_batch", "run", "make_token_data",
           "build_gpt", "make_gpt_batches", "build_zoo", "make_zoo_data", "main"]

LR = 1e-4  # Adam's alpha, as in run_bench
SEED = 0
FIT_METRICS = (MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY)


def build_model(*, batch: int, seq: int, hidden: int, heads: int, ff_dim: int, num_layers: int,
                num_classes: int, compute_dtype: str, lr: float, use_flash: bool, seed: int,
                device, vocab: Optional[int] = None,
                metrics: Sequence[MetricsType] = (MetricsType.ACCURACY,), **config) -> FFModel:
    """The encoder compiled with Adam(alpha=lr), sparse CCE and
    ``metrics``, weights drawn from ``seed``: on raw (batch, seq, hidden)
    inputs, or on tokens when ``vocab`` is given.  ``config`` sets
    further ``FFConfig`` fields."""
    model = FFModel(FFConfig(batch_size=batch, compute_dtype=compute_dtype, seed=seed,
                             device=str(device), **config))
    transformer_encoder(model, batch=batch, seq=seq, hidden=hidden, heads=heads, ff_dim=ff_dim,
                        num_layers=num_layers, num_classes=num_classes, use_flash=use_flash,
                        raw_input=vocab is None, **({"vocab": vocab} if vocab else {}))
    model.compile(optimizer=AdamOptimizer(alpha=lr),
                  loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=list(metrics))
    return model


def make_batch(batch: int, seq: int, hidden: int, num_classes: int, seed: int):
    """One numpy batch, as ``run_bench`` makes it: normal inputs, uniform
    integer labels of shape (batch, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, seq, hidden)).astype(np.float32)
    y = rng.integers(0, num_classes, size=(batch, 1)).astype(np.int32)
    return x, y


def make_token_data(n: int, seq: int, hidden: int, vocab: int, num_classes: int, seed: int
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """``n`` samples for the encoder on tokens: uniform token ids, the
    sinusoidal position table as every sample's ``pos_embed`` (a
    broadcast view: one table in memory), uniform labels (n, 1)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(n, seq)).astype(np.int32)
    y = rng.integers(0, num_classes, size=(n, 1)).astype(np.int32)
    pos = np.arange(seq)[:, None] / np.power(10000.0, (np.arange(hidden) // 2 * 2) / hidden)
    table = np.where(np.arange(hidden) % 2 == 0, np.sin(pos), np.cos(pos)).astype(np.float32)
    return [ids, np.broadcast_to(table, (n, seq, hidden))], y


def build_gpt(*, batch: int, seq: int, hidden: int, heads: int, ff_dim: int, num_layers: int,
              vocab: int, compute_dtype: str, lr: float, use_flash: bool, seed: int,
              device) -> FFModel:
    """``gpt_decoder`` compiled with Adam(alpha=lr) and sparse CCE over
    every position, weights drawn from ``seed``."""
    model = FFModel(FFConfig(batch_size=batch, compute_dtype=compute_dtype, seed=seed,
                             device=str(device)))
    gpt_decoder(model, batch, seq, hidden=hidden, heads=heads, ff_dim=ff_dim,
                num_layers=num_layers, vocab=vocab, use_flash=use_flash)
    model.compile(optimizer=AdamOptimizer(alpha=lr),
                  loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return model


def make_gpt_batches(steps: int, batch: int, seq: int, vocab: int, seed: int
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One (ids, labels) batch per step, as ``examples/gpt/gpt.py`` makes
    them: each row a stride-3 cycle from a random start, the label of
    every position the next token, labels flattened to (batch * seq, 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        starts = rng.integers(0, vocab, size=batch)
        ids = (starts[:, None] + np.arange(seq)[None, :] * 3) % vocab
        y = np.roll(ids, -1, axis=1).reshape(batch * seq, 1)
        out.append((ids.astype(np.int32), y.astype(np.int32)))
    return out


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


def _widths(a, base) -> dict:
    cfg = dict(base)
    for key, val in (("hidden", a.hidden), ("heads", a.heads), ("ff_dim", a.ff_dim),
                     ("num_layers", a.layers)):
        if val is not None:
            cfg[key] = val
    return cfg


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _fit_main(a, dev) -> int:
    """``--fit``: the encoder on tokens through ``fit`` and ``eval``."""
    cfg = _widths(a, BERT_BASE)
    vocab = a.vocab or 30522
    config = dict(checkpoint_every=a.checkpoint_every, checkpoint_path=a.checkpoint_path,
                  resume_from=a.resume, fault_plan=a.fault_plan, profiling=a.profiling,
                  health=a.health)
    model = build_model(batch=a.batch, seq=a.seq, num_classes=a.classes, vocab=vocab,
                        compute_dtype=a.compute_dtype, lr=LR, use_flash=True, seed=SEED,
                        device=dev, metrics=FIT_METRICS, **config, **cfg)
    xs, y = make_token_data(a.samples + a.eval_samples, a.seq, cfg["hidden"], vocab, a.classes,
                            SEED)
    n = a.samples
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    ex = model.executor
    rec = {**cfg, "vocab": vocab, "batch": a.batch, "seq": a.seq, "classes": a.classes,
           "compute_dtype": a.compute_dtype, "epochs": a.epochs, "samples": n,
           "shuffle": a.shuffle, "fault_plan": a.fault_plan, "resume": a.resume,
           "checkpoint_every": a.checkpoint_every}
    step0 = ex._step_count
    if a.resume:  # the steps before the checkpoint are not this run's
        with np.load(a.resume) as z:
            step0 = json.loads(z["meta/manifest"].tobytes().decode())["step"]
    t0 = time.perf_counter()
    fault = None
    try:
        pm = model.fit([v[:n] for v in xs], y[:n], epochs=a.epochs, shuffle=a.shuffle,
                       verbose=False)
    except InjectedFault as e:
        fault, pm = str(e), None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    steps = ex._step_count - step0
    rec.update({"steps": steps, "step_count": ex._step_count, "fit_s": wall,
                "step_ms_mean": wall / max(1, steps) * 1e3, "host_syncs": ex.host_syncs,
                "host_stall_s": ex.host_stall_s, "fault": fault})
    if pm is not None:
        rec.update({"loss": pm.sparse_cce_loss / max(1, pm.train_all),
                    "accuracy": pm.accuracy, "epoch_samples": pm.train_all})
        if a.eval_samples:
            syncs = ex.host_syncs
            pe = model.eval([v[n:] for v in xs], y[n:])
            rec.update({"eval_loss": pe.sparse_cce_loss / max(1, pe.train_all),
                        "eval_accuracy": pe.accuracy, "eval_samples": pe.train_all,
                        "eval_host_syncs": ex.host_syncs - syncs})
    rec.update({"parameters": model.num_parameters(), "flash_launches": dict(fa.LAUNCHES),
                "device": str(dev), "device_name": _device_name(dev)})
    print(json.dumps(rec), flush=True)
    return 1 if fault else 0


def _gpt_main(a, dev) -> int:
    """``--model gpt2``: ``gpt_decoder`` train steps, then greedy tokens."""
    cfg = _widths(a, GPT2_SMALL)
    vocab = a.vocab or 50257
    batch, seq = a.batch or 4, a.seq or 1024
    model = build_gpt(batch=batch, seq=seq, vocab=vocab, compute_dtype=a.compute_dtype, lr=LR,
                      use_flash=True, seed=SEED, device=dev, **cfg)
    batches = make_gpt_batches(a.steps, batch, seq, vocab, SEED)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    ex = model.executor
    losses, times = [], []
    for ids, y in batches:
        t0 = time.perf_counter()
        loss, _ = ex.train_step([ids], y)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    train_launches = dict(fa.LAUNCHES)
    rec = {**cfg, "model": "gpt2", "vocab": vocab, "batch": batch, "seq": seq,
           "compute_dtype": a.compute_dtype, "steps": a.steps,
           "losses": [float(v) for v in torch.stack(losses).cpu()] if losses else [],
           "step_ms": [t * 1e3 for t in times], "flash_launches": train_launches}
    if a.generate:
        prompt_len = min(8, seq - a.generate)
        prompt = make_gpt_batches(1, batch, seq, vocab, SEED + 1)[0][0][:, :prompt_len]
        t0 = time.perf_counter()
        out = gpt_generate(model, prompt, a.generate)
        rec.update({"prompt_len": prompt_len, "generated": out[:, prompt_len:].tolist(),
                    "generate_s": time.perf_counter() - t0})
    rec.update({"parameters": model.num_parameters(), "device": str(dev),
                "device_name": _device_name(dev)})
    print(json.dumps(rec), flush=True)
    return 0


# --------------------------------------------------------------- the zoo
_ACC, _SCCE, _MSE = (MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
                     MetricsType.MEAN_SQUARED_ERROR)
_CNN = {"alexnet": "alexnet", "resnet": "resnet", "resnext50": "resnext50",
        "inception": "inception_v3"}
# each app's example defaults: batch, epochs, SGD learning rate, samples
# (as a function of the batch), loss and metrics
ZOO = {
    "mlp": dict(batch=64, epochs=5, lr=0.05, samples=lambda b: 4096,
                loss=LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=(_ACC, _SCCE)),
    **{name: dict(batch=16, epochs=1, lr=0.01, samples=lambda b: 8 * b,
                  loss=LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=(_ACC, _SCCE))
       for name in _CNN},
    **{name: dict(batch=64, epochs=2, lr=0.01, samples=lambda b: 32 * b,
                  loss=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, metrics=(_MSE,))
       for name in ("dlrm", "xdl")},
    "candle_uno": dict(batch=64, epochs=2, lr=1e-3, samples=lambda b: 16 * b,
                       loss=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, metrics=(_MSE,)),
    "moe": dict(batch=64, epochs=3, lr=1e-3, samples=lambda b: 4096,
                loss=LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=(_ACC, _SCCE)),
    "moe_encoder": dict(batch=64, epochs=3, lr=1e-3, samples=lambda b: 16 * b,
                        loss=LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=(_ACC, _SCCE)),
}
MOE_ENCODER_SEQ = 64


def _blobs(n: int, dim: int, classes: int, rng) -> Tuple[List[np.ndarray], np.ndarray]:
    """The MNIST-like blobs of ``examples/mlp/mnist_mlp.py``."""
    centers = rng.normal(size=(classes, dim)).astype(np.float32) * 2
    y = rng.integers(0, classes, size=n)
    x = (centers[y] + rng.normal(size=(n, dim))).astype(np.float32)
    return [x], y.astype(np.int32).reshape(n, 1)


def build_zoo(name: str, *, batch: int, device, compute_dtype: str = "float32",
              lr: Optional[float] = None, seed: int = SEED, size: int = 128,
              classes: int = 10, embedding_size: int = 65536, num_tables: int = 4,
              sparse_feature_size: int = 64, bag_size: int = 1, fused: bool = False,
              dense_dim: Optional[int] = None) -> FFModel:
    """Zoo model ``name`` (a key of :data:`ZOO`) compiled with SGD at
    ``lr`` (the example's by default), the example's loss and metrics,
    weights drawn from ``seed``.  ``dense_dim``: a Criteo file's dense
    width, which sizes DLRM's bottom and top MLPs as the example sizes
    them."""
    spec = ZOO[name]
    model = FFModel(FFConfig(batch_size=batch, compute_dtype=compute_dtype, seed=seed,
                             device=str(device)))
    if name == "mlp":
        zoo.mlp(model, batch, 784, (512, 512), classes)
    elif name in _CNN:
        getattr(zoo, _CNN[name])(model, batch, num_classes=classes, height=size, width=size)
    elif name in ("dlrm", "xdl"):
        kw = dict(embedding_sizes=(embedding_size,) * num_tables,
                  sparse_feature_size=sparse_feature_size, bag_size=bag_size)
        if dense_dim is not None:  # a Criteo file: 1-wide head on its labels
            sfs = sparse_feature_size
            kw.update(dict(mlp_bot=(dense_dim, 64, sfs), mlp_top=(sfs * (num_tables + 1), 32, 1))
                      if name == "dlrm" else dict(mlp=(64, 32, 1)))
        (zoo.dlrm if name == "dlrm" else zoo.xdl)(model, batch, **kw)
    elif name == "candle_uno":
        zoo.candle_uno(model, batch)
    elif name == "moe":
        zoo.moe_classifier(model, batch, fused=fused)
    else:
        zoo.moe_encoder(model, batch, MOE_ENCODER_SEQ, fused=fused)
    model.compile(optimizer=SGDOptimizer(lr=spec["lr"] if lr is None else lr),
                  loss_type=spec["loss"], metrics=list(spec["metrics"]))
    return model


def make_zoo_data(name: str, model: FFModel, n: int, seed: int = SEED
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
    """``n`` samples for ``model`` (built by :func:`build_zoo`), drawn as
    the app's example draws them, from one numpy seed, at the shapes of
    the model's inputs."""
    rng = np.random.default_rng(seed)
    shapes = [t.shape[1:] for t in model.graph_inputs]
    if name in ("mlp", "moe"):
        classes = model.layers[-1].outputs[0].shape[-1]
        return _blobs(n, shapes[0][0], classes, rng)
    if name in ("dlrm", "xdl"):
        vocabs = [l.attrs["num_entries"] for l in model.layers if l.name.startswith("emb_")]
        out = model.layers[-1].outputs[0].shape[-1]
        dense = shapes[-1][0] if name == "dlrm" else 4
        return synthetic_dlrm(n, vocabs, bag_size=shapes[0][0], dense_dim=dense, label_dim=out,
                              seed=seed, arch=name)
    if name == "candle_uno":
        xs = [rng.normal(size=(n,) + s).astype(np.float32) for s in shapes]
        return xs, rng.normal(size=(n, 1)).astype(np.float32)
    classes = model.layers[-1].outputs[0].shape[-1]
    x = rng.normal(size=(n,) + shapes[0]).astype(np.float32)
    return [x], rng.integers(0, classes, size=(n, 1)).astype(np.int32)


def _zoo_main(a, dev) -> int:
    """``--model <zoo app>``: the app's model through ``FFModel.fit``."""
    name = a.model
    if name == "cnn":
        name = a.arch or "alexnet"
    elif name == "dlrm" and a.arch:
        name = a.arch
    spec = ZOO[name]
    batch = a.batch or spec["batch"]
    epochs = a.epochs or spec["epochs"]
    kw = dict(size=a.size, classes=a.classes or 10, embedding_size=a.embedding_size,
              num_tables=a.num_tables, sparse_feature_size=a.sparse_feature_size,
              bag_size=a.bag_size, fused=a.fused)
    data = None
    if a.data:
        if name not in ("dlrm", "xdl"):
            raise SystemExit(f"--data: a Criteo-format file feeds dlrm or xdl, not {name}")
        xs, y = load_criteo(a.data, vocab_sizes=a.embedding_size)
        kw.update(num_tables=len(xs) - 1, bag_size=xs[0].shape[1], dense_dim=xs[-1].shape[1])
        data = (xs if name == "dlrm" else xs[:-1], y)
    model = build_zoo(name, batch=batch, device=dev, compute_dtype=a.compute_dtype, lr=a.lr,
                      **kw)
    n = a.samples or spec["samples"](batch)
    xs, y = data or make_zoo_data(name, model, n)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    ex = model.executor
    t0 = time.perf_counter()
    pm = model.fit(xs, y, batch_size=batch, epochs=epochs, verbose=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rows = max(1, pm.train_all)
    rec = {"model": name, "batch": batch, "epochs": epochs, "samples": len(y),
           "loss_type": spec["loss"].value, "compute_dtype": a.compute_dtype,
           "steps": ex._step_count, "fit_s": wall,
           "step_ms_mean": wall / max(1, ex._step_count) * 1e3,
           "samples_per_s": ex._step_count * batch / wall if wall > 0 else 0.0,
           "last_epoch": {"samples": pm.train_all, "accuracy": pm.accuracy,
                          "sparse_cce": pm.sparse_cce_loss / rows, "mse": pm.mse_loss / rows},
           "host_syncs": ex.host_syncs, "parameters": model.num_parameters(),
           "state_tensors": sum(len(ws) for ws in ex.state.values()),
           "flash_launches": dict(fa.LAUNCHES), "device": str(dev),
           "device_name": _device_name(dev)}
    if a.data:
        rec["data"] = a.data
    print(json.dumps(rec), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m flexflow_tpu_torch --train")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--model", choices=("bert", "gpt2", "cnn") + tuple(ZOO), default="bert")
    p.add_argument("--arch", choices=tuple(_CNN) + ("dlrm", "xdl"),
                   help="--model cnn: which CNN; --model dlrm: dlrm or xdl")
    p.add_argument("--fit", action="store_true",
                   help="the encoder on tokens through FFModel.fit and eval")
    p.add_argument("--hidden", type=int, help="override the model's width")
    p.add_argument("--heads", type=int)
    p.add_argument("--ff-dim", type=int)
    p.add_argument("--layers", type=int)
    p.add_argument("--vocab", type=int, help="tokens: 30522 (--fit) or 50257 (gpt2)")
    p.add_argument("--batch", type=int, help="16, or 4 for gpt2")
    p.add_argument("--seq", type=int, help="512, or 1024 for gpt2")
    p.add_argument("--classes", type=int, help="64 (bert), 10 (the zoo)")
    p.add_argument("--steps", type=int, help="5, or 3 for gpt2")
    p.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--epochs", type=int, help="--fit: 2; the zoo: the example's")
    p.add_argument("--samples", type=int, help="--fit: 160; the zoo: the example's")
    p.add_argument("--eval-samples", type=int, default=40)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-path")
    p.add_argument("--resume")
    p.add_argument("--fault-plan")
    p.add_argument("--profiling", action="store_true",
                   help="--fit: flush the metrics after every step (K = 1)")
    p.add_argument("--health", choices=("off", "warn", "dump", "raise", "restore"),
                   default="off", help="--fit: the run-health monitor is not ported; "
                   "any mode but off raises NotImplementedError")
    p.add_argument("--generate", type=int, default=0, help="gpt2: greedy tokens after training")
    p.add_argument("--lr", type=float, help="the zoo: SGD's learning rate (the example's)")
    p.add_argument("--size", type=int, default=128, help="the CNNs: image height and width")
    p.add_argument("--embedding-size", type=int, default=65536, help="dlrm/xdl: rows a table")
    p.add_argument("--num-tables", type=int, default=4)
    p.add_argument("--sparse-feature-size", type=int, default=64)
    p.add_argument("--bag-size", type=int, default=1)
    p.add_argument("--data", help="dlrm/xdl: a local Criteo-format file (.tsv, .npz, .h5)")
    p.add_argument("--fused", action="store_true", help="moe, moe_encoder: the experts op")
    a = p.parse_args(argv)

    dev = resolve_device(a.device)
    if a.model not in ("bert", "gpt2"):
        return _zoo_main(a, dev)
    a.classes = a.classes or 64
    a.epochs, a.samples = a.epochs or 2, a.samples or 160
    if a.model == "gpt2":
        if a.steps is None:
            a.steps = 3
        return _gpt_main(a, dev)
    a.batch, a.seq = a.batch or 16, a.seq or 512
    if a.fit:
        return _fit_main(a, dev)
    steps = 5 if a.steps is None else a.steps
    cfg = _widths(a, BERT_BASE)
    model = build_model(batch=a.batch, seq=a.seq, num_classes=a.classes,
                        compute_dtype=a.compute_dtype, lr=LR, use_flash=True, seed=SEED,
                        device=dev, **cfg)
    x, y = make_batch(a.batch, a.seq, cfg["hidden"], a.classes, SEED)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    res = run(model, x, y, steps)
    print(json.dumps({
        **cfg, "batch": a.batch, "seq": a.seq, "classes": a.classes,
        "compute_dtype": a.compute_dtype, "steps": steps,
        **res, "parameters": model.num_parameters(), "flash_launches": dict(fa.LAUNCHES),
        "device": str(dev), "device_name": _device_name(dev),
    }), flush=True)
    return 0
