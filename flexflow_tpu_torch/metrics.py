"""Training metrics: accuracy, the cross-entropies, MSE, RMSE and MAE.

Counterpart of ``flexflow_tpu/metrics.py``.  ``Metrics.compute`` gives
device tensors computed from the final op's output (the softmax
probabilities for the cross-entropies) as the JAX package computes them,
and nothing is fetched to the host.  Accuracy compares the output's
argmax with the integer label under sparse categorical cross-entropy,
and with the label's argmax (one-hot labels) under any other loss.

:class:`PerfMetrics` is the host accumulator of an epoch (or an eval
pass), with the JAX fields and rounding.  :class:`DeviceMetricAccumulator`
keeps ``sum(metric * rows)`` on the device across a window of steps, so
the fit loop reads the host only at its K-step flushes: ``drain()``
stacks the window's sums into one tensor and copies it once, the one
host sync of the window (the caller counts it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.fftype import LossType, MetricsType
from flexflow_tpu_torch.loss import categorical_crossentropy, sparse_categorical_crossentropy

__all__ = ["Metrics", "PerfMetrics", "DeviceMetricAccumulator"]


@dataclasses.dataclass
class PerfMetrics:
    """Host-side accumulator: samples seen, correct predictions, and
    row-weighted loss sums."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    start_time: float = dataclasses.field(default_factory=time.time)

    def update(self, batch_metrics: Dict[str, float], batch_size: int) -> None:
        """Fold one step's per-row means, weighted by ``batch_size``."""
        self.merge_sums({k: v * batch_size for k, v in batch_metrics.items()}, batch_size)

    def merge_sums(self, sums: Dict[str, float], count: int) -> None:
        """Fold a drained window: ``sums`` holds ``sum(metric * rows)``,
        ``count`` the rows; the correct count is rounded once here."""
        self.train_all += count
        if "accuracy" in sums:
            self.train_correct += int(sums["accuracy"] + 0.5)
        self.cce_loss += sums.get("categorical_crossentropy", 0.0)
        self.sparse_cce_loss += sums.get("sparse_categorical_crossentropy", 0.0)
        self.mse_loss += sums.get("mean_squared_error", 0.0)
        self.rmse_loss += sums.get("root_mean_squared_error", 0.0)
        self.mae_loss += sums.get("mean_absolute_error", 0.0)

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)

    def throughput(self) -> float:
        """Samples per second since construction."""
        dt = time.time() - self.start_time
        return self.train_all / dt if dt > 0 else 0.0


class DeviceMetricAccumulator:
    """On-device ``sum(metric * rows)`` across a window of steps.
    ``add`` queues float32 multiply-adds and returns; ``drain`` is the one
    host sync (one device-to-host copy of every sum) and resets.  Rows
    may differ per call (``eval``'s tail batch passes its real rows)."""

    def __init__(self) -> None:
        self._sums: Optional[Dict[str, torch.Tensor]] = None
        self._count = 0

    def add(self, metrics: Dict[str, torch.Tensor], rows: int) -> None:
        self._count += rows
        if not metrics:
            return
        w = float(rows)
        if self._sums is None:
            self._sums = {k: v.detach().float() * w for k, v in metrics.items()}
            return
        for k, v in metrics.items():
            self._sums[k].add_(v.detach().float(), alpha=w)

    @property
    def count(self) -> int:
        """Rows accumulated since the last drain (no device access)."""
        return self._count

    def drain(self) -> Tuple[Dict[str, float], int]:
        """The window's ``(sums, rows)`` on the host; resets the window."""
        sums: Dict[str, float] = {}
        if self._sums:
            keys = list(self._sums)
            vals = torch.stack([self._sums[k].reshape(()) for k in keys]).cpu().tolist()
            sums = dict(zip(keys, vals))
        count = self._count
        self._sums = None
        self._count = 0
        return sums, count


class Metrics:
    def __init__(self, loss_type: LossType, metrics: Sequence[MetricsType]) -> None:
        self.loss_type = loss_type
        self.metrics = list(metrics)

    @torch.no_grad()
    def compute(self, probs: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        sparse = self.loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY
        for m in self.metrics:
            if m is MetricsType.ACCURACY:
                lab = (labels.reshape(labels.shape[0]).long() if sparse
                       else torch.argmax(labels, dim=-1))
                pred = torch.argmax(probs, dim=-1)
                out["accuracy"] = (pred == lab).float().mean()
            elif m is MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
                out["sparse_categorical_crossentropy"] = sparse_categorical_crossentropy(
                    probs, labels)
            elif m is MetricsType.CATEGORICAL_CROSSENTROPY:
                out["categorical_crossentropy"] = categorical_crossentropy(probs, labels)
            elif m is MetricsType.MEAN_SQUARED_ERROR:
                out["mean_squared_error"] = torch.mean(
                    torch.sum(torch.square(probs - labels), dim=-1))
            elif m is MetricsType.ROOT_MEAN_SQUARED_ERROR:
                out["root_mean_squared_error"] = torch.sqrt(
                    torch.mean(torch.sum(torch.square(probs - labels), dim=-1)))
            elif m is MetricsType.MEAN_ABSOLUTE_ERROR:
                out["mean_absolute_error"] = torch.mean(
                    torch.sum(torch.abs(probs - labels), dim=-1))
        return out
