"""Training metrics (accuracy and sparse categorical cross-entropy).

Counterpart of ``flexflow_tpu/metrics.py`` ``Metrics.compute``: the
values are device tensors computed from the final op's output (the
softmax probabilities), and nothing is fetched to the host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from flexflow_tpu_torch.fftype import LossType, MetricsType
from flexflow_tpu_torch.loss import sparse_categorical_crossentropy

__all__ = ["Metrics"]


class Metrics:
    def __init__(self, loss_type: LossType, metrics: Sequence[MetricsType]) -> None:
        self.loss_type = loss_type
        self.metrics = list(metrics)
        for m in self.metrics:
            if m not in (MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY):
                raise NotImplementedError(f"metric {m.value} is not ported")
        if MetricsType.ACCURACY in self.metrics and (
                loss_type is not LossType.SPARSE_CATEGORICAL_CROSSENTROPY):
            raise NotImplementedError("accuracy is ported for sparse labels only")

    @torch.no_grad()
    def compute(self, probs: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for m in self.metrics:
            if m is MetricsType.ACCURACY:
                lab = labels.reshape(labels.shape[0]).long()
                pred = torch.argmax(probs, dim=-1)
                out["accuracy"] = (pred == lab).float().mean()
            elif m is MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
                out["sparse_categorical_crossentropy"] = sparse_categorical_crossentropy(
                    probs, labels)
        return out
