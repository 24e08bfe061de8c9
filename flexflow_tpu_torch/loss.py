"""Loss functions.

Counterpart of ``flexflow_tpu/loss.py``, computed as the JAX package
computes them.  The cross-entropies take the softmax output, as the
reference does (the final Softmax op is part of the graph):
``-mean(log(max(p_label, 1e-12)))`` for integer labels and
``-mean(sum(labels * log(max(p, 1e-12))))`` for one-hot or soft ones;
they are not ``F.cross_entropy`` on logits, which would round
differently.  MSE sums the squares over the last dim and averages over
the batch (``avg``), or sums everything and divides by the batch
(``sum``); ``identity`` is the mean of the output.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.fftype import LossType

__all__ = ["sparse_categorical_crossentropy", "categorical_crossentropy",
           "mean_squared_error_avg", "mean_squared_error_sum", "identity_loss", "get_loss_fn"]


def sparse_categorical_crossentropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """probs: (batch, classes) post-softmax; labels: int (batch,) or (batch, 1)."""
    labels = labels.reshape(labels.shape[0]).long()
    p = probs.gather(-1, labels[:, None])[:, 0]
    return -torch.mean(torch.log(p.clamp_min(1e-12)))


def categorical_crossentropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(labels * torch.log(probs.clamp_min(1e-12)), dim=-1))


def mean_squared_error_avg(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(torch.square(pred - labels), dim=-1))


def mean_squared_error_sum(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(pred - labels)) / pred.shape[0]


def identity_loss(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The output is the loss: its gradient is ones / numel."""
    return torch.mean(pred)


_LOSS_FNS = {
    LossType.SPARSE_CATEGORICAL_CROSSENTROPY: sparse_categorical_crossentropy,
    LossType.CATEGORICAL_CROSSENTROPY: categorical_crossentropy,
    LossType.MEAN_SQUARED_ERROR_AVG_REDUCE: mean_squared_error_avg,
    LossType.MEAN_SQUARED_ERROR_SUM_REDUCE: mean_squared_error_sum,
    LossType.IDENTITY: identity_loss,
}


def get_loss_fn(loss_type: LossType):
    return _LOSS_FNS[loss_type]
