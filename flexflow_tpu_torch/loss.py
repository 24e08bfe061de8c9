"""Loss functions (sparse categorical cross-entropy).

Counterpart of ``flexflow_tpu/loss.py``.  The loss takes the softmax
output, as the reference does (the final Softmax op is part of the
graph), and is computed as the JAX package computes it:
``-mean(log(max(p_label, 1e-12)))``.  It is not ``F.cross_entropy`` on
logits, which would round differently.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.fftype import LossType

__all__ = ["sparse_categorical_crossentropy", "get_loss_fn"]


def sparse_categorical_crossentropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """probs: (batch, classes) post-softmax; labels: int (batch,) or (batch, 1)."""
    labels = labels.reshape(labels.shape[0]).long()
    p = probs.gather(-1, labels[:, None])[:, 0]
    return -torch.mean(torch.log(p.clamp_min(1e-12)))


_LOSS_FNS = {
    LossType.SPARSE_CATEGORICAL_CROSSENTROPY: sparse_categorical_crossentropy,
}


def get_loss_fn(loss_type: LossType):
    if loss_type not in _LOSS_FNS:
        raise NotImplementedError(f"loss {loss_type.value} is not ported")
    return _LOSS_FNS[loss_type]
