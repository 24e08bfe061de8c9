"""MLP builder (the reference's ``mnist_mlp`` app).

Counterpart of ``flexflow_tpu/models/mlp.py``.
"""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.fftype import ActiMode
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.tensor import Tensor

__all__ = ["mlp"]


def mlp(model: FFModel, batch: int, in_dim: int, hidden_dims: Sequence[int], num_classes: int,
        activation: ActiMode = ActiMode.RELU) -> Tensor:
    """Dense stack over (batch, in_dim) features, softmax over classes."""
    t = model.create_tensor((batch, in_dim))
    for h in hidden_dims:
        t = model.dense(t, h, activation)
    t = model.dense(t, num_classes)
    return model.softmax(t)
