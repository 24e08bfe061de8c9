"""The residual ``add``.

Counterpart of ``flexflow_tpu/ops/elementwise.py`` ``ElementBinary`` for
the one elementwise op the encoder and decoder build; it broadcasts like
numpy (``gpt_decoder``'s ``embed_add`` adds a (seq, hidden) position
table to (batch, seq, hidden) token rows; autograd sums the table's
gradient over the batch).
"""

from __future__ import annotations

from typing import List

import torch

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["ElementBinary"]


class ElementBinary(OpDef):
    op_type = OperatorType.EW_ADD

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        a, b = layer.inputs[0], layer.inputs[1]
        return [(tuple(torch.broadcast_shapes(a.shape, b.shape)), a.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [torch.add(inputs[0], inputs[1])]


register_op(ElementBinary())
