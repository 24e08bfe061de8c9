"""Embedding and Gather.

Counterpart of ``flexflow_tpu/ops/embedding.py``.  The weight is
``kernel`` of shape ``(num_entries, out_dim)`` (default initializer
normal(0, 0.05)).  Ids outside ``[0, num_entries)`` clamp to the boundary
row, as the JAX op's ``jnp.take(mode="clip")`` does, and their gradient
lands on that row: the ids are clamped before ``F.embedding``, which on
CUDA would hit a device-side assert on an out-of-range id.  The gradient
of ``F.embedding`` sums repeated ids without atomics, so a train step
that runs it is deterministic on the card.

The vocab-sharded path of the JAX op (a table split over a mesh axis,
masked local gathers and one ``psum``) needs more than one device and
is not ported (ROADMAP.md queue A item 5).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.fftype import AggrMode, DataType, OperatorType
from flexflow_tpu_torch.initializer import NormInitializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["Embedding", "Gather"]


class Embedding(OpDef):
    """Input: int ids ``(batch, bag)``; output ``(batch, out_dim)`` under
    SUM / AVG, ``(batch, bag, out_dim)`` under NONE."""

    op_type = OperatorType.EMBEDDING

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        a = layer.attrs
        dt = a.get("dtype", DataType.FLOAT)
        if a.get("aggr", AggrMode.NONE) is AggrMode.NONE:
            return [(t.shape + (a["out_dim"],), dt)]
        return [(t.shape[:-1] + (a["out_dim"],), dt)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        a = layer.attrs
        return [WeightSpec("kernel", (a["num_entries"], a["out_dim"]),
                           a.get("dtype", DataType.FLOAT),
                           a.get("kernel_initializer") or NormInitializer())]

    def forward(self, layer, params, inputs, ctx: OpContext):
        table = params["kernel"]
        rows = F.embedding(inputs[0].long().clamp(0, table.shape[0] - 1), table)
        aggr = layer.attrs.get("aggr", AggrMode.NONE)
        if aggr is AggrMode.SUM:
            return [rows.sum(dim=-2)]
        if aggr is AggrMode.AVG:
            return [rows.mean(dim=-2)]
        return [rows]


class Gather(OpDef):
    """``torch.gather`` along ``dim`` (attr, default 0): output has the
    index's shape."""

    op_type = OperatorType.GATHER

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        data, index = layer.inputs
        return [(index.shape, data.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        data, index = inputs
        return [torch.gather(data, layer.attrs.get("dim", 0), index.long())]


register_op(Embedding())
register_op(Gather())
