"""Elementwise unary, binary and scalar ops, and ``Cast``.

Counterpart of ``flexflow_tpu/ops/elementwise.py``: the same op kinds,
each one PyTorch call.  Binary ops broadcast like numpy (``gpt_decoder``'s
``embed_add`` adds a (seq, hidden) position table to (batch, seq,
hidden) token rows; autograd sums the table's gradient over the batch).
``gelu`` is ``jax.nn.gelu``'s default, the tanh approximation, and
``elu`` has alpha 1, as in the JAX ops.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["ElementUnary", "ElementBinary", "Cast"]

_UNARY_FNS = {
    OperatorType.RELU: lambda x, a: torch.relu(x),
    OperatorType.SIGMOID: lambda x, a: torch.sigmoid(x),
    OperatorType.TANH: lambda x, a: torch.tanh(x),
    OperatorType.ELU: lambda x, a: F.elu(x),
    OperatorType.GELU: lambda x, a: F.gelu(x, approximate="tanh"),
    OperatorType.EXP: lambda x, a: torch.exp(x),
    OperatorType.SIN: lambda x, a: torch.sin(x),
    OperatorType.COS: lambda x, a: torch.cos(x),
    OperatorType.RSQRT: lambda x, a: torch.rsqrt(x),
    OperatorType.IDENTITY: lambda x, a: x,
    OperatorType.POW: lambda x, a: torch.pow(x, a["exponent"]),
    OperatorType.SCALAR_MULTIPLY: lambda x, a: x * a["scalar"],
    OperatorType.SCALAR_ADD: lambda x, a: x + a["scalar"],
    OperatorType.SCALAR_SUB: lambda x, a: x - a["scalar"],
    OperatorType.SCALAR_TRUE_DIV: lambda x, a: x / a["scalar"],
}

_BINARY_FNS = {
    OperatorType.EW_ADD: torch.add,
    OperatorType.EW_SUB: torch.sub,
    OperatorType.EW_MUL: torch.mul,
    OperatorType.EW_DIV: torch.div,
    OperatorType.EW_MAX: torch.maximum,
    OperatorType.EW_MIN: torch.minimum,
}


class ElementUnary(OpDef):
    def __init__(self, op_type: OperatorType) -> None:
        self.op_type = op_type

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [_UNARY_FNS[self.op_type](inputs[0], layer.attrs)]


class ElementBinary(OpDef):
    def __init__(self, op_type: OperatorType) -> None:
        self.op_type = op_type

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        a, b = layer.inputs[0], layer.inputs[1]
        return [(tuple(torch.broadcast_shapes(a.shape, b.shape)), a.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [_BINARY_FNS[self.op_type](inputs[0], inputs[1])]


class Cast(OpDef):
    op_type = OperatorType.CAST

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        return [(layer.inputs[0].shape, layer.attrs["dtype"])]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [inputs[0].to(layer.attrs["dtype"].to_torch())]


for _t in _UNARY_FNS:
    register_op(ElementUnary(_t))
for _t in _BINARY_FNS:
    register_op(ElementBinary(_t))
register_op(Cast())
