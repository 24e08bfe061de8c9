"""Linear (dense) layer and BatchMatmul.

Counterpart of ``flexflow_tpu/ops/dense.py``.  ``Linear``'s weight is
``kernel`` in the ``(in, out)`` layout, applied as ``x @ kernel``, with
an optional ``bias`` and a fused activation.  GELU is ``jax.nn.gelu``'s
default, the tanh approximation.  ``BatchMatmul`` is ``a[b] @ b[b]``;
its ``a_seq_length_dim`` / ``b_seq_length_dim`` attributes are kept, and
as in the JAX op they mask only under an iteration ``seq_length``, which
the port's ``eval_batch`` does not take (incremental decoding is
ROADMAP.md queue A item 3, part 3).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.fftype import ActiMode, OperatorType
from flexflow_tpu_torch.initializer import default_bias_initializer, default_kernel_initializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["apply_activation", "Linear", "BatchMatmul"]


def apply_activation(x: torch.Tensor, act: ActiMode) -> torch.Tensor:
    if act is ActiMode.NONE:
        return x
    if act is ActiMode.RELU:
        return torch.relu(x)
    if act is ActiMode.SIGMOID:
        return torch.sigmoid(x)
    if act is ActiMode.TANH:
        return torch.tanh(x)
    if act is ActiMode.GELU:
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


class Linear(OpDef):
    op_type = OperatorType.LINEAR

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape[:-1] + (layer.attrs["out_dim"],), t.dtype)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        t = layer.inputs[0]
        out_dim = layer.attrs["out_dim"]
        ws = [WeightSpec("kernel", (t.shape[-1], out_dim), t.dtype,
                         layer.attrs.get("kernel_initializer") or default_kernel_initializer())]
        if layer.attrs.get("use_bias", True):
            ws.append(WeightSpec("bias", (out_dim,), t.dtype,
                                 layer.attrs.get("bias_initializer") or default_bias_initializer()))
        return ws

    def forward(self, layer, params, inputs, ctx: OpContext):
        y = torch.matmul(inputs[0], params["kernel"])
        if "bias" in params:
            y = y + params["bias"]
        return [apply_activation(y, layer.attrs.get("activation", ActiMode.NONE))]


class BatchMatmul(OpDef):
    op_type = OperatorType.BATCHMATMUL

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        a, b = layer.inputs
        if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
            raise ValueError(f"batch_matmul: {a.shape} @ {b.shape}")
        return [(a.shape[:-1] + (b.shape[-1],), a.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [torch.matmul(inputs[0], inputs[1])]


register_op(Linear())
register_op(BatchMatmul())
