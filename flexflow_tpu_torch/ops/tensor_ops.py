"""Reshape and the mean reduction.

Counterpart of ``flexflow_tpu/ops/tensor_ops.py`` ``Reshape`` and
``Reduce`` (the encoder's pooled head is a ``reduce_mean`` over the
sequence; its LM head flattens with a ``reshape``).
"""

from __future__ import annotations

import math
from typing import List

import torch

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["Reshape", "Reduce"]


class Reshape(OpDef):
    op_type = OperatorType.RESHAPE

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        shape = tuple(layer.attrs["shape"])
        if math.prod(shape) != math.prod(t.shape):
            raise ValueError(f"reshape {t.shape} -> {shape}: sizes differ")
        return [(shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        x = inputs[0]
        shape = tuple(layer.attrs["shape"])
        built = layer.inputs[0].shape[0]
        if x.shape[0] != built and shape and shape[0] == built:
            # the declared shape baked the build-time batch; a smaller
            # runtime batch keeps dim 0 and reshapes the rest
            shape = (x.shape[0],) + shape[1:]
        return [x.reshape(shape)]


class Reduce(OpDef):
    op_type = OperatorType.REDUCE_MEAN

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        axes = tuple(a % t.ndim for a in layer.attrs["axes"])
        if layer.attrs.get("keepdims", False):
            shape = tuple(1 if i in axes else s for i, s in enumerate(t.shape))
        else:
            shape = tuple(s for i, s in enumerate(t.shape) if i not in axes)
        return [(shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [torch.mean(inputs[0], dim=tuple(layer.attrs["axes"]),
                           keepdim=layer.attrs.get("keepdims", False))]


register_op(Reshape())
register_op(Reduce())
