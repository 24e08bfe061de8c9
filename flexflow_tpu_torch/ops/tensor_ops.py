"""Shape and manipulation ops: Concat, Split, Reshape, Transpose,
Reverse, Reduce (sum and mean), TopK, NoOp and Cache.

Counterpart of ``flexflow_tpu/ops/tensor_ops.py``, each op one PyTorch
call.  ``TopK`` breaks ties as ``lax.top_k`` does, the lower index
first: it takes the first ``k`` of a stable descending sort, since
``torch.topk`` on CUDA promises no order among equal values.  ``Cache``
keeps the last training batch of its input as state (weight ``cached``).
"""

from __future__ import annotations

import math
from typing import List

import torch

from flexflow_tpu_torch.fftype import DataType, OperatorType
from flexflow_tpu_torch.initializer import ZeroInitializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["Concat", "Split", "Reshape", "Transpose", "Reverse", "Reduce", "TopK", "NoOp",
           "Cache"]


class Concat(OpDef):
    op_type = OperatorType.CONCAT

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        axis = layer.attrs["axis"]
        base = list(layer.inputs[0].shape)
        base[axis] = sum(t.shape[axis] for t in layer.inputs)
        return [(tuple(base), layer.inputs[0].dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [torch.cat(list(inputs), dim=layer.attrs["axis"])]


class Split(OpDef):
    op_type = OperatorType.SPLIT

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        axis, sizes = layer.attrs["axis"], layer.attrs["sizes"]
        if sum(sizes) != t.shape[axis]:
            raise ValueError(f"split: sizes {sizes} do not sum to dim {axis} of {t.shape}")
        outs = []
        for s in sizes:
            shape = list(t.shape)
            shape[axis] = s
            outs.append((tuple(shape), t.dtype))
        return outs

    def forward(self, layer, params, inputs, ctx: OpContext):
        return list(torch.split(inputs[0], list(layer.attrs["sizes"]), dim=layer.attrs["axis"]))


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


class Transpose(OpDef):
    op_type = OperatorType.TRANSPOSE

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(tuple(t.shape[p] for p in layer.attrs["perm"]), t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [inputs[0].permute(tuple(layer.attrs["perm"]))]


class Reverse(OpDef):
    op_type = OperatorType.REVERSE

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [torch.flip(inputs[0], dims=(layer.attrs["axis"],))]


class Reduce(OpDef):
    def __init__(self, op_type: OperatorType) -> None:
        self.op_type = op_type

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        axes = tuple(a % t.ndim for a in layer.attrs["axes"])
        if layer.attrs.get("keepdims", False):
            shape = tuple(1 if i in axes else s for i, s in enumerate(t.shape))
        else:
            shape = tuple(s for i, s in enumerate(t.shape) if i not in axes)
        return [(shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        fn = torch.sum if self.op_type is OperatorType.REDUCE_SUM else torch.mean
        return [fn(inputs[0], dim=tuple(layer.attrs["axes"]),
                   keepdim=layer.attrs.get("keepdims", False))]


class TopK(OpDef):
    """(values, int32 indices) of the ``k`` largest along the last dim,
    largest first, equal values in index order."""

    op_type = OperatorType.TOPK

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        shape = t.shape[:-1] + (layer.attrs["k"],)
        return [(shape, t.dtype), (shape, DataType.INT32)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        k = layer.attrs["k"]
        v, i = torch.sort(inputs[0], dim=-1, descending=True, stable=True)
        return [v[..., :k], i[..., :k].to(torch.int32)]


class NoOp(OpDef):
    op_type = OperatorType.NOOP

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [inputs[0]]


class Cache(OpDef):
    """Passes its input through and keeps the last training batch of it
    as state."""

    op_type = OperatorType.CACHE

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        t = layer.inputs[0]
        return [WeightSpec("cached", t.shape, t.dtype, ZeroInitializer(), trainable=False)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [inputs[0]]

    def state_update(self, layer, params, inputs):
        return {"cached": inputs[0]}


register_op(Concat())
register_op(Split())
register_op(Reshape())
register_op(Transpose())
register_op(Reverse())
register_op(Reduce(OperatorType.REDUCE_SUM))
register_op(Reduce(OperatorType.REDUCE_MEAN))
register_op(TopK())
register_op(NoOp())
register_op(Cache())
