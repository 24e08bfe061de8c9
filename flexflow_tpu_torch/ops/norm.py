"""LayerNorm, RMSNorm, Softmax, Dropout.

Counterpart of ``flexflow_tpu/ops/norm.py``.  LayerNorm normalises over
the layer's ``axes`` with the biased variance and ``eps`` (default
1e-5), then applies ``scale`` and ``bias`` (weights of the normalised
shape).  RMSNorm scales the last dim by ``rsqrt(mean(x^2) + eps)`` (eps
1e-6) and its weight ``scale``.  Dropout draws its mask from the context's ``torch.Generator``:
the same rate as the JAX op, not the same bits.
"""

from __future__ import annotations

from typing import List

import torch

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.initializer import OnesInitializer, ZeroInitializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["LayerNorm", "RMSNorm", "Softmax", "Dropout"]


class LayerNorm(OpDef):
    op_type = OperatorType.LAYERNORM

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        if not layer.attrs.get("elementwise_affine", True):
            return []
        t = layer.inputs[0]
        shape = tuple(t.shape[ax] for ax in layer.attrs["axes"])
        return [
            WeightSpec("scale", shape, t.dtype, OnesInitializer()),
            WeightSpec("bias", shape, t.dtype, ZeroInitializer()),
        ]

    def forward(self, layer, params, inputs, ctx: OpContext):
        x = inputs[0]
        axes = tuple(layer.attrs["axes"])
        eps = layer.attrs.get("eps", 1e-5)
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + eps)
        if "scale" in params:
            bshape = [x.shape[i] if i in axes else 1 for i in range(x.dim())]
            y = y * params["scale"].reshape(bshape) + params["bias"].reshape(bshape)
        return [y]


class RMSNorm(OpDef):
    op_type = OperatorType.RMS_NORM

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        t = layer.inputs[0]
        return [WeightSpec("scale", (t.shape[-1],), t.dtype, OnesInitializer())]

    def forward(self, layer, params, inputs, ctx: OpContext):
        x = inputs[0]
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return [x * torch.rsqrt(ms + layer.attrs.get("eps", 1e-6)) * params["scale"]]


class Softmax(OpDef):
    op_type = OperatorType.SOFTMAX

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [torch.softmax(inputs[0], dim=layer.attrs.get("dim", -1))]


class Dropout(OpDef):
    op_type = OperatorType.DROPOUT

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        x = inputs[0]
        rate = layer.attrs.get("rate", 0.5)
        if not ctx.training or rate == 0.0:
            return [x]
        keep = 1.0 - rate
        mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=ctx.generator)
        return [torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))]


register_op(LayerNorm())
register_op(RMSNorm())
register_op(Softmax())
register_op(Dropout())
