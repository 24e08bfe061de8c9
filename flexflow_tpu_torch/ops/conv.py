"""Conv2D, Pool2D, BatchNorm, Flat.

Counterpart of ``flexflow_tpu/ops/conv.py``.  The graph is NCHW, as in
the JAX package's builder API.  ``Conv2D`` stores its weight ``kernel``
in the JAX layout, HWIO ``(kh, kw, c_in / groups, out)``, so JAX weights
load as they are, and permutes it to PyTorch's OIHW at use; ``groups``
is ResNeXt's grouped convolution.  Pooling keeps the JAX semantics:
max pooling pads with -inf, average pooling divides by ``kh * kw``
whatever the padding (``count_include_pad=True``).

``BatchNorm`` normalises each channel over (N, H, W) with the batch's
biased variance in training and with the running stats in eval; the
fused ``relu`` defaults to on.  The running stats are executor state
(non-trainable weights ``running_mean`` and ``running_var``) that
:meth:`BatchNorm.state_update` moves at momentum 0.1 with the same
biased batch variance: ``F.batch_norm`` would move ``running_var`` with
the unbiased one, so it is not used.

The JAX package convolves with ``lax.conv_general_dilated`` and pools
with ``lax.reduce_window``, not in a Pallas kernel; here they are
``F.conv2d`` and ``F.max_pool2d`` / ``F.avg_pool2d``.  On the card the
executor turns TF32 off for cuDNN as for matmuls, so a float32
convolution is computed in float32.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.fftype import ActiMode, OperatorType, PoolType
from flexflow_tpu_torch.initializer import (
    OnesInitializer, ZeroInitializer, default_bias_initializer, default_kernel_initializer,
)
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.ops.dense import apply_activation
from flexflow_tpu_torch.tensor import Layer

__all__ = ["Conv2D", "Pool2D", "BatchNorm", "Flat"]


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def _window_out(layer: Layer, channels: int) -> ShapeDtype:
    t = layer.inputs[0]
    n, _, h, w = t.shape
    a = layer.attrs
    return ((n, channels, _conv_out(h, a["kernel_h"], a["stride_h"], a["padding_h"]),
             _conv_out(w, a["kernel_w"], a["stride_w"], a["padding_w"])), t.dtype)


class Conv2D(OpDef):
    op_type = OperatorType.CONV2D

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        return [_window_out(layer, layer.attrs["out_channels"])]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        t = layer.inputs[0]
        a = layer.attrs
        c_in = t.shape[1] // a.get("groups", 1)
        ws = [WeightSpec("kernel", (a["kernel_h"], a["kernel_w"], c_in, a["out_channels"]),
                         t.dtype, a.get("kernel_initializer") or default_kernel_initializer())]
        if a.get("use_bias", True):
            ws.append(WeightSpec("bias", (a["out_channels"],), t.dtype,
                                 a.get("bias_initializer") or default_bias_initializer()))
        return ws

    def forward(self, layer, params, inputs, ctx: OpContext):
        a = layer.attrs
        y = F.conv2d(inputs[0], params["kernel"].permute(3, 2, 0, 1),
                     stride=(a["stride_h"], a["stride_w"]),
                     padding=(a["padding_h"], a["padding_w"]), groups=a.get("groups", 1))
        if "bias" in params:
            y = y + params["bias"].reshape(1, -1, 1, 1)
        return [apply_activation(y, a.get("activation", ActiMode.NONE))]


class Pool2D(OpDef):
    op_type = OperatorType.POOL2D

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        return [_window_out(layer, layer.inputs[0].shape[1])]

    def forward(self, layer, params, inputs, ctx: OpContext):
        a = layer.attrs
        kernel = (a["kernel_h"], a["kernel_w"])
        stride = (a["stride_h"], a["stride_w"])
        pad = (a["padding_h"], a["padding_w"])
        if a.get("pool_type", PoolType.MAX) is PoolType.MAX:
            y = F.max_pool2d(inputs[0], kernel, stride, pad)
        else:
            y = F.avg_pool2d(inputs[0], kernel, stride, pad, count_include_pad=True)
        return [apply_activation(y, a.get("activation", ActiMode.NONE))]


class BatchNorm(OpDef):
    op_type = OperatorType.BATCHNORM

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [(t.shape, t.dtype)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        c, dt = layer.inputs[0].shape[1], layer.inputs[0].dtype
        return [
            WeightSpec("scale", (c,), dt, OnesInitializer()),
            WeightSpec("bias", (c,), dt, ZeroInitializer()),
            WeightSpec("running_mean", (c,), dt, ZeroInitializer(), trainable=False),
            WeightSpec("running_var", (c,), dt, OnesInitializer(), trainable=False),
        ]

    @staticmethod
    def _batch_stats(x: torch.Tensor):
        return x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), correction=0)

    def forward(self, layer, params, inputs, ctx: OpContext):
        x = inputs[0]
        if ctx.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = params["running_mean"], params["running_var"]
        inv = torch.rsqrt(var + layer.attrs.get("eps", 1e-5)).reshape(1, -1, 1, 1)
        y = (x - mean.reshape(1, -1, 1, 1)) * inv
        y = y * params["scale"].reshape(1, -1, 1, 1) + params["bias"].reshape(1, -1, 1, 1)
        if layer.attrs.get("relu", True):
            y = torch.relu(y)
        return [y]

    def state_update(self, layer, params, inputs):
        """The running stats after this batch (momentum 0.1)."""
        m = layer.attrs.get("momentum", 0.1)
        mean, var = self._batch_stats(inputs[0])
        return {"running_mean": (1 - m) * params["running_mean"] + m * mean,
                "running_var": (1 - m) * params["running_var"] + m * var}


class Flat(OpDef):
    """(N, C, H, W) -> (N, C * H * W)."""

    op_type = OperatorType.FLAT

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        t = layer.inputs[0]
        return [((t.shape[0], math.prod(t.shape[1:])), t.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]


register_op(Conv2D())
register_op(Pool2D())
register_op(BatchNorm())
register_op(Flat())
