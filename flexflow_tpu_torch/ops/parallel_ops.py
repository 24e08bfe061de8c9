"""``WeightOp``: a free tensor with no producing layer.

Counterpart of ``flexflow_tpu/ops/parallel_ops.py`` ``WeightOp``
(``FFModel.parameter``; ``gpt_decoder`` builds its learned position table
``pos_embed`` with it).  The weight is ``value`` with the layer's
``shape``.  A float weight is a parameter unless ``trainable=False``,
Glorot uniform by default; an integer or bool weight (a mask, an index
table) is never trainable and starts at zero.  A weight that is not
trainable is executor state: it takes no gradient and no optimizer slot,
and rides ``get_weights``, ``set_weights`` and checkpoints as the
parameters do.

The rest of the JAX file (repartition, combine, replicate, reduction) is
mesh parallelism, ROADMAP.md queue A item 5.
"""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.initializer import ZeroInitializer, default_kernel_initializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["WeightOp"]


class WeightOp(OpDef):
    """attrs: shape, dtype, optional initializer and trainable."""

    op_type = OperatorType.WEIGHT

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        return [(tuple(layer.attrs["shape"]), layer.attrs["dtype"])]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        dt = layer.attrs["dtype"]
        is_float = dt.value.startswith("float") or dt.value == "bfloat16"
        init = layer.attrs.get("initializer") or (
            default_kernel_initializer() if is_float else ZeroInitializer())
        return [WeightSpec("value", tuple(layer.attrs["shape"]), dt, init,
                           trainable=bool(layer.attrs.get("trainable", True)) and is_float)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [params["value"]]


register_op(WeightOp())
