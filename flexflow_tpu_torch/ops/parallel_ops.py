"""``WeightOp``: a free trainable tensor with no producing layer.

Counterpart of ``flexflow_tpu/ops/parallel_ops.py`` ``WeightOp``
(``FFModel.parameter``; ``gpt_decoder`` builds its learned position table
``pos_embed`` with it).  The weight is ``value`` with the layer's
``shape``; its default initializer is Glorot uniform, as in the JAX op.
A non-trainable weight (``trainable=False``, or an integer dtype) would
be executor state, which the port does not have yet (it comes with
``batch_norm``), so it raises.

The rest of the JAX file (repartition, combine, replicate, reduction) is
mesh parallelism, ROADMAP.md queue A item 5.
"""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.initializer import default_kernel_initializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["WeightOp"]


class WeightOp(OpDef):
    """attrs: shape, dtype, optional initializer and trainable."""

    op_type = OperatorType.WEIGHT

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        dt = layer.attrs["dtype"]
        is_float = dt.value.startswith("float") or dt.value == "bfloat16"
        if not (layer.attrs.get("trainable", True) and is_float):
            raise NotImplementedError(
                f"parameter {layer.name!r}: a non-trainable weight is executor state, "
                f"which the port does not have yet (it comes with batch_norm, ROADMAP.md "
                f"queue A item 3)")
        return [(tuple(layer.attrs["shape"]), dt)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        init = layer.attrs.get("initializer") or default_kernel_initializer()
        return [WeightSpec("value", tuple(layer.attrs["shape"]), layer.attrs["dtype"], init)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        return [params["value"]]


register_op(WeightOp())
