"""Operator library: importing it registers every OpDef."""

from flexflow_tpu_torch.ops import (  # noqa: F401
    attention, conv, dense, elementwise, embedding, moe, norm, parallel_ops, tensor_ops,
)
from flexflow_tpu_torch.ops.base import OpContext, OpDef, WeightSpec, all_ops, get_op_def

__all__ = ["OpContext", "OpDef", "WeightSpec", "all_ops", "get_op_def"]
