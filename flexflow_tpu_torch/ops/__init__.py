"""Operator library: importing it registers every OpDef."""

from flexflow_tpu_torch.ops import attention, dense, elementwise, norm, tensor_ops  # noqa: F401
from flexflow_tpu_torch.ops.base import OpContext, OpDef, WeightSpec, all_ops, get_op_def

__all__ = ["OpContext", "OpDef", "WeightSpec", "all_ops", "get_op_def"]
