"""Symbolic tensors and layers: the graph the ``FFModel`` builder records.

Counterpart of ``flexflow_tpu/tensor.py``.  A :class:`Tensor` is a typed
handle (shape, dtype, producing layer) and owns no memory; the arrays
exist only while the executor runs a step.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

from flexflow_tpu_torch.fftype import DataType, LayerID, OperatorType

__all__ = ["Tensor", "Layer"]

_tensor_guid = itertools.count(1)


class Tensor:
    """Symbolic tensor; dim 0 is the batch dim by convention."""

    def __init__(
        self,
        shape: Tuple[int, ...],
        dtype: DataType = DataType.FLOAT,
        owner_layer: Optional["Layer"] = None,
        owner_idx: int = 0,
        name: Optional[str] = None,
    ) -> None:
        self.guid: int = next(_tensor_guid)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.name = name or f"tensor_{self.guid}"

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        own = self.owner_layer.name if self.owner_layer else "input"
        return f"Tensor({self.name}, {self.shape}, {self.dtype.value}, from={own})"


class Layer:
    """One node of the graph; ``attrs`` holds the op's parameters."""

    def __init__(
        self,
        op_type: OperatorType,
        name: str,
        inputs: List[Tensor],
        attrs: Dict[str, Any],
    ) -> None:
        self.layer_guid = LayerID()
        self.op_type = op_type
        self.name = name
        self.inputs = list(inputs)
        self.attrs = dict(attrs)
        self.outputs: List[Tensor] = []

    def __repr__(self) -> str:
        return f"Layer({self.op_type.value}:{self.name})"
