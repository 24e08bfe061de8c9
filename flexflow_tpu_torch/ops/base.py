"""Operator definition base and registry.

Counterpart of ``flexflow_tpu/ops/base.py``.  Each op is an
:class:`OpDef`: ``infer`` (output shapes and dtypes), ``weights`` (the
parameters and state it declares), ``forward`` (PyTorch on the layer's
inputs; autograd derives the backward, except where an op calls a
kernel with a backward of its own) and, for an op with state,
``state_update`` (the state's new values from a training step's
inputs).  :class:`OpContext` carries what a forward needs
besides its inputs: the training flag, the device, a ``torch.Generator``
on that device and a per-layer seed for kernels that hash their own
randomness.  It carries no mesh: the port runs on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.fftype import DataType, OperatorType
from flexflow_tpu_torch.initializer import Initializer
from flexflow_tpu_torch.tensor import Layer

__all__ = [
    "ShapeDtype", "WeightSpec", "OpContext", "OpDef", "register_op", "get_op_def", "all_ops",
]

ShapeDtype = Tuple[Tuple[int, ...], DataType]


@dataclasses.dataclass
class WeightSpec:
    """One weight an op declares: a parameter, or with ``trainable=False``
    executor state (BatchNorm's running stats, ``Cache``'s last batch),
    which takes no gradient and no optimizer slot and which the op's
    ``state_update`` rewrites in a training step."""

    name: str
    shape: Tuple[int, ...]
    dtype: DataType
    initializer: Initializer
    trainable: bool = True


class OpContext:
    """Per-call context handed to ``forward``.  ``seed`` is a host int
    that differs per layer and per step; :meth:`next_seed` derives the
    seeds of hash-based dropout from it without touching the device."""

    def __init__(
        self,
        training: bool,
        device: torch.device,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
    ) -> None:
        self.training = training
        self.device = device
        self.generator = generator
        self.seed = int(seed)
        self._counter = 0

    def next_seed(self) -> int:
        """A fresh int32-range seed (0 .. 2**31 - 2), as the JAX op draws
        ``randint(0, 2**31 - 1)`` for the flash kernel."""
        self._counter += 1
        return (self.seed * 0x9E3779B1 + self._counter * 0x85EBCA77) % (2**31 - 1)


class OpDef:
    op_type: OperatorType = OperatorType.NOOP

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        raise NotImplementedError

    def weights(self, layer: Layer) -> List[WeightSpec]:
        return []

    def forward(
        self,
        layer: Layer,
        params: Dict[str, torch.Tensor],
        inputs: Sequence[torch.Tensor],
        ctx: OpContext,
    ) -> List[torch.Tensor]:
        raise NotImplementedError


_REGISTRY: Dict[OperatorType, OpDef] = {}


def register_op(defn: OpDef) -> OpDef:
    _REGISTRY[defn.op_type] = defn
    return defn


def get_op_def(op_type: OperatorType) -> OpDef:
    if op_type not in _REGISTRY:
        raise KeyError(f"no OpDef registered for {op_type}")
    return _REGISTRY[op_type]


def all_ops() -> Dict[OperatorType, OpDef]:
    return dict(_REGISTRY)
