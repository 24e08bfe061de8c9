"""Core enums (the members the training slice uses).

Counterpart of ``flexflow_tpu/fftype.py``: the same names and values, so
graphs and strategy files mean the same thing in both packages.  Data
types map onto ``torch`` dtypes in place of ``jax.numpy`` ones.
"""

from __future__ import annotations

import enum
import itertools

import torch

__all__ = [
    "DataType", "ActiMode", "AggrMode", "LossType", "MetricsType", "OperatorType", "LayerID",
]


class DataType(enum.Enum):
    """``DT_*`` (the reference's ``ffconst.h:20-28``)."""

    BOOLEAN = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    def to_torch(self) -> torch.dtype:
        return getattr(torch, self.value)


class ActiMode(enum.Enum):
    NONE = "none"
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"


class AggrMode(enum.Enum):
    """Embedding aggregation over the bag axis."""

    NONE = "none"
    SUM = "sum"
    AVG = "avg"


class LossType(enum.Enum):
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
    MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum_reduce"
    IDENTITY = "identity"


class MetricsType(enum.Enum):
    ACCURACY = "accuracy"
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"


class OperatorType(enum.Enum):
    """The op kinds of the encoder and decoder train paths."""

    NOOP = "noop"
    WEIGHT = "weight"
    DROPOUT = "dropout"
    LINEAR = "linear"
    SOFTMAX = "softmax"
    LAYERNORM = "layer_norm"
    RESHAPE = "reshape"
    EW_ADD = "ew_add"
    REDUCE_MEAN = "reduce_mean"
    MULTIHEAD_ATTENTION = "multihead_attention"
    EMBEDDING = "embedding"
    GATHER = "gather"


class LayerID:
    """Monotonic layer guid."""

    _counter = itertools.count(1000)

    def __init__(self) -> None:
        self.id = next(LayerID._counter)

    def __int__(self) -> int:
        return self.id

    def __repr__(self) -> str:
        return f"LayerID({self.id})"
