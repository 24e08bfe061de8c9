"""Core enums (the members the port's ops use).

Counterpart of ``flexflow_tpu/fftype.py``: the same names and values, so
graphs and strategy files mean the same thing in both packages.  Data
types map onto ``torch`` dtypes in place of ``jax.numpy`` ones.
"""

from __future__ import annotations

import enum
import itertools

import torch

__all__ = [
    "DataType", "ActiMode", "AggrMode", "PoolType", "LossType", "MetricsType", "OperatorType",
    "LayerID",
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


class PoolType(enum.Enum):
    MAX = "max"
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
    """The op kinds of the single-device op set (the JAX enum less the
    parallel ops and ``FUSED``)."""

    NOOP = "noop"
    WEIGHT = "weight"
    CONV2D = "conv2d"
    DROPOUT = "dropout"
    LINEAR = "linear"
    BATCHMATMUL = "batch_matmul"
    POOL2D = "pool2d"
    SCALAR_MULTIPLY = "scalar_multiply"
    SCALAR_ADD = "scalar_add"
    SCALAR_SUB = "scalar_sub"
    SCALAR_TRUE_DIV = "scalar_true_div"
    RELU = "relu"
    IDENTITY = "identity"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    ELU = "elu"
    GELU = "gelu"
    RSQRT = "rsqrt"
    POW = "pow"
    EXP = "exp"
    SIN = "sin"
    COS = "cos"
    FLAT = "flat"
    SOFTMAX = "softmax"
    BATCHNORM = "batch_norm"
    LAYERNORM = "layer_norm"
    RMS_NORM = "rms_norm"
    CONCAT = "concat"
    SPLIT = "split"
    EMBEDDING = "embedding"
    GATHER = "gather"
    CACHE = "cache"
    AGGREGATE = "aggregate"
    AGGREGATE_SPEC = "aggregate_spec"
    RESHAPE = "reshape"
    REVERSE = "reverse"
    TRANSPOSE = "transpose"
    EW_ADD = "ew_add"
    EW_MUL = "ew_mul"
    EW_SUB = "ew_sub"
    EW_DIV = "ew_div"
    EW_MAX = "ew_max"
    EW_MIN = "ew_min"
    REDUCE_SUM = "reduce_sum"
    REDUCE_MEAN = "reduce_mean"
    MULTIHEAD_ATTENTION = "multihead_attention"
    TOPK = "topk"
    GROUP_BY = "group_by"
    EXPERTS = "experts"
    CAST = "cast"


class LayerID:
    """Monotonic layer guid."""

    _counter = itertools.count(1000)

    def __init__(self) -> None:
        self.id = next(LayerID._counter)

    def __int__(self) -> int:
        return self.id

    def __repr__(self) -> str:
        return f"LayerID({self.id})"
