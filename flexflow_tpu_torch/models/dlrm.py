"""DLRM and XDL recommender models.

Counterpart of ``flexflow_tpu/models/dlrm.py`` on one device, the same
graphs, layer names and initializers.  Reference apps:

  * DLRM -- ``examples/cpp/DLRM/dlrm.cc:44-166``: bottom MLP over dense
    features, one sum-aggregated embedding bag per sparse feature,
    feature interaction (concat), top MLP with a sigmoid layer, MSE loss.
  * XDL  -- ``examples/cpp/XDL/xdl.cc:38-120``: the same without the
    dense bottom MLP (embeddings only -> concat -> MLP).

``dlrm_strategy`` (vocab-sharded tables over a ``model`` mesh axis) is
mesh parallelism, ROADMAP.md queue A item 5.
"""

from __future__ import annotations

import math
from typing import Sequence

from flexflow_tpu_torch.fftype import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.initializer import NormInitializer, UniformInitializer
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.tensor import Tensor

__all__ = ["MLP_BOT", "MLP_TOP", "EMBEDDING_SIZES", "SPARSE_FEATURE_SIZE",
           "EMBEDDING_BAG_SIZE", "XDL_MLP", "dlrm", "xdl"]

# dlrm.cc DLRMConfig defaults
MLP_BOT = (4, 64, 64)
MLP_TOP = (64, 64, 2)
EMBEDDING_SIZES = (1000000, 1000000, 1000000, 1000000)
SPARSE_FEATURE_SIZE = 64
EMBEDDING_BAG_SIZE = 1
XDL_MLP = (256, 128, 2)


def _mlp(model: FFModel, t: Tensor, dims: Sequence[int], sigmoid_layer: int,
         name: str) -> Tensor:
    """``dlrm.cc:44-65``: dense stack, relu except sigmoid at one layer,
    normal init with std sqrt(2 / (fan_in + fan_out))."""
    for i in range(len(dims) - 1):
        std = math.sqrt(2.0 / (dims[i + 1] + dims[i]))
        act = ActiMode.SIGMOID if i == sigmoid_layer else ActiMode.RELU
        t = model.dense(t, dims[i + 1], act, use_bias=True,
                        kernel_initializer=NormInitializer(0, 0.0, std), name=f"{name}_{i}")
    return t


def _emb(model: FFModel, ids: Tensor, vocab: int, out_dim: int, idx: int) -> Tensor:
    """``dlrm.cc:67-82``: sum-aggregated bag, uniform(+-1/sqrt(vocab))."""
    rng = math.sqrt(1.0 / vocab)
    return model.embedding(ids, vocab, out_dim, AggrMode.SUM,
                           kernel_initializer=UniformInitializer(0, -rng, rng), name=f"emb_{idx}")


def dlrm(model: FFModel, batch: int, embedding_sizes: Sequence[int] = EMBEDDING_SIZES,
         sparse_feature_size: int = SPARSE_FEATURE_SIZE, bag_size: int = EMBEDDING_BAG_SIZE,
         mlp_bot: Sequence[int] = MLP_BOT, mlp_top: Sequence[int] = MLP_TOP,
         sigmoid_bot: int = -1) -> Tensor:
    """``dlrm.cc:137-166``; returns the (batch, mlp_top[-1]) prediction.
    Graph inputs: one (batch, bag_size) int32 id tensor per table, then
    the (batch, mlp_bot[0]) dense features."""
    sparse = [model.create_tensor((batch, bag_size), DataType.INT32, name=f"sparse_{i}")
              for i in range(len(embedding_sizes))]
    dense_in = model.create_tensor((batch, mlp_bot[0]), name="dense_features")
    x = _mlp(model, dense_in, mlp_bot, sigmoid_bot, "bot")
    ly = [_emb(model, s, vocab, sparse_feature_size, i)
          for i, (s, vocab) in enumerate(zip(sparse, embedding_sizes))]
    z = model.concat([x] + ly, axis=-1, name="interact")
    # sigmoid at the second-to-last layer (dlrm.cc:164: size-2)
    return _mlp(model, z, mlp_top, len(mlp_top) - 2, "top")


def xdl(model: FFModel, batch: int, embedding_sizes: Sequence[int] = EMBEDDING_SIZES,
        sparse_feature_size: int = 64, bag_size: int = 1,
        mlp: Sequence[int] = XDL_MLP) -> Tensor:
    """``xdl.cc:38-120``: embeddings -> concat -> MLP."""
    sparse = [model.create_tensor((batch, bag_size), DataType.INT32, name=f"sparse_{i}")
              for i in range(len(embedding_sizes))]
    ly = [_emb(model, s, vocab, sparse_feature_size, i)
          for i, (s, vocab) in enumerate(zip(sparse, embedding_sizes))]
    z = model.concat(ly, axis=-1, name="interact")
    dims = (len(ly) * sparse_feature_size,) + tuple(mlp)
    return _mlp(model, z, dims, len(dims) - 2, "top")
