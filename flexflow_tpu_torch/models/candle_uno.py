"""CANDLE-Uno drug-response model.

Counterpart of ``flexflow_tpu/models/candle_uno.py``.  Reference app
``examples/cpp/candle_uno/candle_uno.cc:49-130``: three input feature
groups (dose + cell-line + drug descriptors), each non-dose group passes
through its own feature-encoder MLP; encodings concat into a trunk MLP
ending in one regression output (MSE loss).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from flexflow_tpu_torch.fftype import ActiMode
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.tensor import Tensor

__all__ = ["DENSE_LAYERS", "DENSE_FEATURE_LAYERS", "FEATURE_SHAPES", "INPUT_FEATURES",
           "candle_uno"]

# candle_uno.cc:28-40 defaults
DENSE_LAYERS = (1000, 1000, 1000)
DENSE_FEATURE_LAYERS = (1000, 1000, 1000)
FEATURE_SHAPES: Dict[str, int] = {"dose": 1, "cell.rnaseq": 942, "drug.descriptors": 5270}
INPUT_FEATURES: Dict[str, str] = {
    "dose1": "dose", "dose2": "dose",
    "cell.rnaseq": "cell.rnaseq",
    "drug1.descriptors": "drug.descriptors",
    "drug2.descriptors": "drug.descriptors",
}


def _feature_mlp(model: FFModel, t: Tensor, dims: Sequence[int], name: str) -> Tensor:
    """``candle_uno.cc:49-58``: relu dense stack, no bias."""
    for i, d in enumerate(dims):
        t = model.dense(t, d, ActiMode.RELU, use_bias=False, name=f"{name}_{i}")
    return t


def candle_uno(
    model: FFModel,
    batch: int,
    dense_layers: Sequence[int] = DENSE_LAYERS,
    dense_feature_layers: Sequence[int] = DENSE_FEATURE_LAYERS,
    feature_shapes: Optional[Dict[str, int]] = None,
    input_features: Optional[Dict[str, str]] = None,
) -> Tensor:
    """``candle_uno.cc:95-130``; returns the (batch, 1) regression output."""
    feature_shapes = feature_shapes or FEATURE_SHAPES
    input_features = input_features or INPUT_FEATURES
    encoded = []
    for name, ftype in input_features.items():
        in_dim = feature_shapes[ftype]
        t = model.create_tensor((batch, in_dim), name=f"in_{name.replace('.', '_')}")
        if ftype == "dose":
            encoded.append(t)  # dose features pass through raw (cc:118)
        else:
            encoded.append(
                _feature_mlp(model, t, dense_feature_layers,
                             f"feat_{name.replace('.', '_')}")
            )
    out = model.concat(encoded, axis=-1, name="feature_concat")
    for i, d in enumerate(dense_layers):
        out = model.dense(out, d, ActiMode.RELU, use_bias=False, name=f"trunk_{i}")
    return model.dense(out, 1, use_bias=False, name="response")
