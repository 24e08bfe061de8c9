"""Mixture-of-experts models.

Counterpart of ``flexflow_tpu/models/moe.py``, the same graphs.  The
encoder's attention is built with ``use_flash=False``, as in the JAX
builder, so it runs the plain attention core.  Reference app
``examples/cpp/mixture_of_experts/moe.cc``:
  * main model (``moe.cc:150-166``): flat MNIST features -> ``FFModel::moe``
    composite (gate -> topk -> group_by -> experts -> aggregate,
    ``src/ops/moe.cc:20-44``) -> dense classifier head.
  * ``create_moe_encoder`` (``moe.cc:102-130``): transformer encoder whose
    FFN is replaced by the MoE composite (attention -> add&norm -> moe ->
    add&norm).
"""

from __future__ import annotations

from flexflow_tpu_torch.fftype import ActiMode
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.tensor import Tensor

__all__ = ["DATA_DIM", "NUM_EXP", "NUM_SELECT", "HIDDEN", "OUT_DIM", "ALPHA", "LAMBDA",
           "moe_classifier", "moe_encoder"]

# moe.cc constants
DATA_DIM = 784  # MNIST
NUM_EXP = 5
NUM_SELECT = 2
HIDDEN = 64
OUT_DIM = 10
ALPHA = 2.0
LAMBDA = 0.04


def moe_classifier(
    model: FFModel,
    batch: int,
    in_dim: int = DATA_DIM,
    num_exp: int = NUM_EXP,
    num_select: int = NUM_SELECT,
    hidden: int = HIDDEN,
    num_classes: int = OUT_DIM,
    alpha: float = ALPHA,
    lambda_bal: float = LAMBDA,
    fused: bool = False,
) -> Tensor:
    """``moe.cc:150-166``: moe composite + relu dense head + softmax.

    ``fused=True`` takes the batched ``Experts`` op for the expert tail."""
    t = model.create_tensor((batch, in_dim), name="features")
    t = model.moe(t, num_exp, num_select, hidden, alpha, lambda_bal, fused=fused)
    t = model.dense(t, num_classes, ActiMode.RELU)
    return model.softmax(t)


def moe_encoder(
    model: FFModel,
    batch: int,
    seq: int,
    hidden: int = 64,
    heads: int = 4,
    num_layers: int = 1,
    num_exp: int = NUM_EXP,
    num_select: int = NUM_SELECT,
    num_classes: int = OUT_DIM,
    alpha: float = ALPHA,
    lambda_bal: float = LAMBDA,
    fused: bool = False,
) -> Tensor:
    """``moe.cc:102-130`` ``create_moe_encoder``: attention + MoE-FFN
    blocks with post-LN residuals, then a classifier head over the pooled
    sequence.  The MoE composite operates on flattened (batch*seq, hidden)
    tokens — expert routing is per-token, as in the reference (group_by
    over the sample dim).  ``fused=True`` takes the batched ``Experts`` op."""
    x = model.create_tensor((batch, seq, hidden), name="tokens")
    for i in range(num_layers):
        attn = model.multihead_attention(
            x, x, x, hidden, heads, use_flash=False, name=f"moeenc{i}_attn"
        )
        x = model.layer_norm(model.add(attn, x), axes=[-1], name=f"moeenc{i}_ln0")
        flat = model.reshape(x, (batch * seq, hidden), name=f"moeenc{i}_flat")
        ff = model.moe(flat, num_exp, num_select, hidden, alpha, lambda_bal,
                       fused=fused, name=f"moeenc{i}_moe")
        ff = model.reshape(ff, (batch, seq, hidden), name=f"moeenc{i}_unflat")
        x = model.layer_norm(model.add(ff, x), axes=[-1], name=f"moeenc{i}_ln1")
    t = model.reduce_mean(x, axes=[1], name="pool")
    t = model.dense(t, num_classes, ActiMode.RELU)
    return model.softmax(t)
