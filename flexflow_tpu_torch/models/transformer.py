"""The BERT-style encoder builder, GPT decoder weights as an
``nn.Module``, and the carry from JAX.

Counterpart of ``flexflow_tpu/models/transformer.py``.
:func:`transformer_encoder` builds the encoder into an ``FFModel`` with
the JAX builder's layer names and weight shapes (``enc{i}_attn``,
``enc{i}_ff0`` ...), so ``FFModel.set_weights(jax_model.get_weights())``
carries a JAX encoder over.

For the decoder (``gpt_decoder``):
:class:`GPTDecoder` holds exactly the parameters that ``gpt_decoder`` +
``FFModel.compile`` create, under the same names and shapes
(``tok_embed.kernel``, ``pos_embed.value``, ``dec{i}_ln0.scale``,
``dec{i}_attn.wq`` ...).  Dense kernels keep the JAX ``(in, out)``
layout and are applied as ``x @ w``, so :func:`load_jax_params` copies
the JAX package's ``model.executor.params`` leaf for leaf with no
transposes.

The module is the parameter container the serve programs
(:mod:`flexflow_tpu_torch.serve.engine`) read.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from flexflow_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from flexflow_tpu_torch.fftype import ActiMode
from flexflow_tpu_torch.initializer import (
    GlorotUniform,
    NormInitializer,
    OnesInitializer,
    ZeroInitializer,
)
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models.gpt_decode import GPTSpec
from flexflow_tpu_torch.tensor import Tensor

__all__ = [
    "BERT_BASE", "BERT_LARGE", "encoder_layer", "transformer_encoder",
    "GPT2_SMALL", "GPT2_MEDIUM", "GPTDecoder", "load_jax_params",
]

BERT_BASE = dict(hidden=768, heads=12, ff_dim=3072, num_layers=12)
BERT_LARGE = dict(hidden=1024, heads=16, ff_dim=4096, num_layers=24)
GPT2_SMALL = dict(hidden=768, heads=12, ff_dim=3072, num_layers=12)
GPT2_MEDIUM = dict(hidden=1024, heads=16, ff_dim=4096, num_layers=24)


def encoder_layer(
    model: FFModel,
    t: Tensor,
    hidden: int,
    heads: int,
    ff_dim: int,
    dropout: float = 0.0,
    causal: bool = False,
    use_flash: bool = True,
    name: str = "enc",
) -> Tensor:
    """Post-LN encoder block: attention -> add & norm -> FFN (GELU) ->
    add & norm."""
    attn = model.multihead_attention(
        t, t, t, hidden, heads, dropout=dropout, causal=causal,
        use_flash=use_flash, name=f"{name}_attn",
    )
    t = model.add(attn, t, name=f"{name}_res0")
    t = model.layer_norm(t, axes=[-1], name=f"{name}_ln0")
    ff = model.dense(t, ff_dim, ActiMode.GELU, name=f"{name}_ff0")
    ff = model.dense(ff, hidden, name=f"{name}_ff1")
    if dropout > 0.0:
        ff = model.dropout(ff, dropout, name=f"{name}_drop")
    t = model.add(ff, t, name=f"{name}_res1")
    return model.layer_norm(t, axes=[-1], name=f"{name}_ln1")


def transformer_encoder(
    model: FFModel,
    batch: int,
    seq: int,
    hidden: int = 768,
    heads: int = 12,
    ff_dim: int = 3072,
    num_layers: int = 12,
    vocab: int = 32000,
    num_classes: Optional[int] = None,
    dropout: float = 0.0,
    causal: bool = False,
    use_flash: bool = True,
    raw_input: bool = False,
) -> Tensor:
    """Build the encoder into ``model`` from a (batch, seq, hidden) input
    ``embeddings``; returns the softmax output of the pooled classifier
    (``num_classes``) or of the LM head over ``vocab``, flattened to
    (batch * seq, vocab).  The token-embedding front end
    (``raw_input=False``) needs ``ops/embedding.py``, which is not
    ported, and raises."""
    if not raw_input:
        raise NotImplementedError(
            "transformer_encoder(raw_input=False) needs the token embedding "
            "(ops/embedding.py), which is not ported; pass raw_input=True")
    t = model.create_tensor((batch, seq, hidden), name="embeddings")
    for i in range(num_layers):
        t = encoder_layer(
            model, t, hidden, heads, ff_dim, dropout, causal, use_flash, name=f"enc{i}"
        )
    if num_classes is not None:
        # pooled classification head (mean over the sequence)
        t = model.reduce_mean(t, axes=[1], name="pool")
        t = model.dense(t, num_classes, name="cls_head")
        return model.softmax(t, name="cls_softmax")
    t = model.dense(t, vocab, name="lm_head")
    t = model.reshape(t, (batch * seq, vocab), name="lm_flatten")
    return model.softmax(t, name="lm_softmax")


class _Leaves(nn.Module):
    """One JAX layer's weights, each registered under its JAX leaf name."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


class GPTDecoder(nn.Module):
    """Pre-LN causal decoder (GPT-2 style) with a learned position table
    and an untied LM head.  Weights are drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``, with the JAX package's
    initializers: normal(0, 0.05) for the token embedding, Glorot
    uniform for the position table and every dense kernel, ones/zeros
    for layer norms and biases.  ``attn_bias`` adds ``bq/bk/bv/bo``
    (the JAX ``multihead_attention(bias=True)`` option; ``gpt_decoder``
    builds without them)."""

    def __init__(
        self,
        *,
        seq: int,
        hidden: int = 768,
        heads: int = 12,
        ff_dim: int = 3072,
        num_layers: int = 12,
        vocab: int = 50257,
        attn_bias: bool = False,
        eps: float = 1e-5,
        seed: int = 0,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> None:
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of heads {heads}")
        self.seq, self.hidden, self.heads = int(seq), int(hidden), int(heads)
        self.ff_dim, self.num_layers, self.vocab = int(ff_dim), int(num_layers), int(vocab)
        self.attn_bias, self.eps = bool(attn_bias), float(eps)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        f32 = torch.float32
        glorot, norm = GlorotUniform(), NormInitializer()
        zeros, ones = ZeroInitializer(), OnesInitializer()

        def add(layer: str, **leaves) -> None:
            self.add_module(layer, _Leaves({
                name: init(gen, shape, f32) for name, (init, shape) in leaves.items()
            }))

        h, f = self.hidden, self.ff_dim
        add("tok_embed", kernel=(norm, (self.vocab, h)))
        add("pos_embed", value=(glorot, (self.seq, h)))
        for i in range(self.num_layers):
            add(f"dec{i}_ln0", scale=(ones, (h,)), bias=(zeros, (h,)))
            attn = {w: (glorot, (h, h)) for w in ("wq", "wk", "wv", "wo")}
            if self.attn_bias:
                attn.update({b: (zeros, (h,)) for b in ("bq", "bk", "bv", "bo")})
            add(f"dec{i}_attn", **attn)
            add(f"dec{i}_ln1", scale=(ones, (h,)), bias=(zeros, (h,)))
            add(f"dec{i}_ff0", kernel=(glorot, (h, f)), bias=(zeros, (f,)))
            add(f"dec{i}_ff1", kernel=(glorot, (f, h)), bias=(zeros, (h,)))
        add("final_ln", scale=(ones, (h,)), bias=(zeros, (h,)))
        add("lm_head", kernel=(glorot, (h, self.vocab)))

    def spec(self, batch: int) -> GPTSpec:
        """The :class:`GPTSpec` of this decoder served ``batch`` lanes wide."""
        return GPTSpec(
            num_layers=self.num_layers, heads=self.heads,
            head_dim=self.hidden // self.heads, hidden=self.hidden,
            has_bias=self.attn_bias, eps=self.eps, batch=int(batch), seq=self.seq,
        )

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Detached weights as ``{layer: {leaf: tensor}}``, the nesting of
        the JAX ``model.executor.params``."""
        return {
            layer: {leaf: p.detach() for leaf, p in mod.named_parameters()}
            for layer, mod in self.named_children()
        }


def load_jax_params(model: GPTDecoder, params: Mapping[str, Mapping[str, Any]]) -> None:
    """Fill ``model`` from the JAX package's ``model.executor.params``,
    given as a nested dict of numpy arrays (the caller converts the JAX
    arrays).  Raises ``ValueError`` on any missing name, extra name or
    shape mismatch, before any parameter is written."""
    want = dict(model.named_parameters())
    got = {
        f"{layer}.{leaf}": np.asarray(arr)
        for layer, leaves in params.items()
        for leaf, arr in leaves.items()
    }
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(
            f"load_jax_params: missing {missing or 'none'}, extra {extra or 'none'}"
        )
    for name, arr in got.items():
        if arr.shape != tuple(want[name].shape):
            raise ValueError(
                f"load_jax_params: {name} has shape {arr.shape}, the model "
                f"expects {tuple(want[name].shape)}"
            )
    with torch.no_grad():
        for name, arr in got.items():
            p = want[name]
            p.copy_(torch.from_numpy(np.array(arr, np.float32)).to(p.device, p.dtype))
