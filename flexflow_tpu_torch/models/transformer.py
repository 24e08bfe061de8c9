"""The BERT-style encoder and GPT-style decoder builders, generation,
GPT decoder weights as an ``nn.Module``, and the carry from JAX.

Counterpart of ``flexflow_tpu/models/transformer.py``.
:func:`transformer_encoder` and :func:`gpt_decoder` build into an
``FFModel`` with the JAX builders' layer names and weight shapes
(``tok_embed``, ``enc{i}_attn``, ``dec{i}_ff0`` ...), so
``FFModel.set_weights(jax_model.get_weights())`` carries a JAX model
over.  :func:`sample_next` is the JAX function in numpy, draw for draw,
so :func:`gpt_generate` (a full-prefix forward per new token through
``FFModel.eval_batch``) gives the JAX package's tokens for a seed.

For serving: :class:`GPTDecoder` holds exactly the parameters that
``gpt_decoder`` + ``FFModel.compile`` create, under the same names and
shapes
(``tok_embed.kernel``, ``pos_embed.value``, ``dec{i}_ln0.scale``,
``dec{i}_attn.wq`` ...).  Dense kernels keep the JAX ``(in, out)``
layout and are applied as ``x @ w``, so :func:`load_jax_params` copies
the JAX package's ``model.executor.params`` leaf for leaf with no
transposes.

The module is the parameter container the serve programs
(:mod:`flexflow_tpu_torch.serve.engine`) read; ``load_jax_params(decoder,
model.get_weights())`` serves the weights a port ``gpt_decoder`` trained.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from flexflow_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from flexflow_tpu_torch.fftype import ActiMode, DataType
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
    "GPT2_SMALL", "GPT2_MEDIUM", "decoder_layer", "gpt_decoder", "sample_next",
    "gpt_generate", "GPTDecoder", "load_jax_params",
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
    """Build the encoder into ``model``; returns the softmax output of the
    pooled classifier (``num_classes``) or of the LM head over ``vocab``,
    flattened to (batch * seq, vocab).  The inputs are int32
    ``token_ids`` (batch, seq) and a float ``pos_embed`` (batch, seq,
    hidden) added to the token rows (``tok_embed``), or with
    ``raw_input=True`` one (batch, seq, hidden) input ``embeddings``."""
    if raw_input:
        t = model.create_tensor((batch, seq, hidden), name="embeddings")
    else:
        ids = model.create_tensor((batch, seq), DataType.INT32, name="token_ids")
        t = model.embedding(ids, vocab, hidden, name="tok_embed")
        pos = model.create_tensor((batch, seq, hidden), name="pos_embed")
        t = model.add(t, pos, name="embed_add")
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


def decoder_layer(
    model: FFModel,
    t: Tensor,
    hidden: int,
    heads: int,
    ff_dim: int,
    dropout: float = 0.0,
    use_flash: bool = True,
    name: str = "dec",
) -> Tensor:
    """Pre-LN causal decoder block (GPT-2 style): ln -> causal attention ->
    residual, ln -> FFN (GELU) -> residual."""
    h = model.layer_norm(t, axes=[-1], name=f"{name}_ln0")
    attn = model.multihead_attention(
        h, h, h, hidden, heads, dropout=dropout, causal=True,
        use_flash=use_flash, name=f"{name}_attn",
    )
    t = model.add(attn, t, name=f"{name}_res0")
    h = model.layer_norm(t, axes=[-1], name=f"{name}_ln1")
    ff = model.dense(h, ff_dim, ActiMode.GELU, name=f"{name}_ff0")
    ff = model.dense(ff, hidden, name=f"{name}_ff1")
    if dropout > 0.0:
        ff = model.dropout(ff, dropout, name=f"{name}_drop")
    return model.add(ff, t, name=f"{name}_res1")


def gpt_decoder(
    model: FFModel,
    batch: int,
    seq: int,
    hidden: int = 768,
    heads: int = 12,
    ff_dim: int = 3072,
    num_layers: int = 12,
    vocab: int = 50257,
    dropout: float = 0.0,
    use_flash: bool = True,
) -> Tensor:
    """Causal LM (GPT-2 style): token embedding plus a learned (seq,
    hidden) position parameter, pre-LN causal blocks, a final layer norm
    and an LM head without bias; returns the next-token softmax as
    (batch * seq, vocab)."""
    ids = model.create_tensor((batch, seq), DataType.INT32, name="token_ids")
    t = model.embedding(ids, vocab, hidden, name="tok_embed")
    pos = model.parameter((seq, hidden), name="pos_embed")
    t = model.add(t, pos, name="embed_add")  # (B, S, H) + (S, H)
    for i in range(num_layers):
        t = decoder_layer(model, t, hidden, heads, ff_dim, dropout, use_flash, name=f"dec{i}")
    t = model.layer_norm(t, axes=[-1], name="final_ln")
    t = model.dense(t, vocab, use_bias=False, name="lm_head")
    t = model.reshape(t, (batch * seq, vocab), name="lm_flatten")
    return model.softmax(t, name="lm_softmax")


def sample_next(probs: np.ndarray, temperature: float, rng: np.random.Generator,
                top_k: int = 0, top_p: float = 1.0) -> np.ndarray:
    """Next tokens from (batch, vocab) probabilities: greedy at
    temperature 0, else temperature-scaled sampling with ``rng``,
    optionally cut to the ``top_k`` most likely tokens and to the
    smallest ``top_p`` nucleus (the first token always kept).  The JAX
    function's arithmetic (float64) and draws, so a seed gives the same
    tokens in both packages."""
    if temperature <= 0.0:
        return probs.argmax(-1).astype(np.int32)
    logp = np.log(np.maximum(probs.astype(np.float64), 1e-30)) / temperature
    z = np.exp(logp - logp.max(-1, keepdims=True))
    z /= z.sum(-1, keepdims=True)
    if top_k and top_k < z.shape[-1]:
        kth = np.sort(z, axis=-1)[:, -top_k][:, None]
        z = np.where(z >= kth, z, 0.0)
        z /= z.sum(-1, keepdims=True)
    if top_p < 1.0:
        order = np.argsort(-z, axis=-1)
        sorted_z = np.take_along_axis(z, order, axis=-1)
        cum = np.cumsum(sorted_z, axis=-1)
        keep_sorted = cum - sorted_z < top_p
        keep = np.zeros_like(z, dtype=bool)
        np.put_along_axis(keep, order, keep_sorted, axis=-1)
        z = np.where(keep, z, 0.0)
        z /= z.sum(-1, keepdims=True)
    return np.array([rng.choice(z.shape[-1], p=z[b]) for b in range(z.shape[0])], np.int32)


def gpt_generate(model: FFModel, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0, top_k: int = 0, top_p: float = 1.0) -> np.ndarray:
    """Decode from a compiled :func:`gpt_decoder` model by re-running the
    full-prefix forward for each new token (one fixed-shape forward: the
    causal mask keeps every position < t blind to what lies beyond t).
    ``prompt_ids``: (batch, prompt_len) ints, prompt_len >= 1.  Returns
    (batch, prompt_len + max_new_tokens) ids; only the row each step
    reads leaves the device."""
    batch, seq = model.graph_inputs[0].shape
    p = np.asarray(prompt_ids, np.int32)
    if p.ndim != 2 or p.shape[0] != batch:
        raise ValueError(f"prompt_ids has shape {p.shape}; expected ({batch}, prompt_len)")
    start, end = p.shape[1], p.shape[1] + max_new_tokens
    if not 1 <= start <= seq:
        raise ValueError(f"prompt length {start} is outside [1, {seq}]")
    if end > seq:
        raise ValueError(f"prompt_len + max_new_tokens = {end} exceeds the compiled sequence "
                         f"length {seq}; rebuild gpt_decoder with a longer seq")
    cur = np.zeros((batch, seq), np.int32)
    cur[:, :start] = p
    rng = np.random.default_rng(seed)
    for t in range(start, end):
        probs = model.eval_batch([cur]).reshape(batch, seq, -1)[:, t - 1]
        cur[:, t] = sample_next(probs.cpu().numpy(), temperature, rng, top_k=top_k,
                                top_p=top_p)
    return cur[:, :end]


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
