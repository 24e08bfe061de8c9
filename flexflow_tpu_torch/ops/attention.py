"""MultiHeadAttention and the plain ``sdpa`` core.

Counterpart of ``flexflow_tpu/ops/attention.py``.  Weights are ``wq``,
``wk``, ``wv``, ``wo`` in the ``(in, out)`` layout (optional ``bq``,
``bk``, ``bv``, ``bo``).  Self-attention (one tensor as query, key and
value, ``kdim == vdim``) projects with one fused ``(E, 3·H·D)`` matmul,
as the JAX op does.

Dispatch of the core differs from the JAX op in one way.  With
``use_flash=True`` (and ``kdim == vdim``) the JAX ``_flash_ok`` takes
the flash kernel only above a 4 GiB score-matrix threshold that was
measured on a TPU v5e, and the plain ``sdpa`` below it.  That threshold
is not carried over: here ``use_flash=True`` takes the CUDA flash
kernels (:mod:`flexflow_tpu_torch.ops.cuda.flash_attention`) whenever
their shape contract holds (Sq and Sk multiples of 128, head dim 64 or
128, float32 or bfloat16), and ``sdpa`` otherwise, as ``_flash_ok``
returning False would.  On CPU tensors the flash path runs the kernels'
plain versions.  ``use_flash=False`` always takes ``sdpa``.

Sequence-parallel attention (ring / Ulysses) is not ported: it needs
more than one device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.initializer import default_bias_initializer, default_kernel_initializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.ops.cuda.flash_attention import flash_attention, kernel_takes
from flexflow_tpu_torch.tensor import Layer

__all__ = ["sdpa", "MultiHeadAttention"]


def sdpa(q, k, v, *, causal: bool = False, dropout_rate: float = 0.0,
         generator: Optional[torch.Generator] = None):
    """Scaled dot-product attention over (B, H, S, D) tensors, in the
    inputs' dtype; the causal mask is end-aligned."""
    d = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - dropout_rate
        mask = torch.empty(probs.shape, device=q.device).bernoulli_(keep, generator=generator)
        probs = probs * mask.to(probs.dtype) / keep
    return torch.matmul(probs, v)


class MultiHeadAttention(OpDef):
    """Inputs: query (B, Sq, E), key (B, Sk, Ek), value (B, Sk, Ev).
    Output: (B, Sq, E).  Attrs: embed_dim, num_heads, kdim, vdim,
    dropout, causal, use_flash, bias."""

    op_type = OperatorType.MULTIHEAD_ATTENTION

    @staticmethod
    def _dims(layer: Layer):
        a = layer.attrs
        e, h = a["embed_dim"], a["num_heads"]
        return e, h, a.get("kdim") or e // h, a.get("vdim") or e // h

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        q = layer.inputs[0]
        return [(q.shape[:-1] + (layer.attrs["embed_dim"],), q.dtype)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        q, k, v = layer.inputs[:3]
        e, h, kd, vd = self._dims(layer)
        init = layer.attrs.get("kernel_initializer") or default_kernel_initializer()
        dt = q.dtype
        ws = [
            WeightSpec("wq", (q.shape[-1], h * kd), dt, init),
            WeightSpec("wk", (k.shape[-1], h * kd), dt, init),
            WeightSpec("wv", (v.shape[-1], h * vd), dt, init),
            WeightSpec("wo", (h * vd, e), dt, init),
        ]
        if layer.attrs.get("bias"):
            zi = default_bias_initializer()
            ws += [
                WeightSpec("bq", (h * kd,), dt, zi),
                WeightSpec("bk", (h * kd,), dt, zi),
                WeightSpec("bv", (h * vd,), dt, zi),
                WeightSpec("bo", (e,), dt, zi),
            ]
        return ws

    def forward(self, layer, params, inputs, ctx: OpContext):
        q_in, k_in, v_in = inputs[:3]
        a = layer.attrs
        e, h, kd, vd = self._dims(layer)
        b, sq, _ = q_in.shape
        sk = k_in.shape[1]
        bias = bool(a.get("bias"))

        if q_in is k_in and k_in is v_in and kd == vd:
            # self-attention: one fused (E, 3·H·D) projection
            wqkv = torch.cat([params["wq"], params["wk"], params["wv"]], dim=1)
            qkv = torch.matmul(q_in, wqkv)
            if bias:
                qkv = qkv + torch.cat([params["bq"], params["bk"], params["bv"]])
            qp, kp, vp = torch.split(qkv, [h * kd, h * kd, h * vd], dim=-1)
        else:
            qp = torch.matmul(q_in, params["wq"])
            kp = torch.matmul(k_in, params["wk"])
            vp = torch.matmul(v_in, params["wv"])
            if bias:
                qp, kp, vp = qp + params["bq"], kp + params["bk"], vp + params["bv"]
        q = qp.reshape(b, sq, h, kd).transpose(1, 2)
        k = kp.reshape(b, sk, h, kd).transpose(1, 2)
        v = vp.reshape(b, sk, h, vd).transpose(1, 2)

        causal = bool(a.get("causal", False))
        dropout = a.get("dropout", 0.0) if ctx.training else 0.0
        if a.get("use_flash", True) and kd == vd and kernel_takes(sq, sk, kd, q.dtype):
            seed = ctx.next_seed() if dropout > 0.0 else 0
            out = flash_attention(q, k, v, causal=causal, dropout_rate=dropout, seed=seed)
        else:
            out = sdpa(q, k, v, causal=causal, dropout_rate=dropout, generator=ctx.generator)
        out = torch.matmul(out.transpose(1, 2).reshape(b, sq, h * vd), params["wo"])
        if bias:
            out = out + params["bo"]
        return [out]


register_op(MultiHeadAttention())
