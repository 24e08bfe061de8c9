"""Shapes and shared math of the GPT decode programs.

Counterpart of ``flexflow_tpu/models/gpt_decode.py``: :class:`GPTSpec`
(built with an explicit constructor, or from a
:class:`~flexflow_tpu_torch.models.transformer.GPTDecoder` by
:meth:`GPTDecoder.spec`), the mixed-precision cast rule, the weight-only
int8 rule and the layer norm every serve program uses.  The dense
``GPTDecodeSession`` is not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = [
    "GPTSpec", "make_cast", "layer_norm", "quantize_weights_int8", "dequantize_weights_int8",
]

Tree = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class GPTSpec:
    """Shapes and attributes of a GPT decoder, as the serve programs
    need them."""

    num_layers: int
    heads: int
    head_dim: int
    hidden: int
    has_bias: bool
    eps: float
    batch: int
    seq: int


def make_cast(dtype: torch.dtype):
    """float32 master weights cast to the compute dtype at use; other
    dtypes (and an all-float32 run) pass through unchanged."""
    mixed = dtype != torch.float32

    def cast(x: torch.Tensor) -> torch.Tensor:
        if mixed and x.dtype == torch.float32:
            return x.to(dtype)
        return x

    return cast


def quantize_weights_int8(params: Mapping[str, Mapping[str, torch.Tensor]]) -> Tuple[Tree, Tree]:
    """Weight-only int8: every float leaf with >= 2 axes becomes int8 with
    a symmetric float32 scale per last-axis channel (``amax / 127``, 1.0
    for an all-zero channel; round half to even, clip at +-127); 1-D and
    integer leaves pass through with scale 1.0.  Computed on the host in
    numpy, in the JAX package's float32 order, so the ints are the same.
    Returns ``(qparams, scales)`` with ``params``' nesting, on each
    leaf's device."""
    qparams: Tree = {}
    scales: Tree = {}
    for layer, leaves in params.items():
        qparams[layer], scales[layer] = {}, {}
        for name, w in leaves.items():
            one = torch.ones((), dtype=torch.float32, device=w.device)
            if w.dim() < 2 or not w.is_floating_point():
                qparams[layer][name], scales[layer][name] = w, one
                continue
            xf = w.detach().float().cpu().numpy()
            amax = np.max(np.abs(xf), axis=tuple(range(xf.ndim - 1)))
            scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            qx = np.clip(np.round(xf / scale), -127, 127).astype(np.int8)
            qparams[layer][name] = torch.from_numpy(qx).to(w.device)
            scales[layer][name] = torch.from_numpy(scale).to(w.device)
    return qparams, scales


def dequantize_weights_int8(qparams: Mapping[str, Mapping[str, torch.Tensor]],
                            scales: Mapping[str, Mapping[str, torch.Tensor]]) -> Tree:
    """The read side of :func:`quantize_weights_int8`: int8 leaves become
    ``w.float() * scale`` (the scale broadcasts on the last axis); the
    rest pass through."""
    return {
        layer: {name: w.float() * scales[layer][name] if w.dtype == torch.int8 else w
                for name, w in leaves.items()}
        for layer, leaves in qparams.items()
    }


def layer_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Layer norm over the last axis with the biased variance, as
    ``jnp.var`` computes it; ``p`` holds ``scale`` and ``bias``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
