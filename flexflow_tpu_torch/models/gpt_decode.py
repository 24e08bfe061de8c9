"""Shapes and shared math of the GPT decode programs.

Counterpart of ``flexflow_tpu/models/gpt_decode.py``: :class:`GPTSpec`
(built with an explicit constructor, or from a
:class:`~flexflow_tpu_torch.models.transformer.GPTDecoder` by
:meth:`GPTDecoder.spec`), the mixed-precision cast rule and the layer
norm every serve program uses.  The dense ``GPTDecodeSession`` is not
ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GPTSpec", "make_cast", "layer_norm"]


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


def layer_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Layer norm over the last axis with the biased variance, as
    ``jnp.var`` computes it; ``p`` holds ``scale`` and ``bias``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
