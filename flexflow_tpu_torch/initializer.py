"""Weight initializers.

Counterpart of ``flexflow_tpu/initializer.py``: the same classes and
fan rules, drawing from an explicit :class:`torch.Generator` in place
of a ``jax.random`` key.  The two frameworks give different numbers for
the same seed, so parity tests carry weights across
(:func:`flexflow_tpu_torch.models.transformer.load_jax_params`,
:meth:`flexflow_tpu_torch.model.FFModel.set_weights`) instead of
redrawing them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = [
    "Initializer",
    "GlorotUniform",
    "ZeroInitializer",
    "OnesInitializer",
    "ConstantInitializer",
    "UniformInitializer",
    "NormInitializer",
    "default_kernel_initializer",
    "default_bias_initializer",
]


class Initializer:
    def __call__(
        self, gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype
    ) -> torch.Tensor:
        raise NotImplementedError


class GlorotUniform(Initializer):
    """limit = sqrt(6 / (fan_in + fan_out)); 2-D weights take
    ``(fan_in, fan_out) = shape``, 4-D (HWIO) weights scale by the
    receptive field, anything else uses sqrt(numel) for both fans."""

    def __call__(self, gen, shape, dtype):
        if len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        elif len(shape) == 4:
            rf = shape[0] * shape[1]
            fan_in, fan_out = shape[2] * rf, shape[3] * rf
        else:
            fan_in = fan_out = int(math.sqrt(max(1, math.prod(shape))))
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        return out.uniform_(-limit, limit, generator=gen)


class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=gen.device)


class OnesInitializer(Initializer):
    def __call__(self, gen, shape, dtype):
        return torch.ones(shape, dtype=dtype, device=gen.device)


class ConstantInitializer(Initializer):
    def __init__(self, value: float) -> None:
        self.value = value

    def __call__(self, gen, shape, dtype):
        return torch.full(shape, self.value, dtype=dtype, device=gen.device)


class UniformInitializer(Initializer):
    """Uniform on [minv, maxv) (DLRM's tables: +-1/sqrt(vocab)).  ``seed``
    is accepted for the JAX signature; the draw comes from the executor's
    generator."""

    def __init__(self, seed: int = 0, minv: float = -0.05, maxv: float = 0.05) -> None:
        self.minv, self.maxv = minv, maxv

    def __call__(self, gen, shape, dtype):
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        return out.uniform_(self.minv, self.maxv, generator=gen)


class NormInitializer(Initializer):
    """Normal(mean, stddev); ``seed`` as for :class:`UniformInitializer`."""

    def __init__(self, seed: int = 0, mean: float = 0.0, stddev: float = 0.05) -> None:
        self.mean, self.stddev = mean, stddev

    def __call__(self, gen, shape, dtype):
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        return out.normal_(self.mean, self.stddev, generator=gen)


def default_kernel_initializer() -> Initializer:
    return GlorotUniform()


def default_bias_initializer() -> Initializer:
    return ZeroInitializer()
