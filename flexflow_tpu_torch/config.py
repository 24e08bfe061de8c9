"""Run configuration (the fields the training slice reads).

Counterpart of ``flexflow_tpu/config.py`` ``FFConfig``.  The mesh fields
give way to one ``device``; the JAX field ``rng_seed`` is ``seed`` here.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.device import DEFAULT_DEVICE

__all__ = ["FFConfig"]


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    epochs: int = 1
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    # params and compute in float32; "bfloat16" casts activations and
    # params at use (master params, optimizer state, loss stay float32)
    compute_dtype: str = "float32"
    seed: int = 0
    device: str = DEFAULT_DEVICE
