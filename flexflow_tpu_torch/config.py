"""Run configuration (the fields the training slice reads).

Counterpart of ``flexflow_tpu/config.py`` ``FFConfig``.  The mesh fields
give way to one ``device``; the JAX field ``rng_seed`` is ``seed`` here.
The fit loop's fields keep the JAX names and defaults:
``metrics_sync_every`` (K of the K-step metric flush, 0 = auto: 32, or 1
with ``profiling``), ``prefetch_depth``, ``checkpoint_every`` /
``checkpoint_path`` / ``resume_from`` and ``fault_plan`` (a spec string
or a JSON plan file, installed by ``FFModel``).  ``health`` is the JAX
run-health monitor's mode; the monitor is not ported, so ``fit`` refuses
any mode but ``"off"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    # --- the fit loop ---
    metrics_sync_every: int = 0  # 0 = auto (DEFAULT_METRICS_SYNC_EVERY; 1 with profiling)
    prefetch_depth: int = 3  # batches the loader thread and the placement run ahead
    profiling: bool = False  # per-step host observation: forces K = 1
    checkpoint_every: int = 0  # snapshot every K optimizer steps (0 = off)
    checkpoint_path: Optional[str] = None  # target .npz for checkpoint_every
    resume_from: Optional[str] = None  # checkpoint to restore before fit
    fault_plan: Optional[str] = None  # spec string or JSON plan file; None = no plan
    health: str = "off"  # the JAX run-health monitor's mode; only "off" is ported
