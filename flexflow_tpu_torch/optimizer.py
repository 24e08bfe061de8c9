"""Optimizers: SGD (momentum, Nesterov) and Adam.

Counterpart of ``flexflow_tpu/optimizer.py``, with its update math:

* SGD: ``g = grad + wd * w``; without momentum ``w -= lr * g``; with it
  ``v = m * v + g`` and ``w -= lr * (nesterov ? g + m * v : v)``.
* Adam: ``g = grad + wd * w``; ``m = b1 * m + (1 - b1) * g``;
  ``v = b2 * v + (1 - b2) * g^2``; ``w -= alpha_t * m / (sqrt(v) + eps)``
  with the bias correction folded into
  ``alpha_t = alpha * sqrt(1 - b2^t) / (1 - b1^t)``, computed in float32
  as the JAX step does.

The JAX optimizers return new pytrees; these update the parameters and
the moments in place (``torch._foreach_*``, under ``torch.no_grad()``),
which keeps one copy of each in memory.  ``params`` and ``grads`` are
lists of tensors in one fixed order; the state holds the step count and
the moments in that order (the update's working form).
:func:`state_by_name` gives the same state in the JAX layout,
``{"step": int, "m": {layer: {weight: tensor}}, "v": ...}``, which the
``ffckpt/2`` checkpoints write and load.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Optimizer", "SGDOptimizer", "AdamOptimizer", "state_by_name"]


class Optimizer:
    def init_state(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        raise NotImplementedError

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any]) -> None:
        raise NotImplementedError


def state_by_name(state: Dict[str, Any], names: Sequence[Tuple[str, str]]) -> Dict[str, Any]:
    """``state`` in the JAX layout: the step, and each slot as
    ``{layer: {weight: tensor}}`` for ``names``, the ``(layer, weight)``
    of every parameter in the update's order.  The tensors are the
    state's own, not copies."""
    out: Dict[str, Any] = {"step": int(state["step"])}
    for slot, tensors in state.items():
        if isinstance(tensors, list):  # a per-parameter slot ("m", "v")
            tree: Dict[str, Dict[str, torch.Tensor]] = {}
            for (layer, w), t in zip(names, tensors):
                tree.setdefault(layer, {})[w] = t
            out[slot] = tree
    return out


def _decayed(params, grads, wd: float):
    return torch._foreach_add(grads, torch._foreach_mul(params, wd)) if wd else list(grads)


@dataclasses.dataclass
class SGDOptimizer(Optimizer):
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init_state(self, params):
        state: Dict[str, Any] = {"step": 0}
        if self.momentum != 0.0:
            state["v"] = [torch.zeros_like(p) for p in params]
        return state

    @torch.no_grad()
    def update(self, params, grads, state):
        g = _decayed(params, grads, self.weight_decay)
        if self.momentum == 0.0:
            step = g
        else:
            torch._foreach_mul_(state["v"], self.momentum)
            torch._foreach_add_(state["v"], g)
            step = (torch._foreach_add(g, torch._foreach_mul(state["v"], self.momentum))
                    if self.nesterov else state["v"])
        torch._foreach_sub_(params, torch._foreach_mul(step, self.lr))
        state["step"] += 1


@dataclasses.dataclass
class AdamOptimizer(Optimizer):
    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    def init_state(self, params):
        return {
            "step": 0,
            "m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
        }

    def alpha_t(self, t: int) -> float:
        """The bias-corrected step size at step ``t`` (1-based), float32."""
        f32 = np.float32
        tf = f32(t)
        num = np.sqrt(f32(1.0) - f32(self.beta2) ** tf)
        return float(f32(self.alpha) * num / (f32(1.0) - f32(self.beta1) ** tf))

    @torch.no_grad()
    def update(self, params, grads, state):
        t = state["step"] + 1
        g = _decayed(params, grads, self.weight_decay)
        m, v = state["m"], state["v"]
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - self.beta1))
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.beta2))
        denom = torch._foreach_add(torch._foreach_sqrt(v), self.epsilon)
        step = torch._foreach_div(torch._foreach_mul(m, self.alpha_t(t)), denom)
        torch._foreach_sub_(params, step)
        state["step"] = t
