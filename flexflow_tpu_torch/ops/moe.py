"""Mixture-of-experts ops: GroupBy, Aggregate, AggregateSpec, Experts.

Counterpart of ``flexflow_tpu/ops/moe.py``, the single-device path.
Dispatch is fixed-capacity: each expert receives ``capacity =
ceil(alpha * k * tokens / n)`` rows, in the order of an exclusive
cumulative sum over the token-major (token, choice) slots; a slot past
its expert's capacity is dropped.  ``GroupBy`` scatters the tokens into
(n, capacity, d) with ``index_add`` (every slot in capacity receives one
row; the dropped ones land in a dump row that is cut off), ``Aggregate``
gathers the expert outputs back and weights them by the gates.
:meth:`Aggregate.aux_loss` is the load-balance loss that the executor
adds to the model's loss at ``lambda_bal``.

``Experts`` is the fused block with batched ``(n, ...)`` expert weights
``w1``, ``b1``, ``w2``, ``b2``: dispatch, a two-layer ReLU FFN per
expert, combine.  The JAX op's expert-parallel path (``shard_map`` over
an ``expert`` mesh axis) is mesh parallelism, ROADMAP.md queue A
item 5.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.fftype import OperatorType
from flexflow_tpu_torch.initializer import default_bias_initializer, default_kernel_initializer
from flexflow_tpu_torch.ops.base import OpContext, OpDef, ShapeDtype, WeightSpec, register_op
from flexflow_tpu_torch.tensor import Layer

__all__ = ["expert_capacity", "make_dispatch", "dispatch_indices", "scatter_group",
           "gather_combine", "GroupBy", "Aggregate", "AggregateSpec", "Experts"]


def expert_capacity(tokens: int, n_experts: int, k: int, alpha: float) -> int:
    """Rows each expert receives: ``ceil(alpha * k * tokens / n)``, at least 1."""
    return max(1, int(math.ceil(alpha * k * tokens / n_experts)))


def _capacity_positions(assign: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, choice) slot's position within its expert, an
    exclusive cumulative count over the token-major slots, and whether it
    is within ``capacity``."""
    t, k = assign.shape
    flat = F.one_hot(assign.long(), n_experts).reshape(t * k, n_experts)
    pos_flat = torch.cumsum(flat, dim=0) - flat
    pos = (pos_flat * flat).sum(-1).reshape(t, k)
    return pos, pos < capacity


def make_dispatch(assign: torch.Tensor, n_experts: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dispatch (t, n, capacity) float 0/1, pos (t, k), within (t, k))
    from the top-k assignments ``assign`` (t, k)."""
    pos, within = _capacity_positions(assign, n_experts, capacity)
    eoh = F.one_hot(assign.long(), n_experts).float()
    poh = F.one_hot(torch.clamp_max(pos, capacity - 1), capacity).float()
    mask = within[..., None, None].float() * eoh[..., :, None] * poh[..., None, :]
    return mask.sum(dim=1), pos, within


def dispatch_indices(assign: torch.Tensor, n_experts: int, capacity: int):
    """(slot (t, k) in [0, n * capacity), within (t, k)).  The top-k
    experts of a token are distinct, so slots within capacity never
    collide."""
    pos, within = _capacity_positions(assign, n_experts, capacity)
    return assign.long() * capacity + torch.clamp_max(pos, capacity - 1), within


def scatter_group(x: torch.Tensor, slot: torch.Tensor, within: torch.Tensor,
                  n_experts: int, capacity: int) -> torch.Tensor:
    """Tokens (t, d) -> (n, capacity, d)."""
    t, k = slot.shape
    d = x.shape[-1]
    safe = torch.where(within, slot, torch.full_like(slot, n_experts * capacity))
    xk = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    grouped = x.new_zeros((n_experts * capacity + 1, d)).index_add(0, safe.reshape(-1), xk)
    return grouped[: n_experts * capacity].reshape(n_experts, capacity, d)


def gather_combine(y: torch.Tensor, slot: torch.Tensor, within: torch.Tensor,
                   gates: torch.Tensor) -> torch.Tensor:
    """Expert outputs (n, capacity, d) -> (t, d), weighted by the gates."""
    n, cap, d = y.shape
    t, k = slot.shape
    rows = y.reshape(n * cap, d)[slot.reshape(-1)].reshape(t, k, d)
    w = (gates * within.to(gates.dtype)).to(rows.dtype)
    return torch.einsum("tk,tkd->td", w, rows)


class GroupBy(OpDef):
    """Inputs: data (t, d), assign int32 (t, k).  Outputs: ``n_experts``
    tensors of (capacity, d)."""

    op_type = OperatorType.GROUP_BY

    def _cap(self, layer: Layer) -> int:
        data, assign = layer.inputs[:2]
        return expert_capacity(data.shape[0], layer.attrs["n_experts"], assign.shape[-1],
                               layer.attrs.get("alpha", 1.0))

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        data = layer.inputs[0]
        cap = self._cap(layer)
        return [((cap, data.shape[1]), data.dtype) for _ in range(layer.attrs["n_experts"])]

    def forward(self, layer, params, inputs, ctx: OpContext):
        data, assign = inputs[:2]
        n, cap = layer.attrs["n_experts"], self._cap(layer)
        slot, within = dispatch_indices(assign, n, cap)
        grouped = scatter_group(data, slot, within, n, cap)
        return [grouped[e] for e in range(n)]


class Aggregate(OpDef):
    """Inputs: gate_preds (t, k), gate_assign (t, k), true_gate_assign
    (t, k), full gate (t, n), then the n expert outputs (capacity, d).
    Output (t, d)."""

    op_type = OperatorType.AGGREGATE

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        exp0 = layer.inputs[4]
        return [((layer.inputs[0].shape[0], exp0.shape[-1]), exp0.dtype)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        n = layer.attrs["n"]
        experts = torch.stack(list(inputs[4:4 + n]), dim=0)
        slot, within = dispatch_indices(inputs[1], n, experts.shape[1])
        return [gather_combine(experts, slot, within, inputs[0]).to(experts.dtype)]

    @staticmethod
    def aux_loss(gate_probs: torch.Tensor, assign: torch.Tensor, n_experts: int) -> torch.Tensor:
        """Load balance: ``n * sum_e f_e * P_e``, with ``f_e`` the share of
        tokens whose first choice is ``e`` and ``P_e`` the mean gate
        probability of ``e``."""
        frac = F.one_hot(assign[:, 0].long(), n_experts).float().mean(dim=0)
        prob = gate_probs.float().mean(dim=0) if gate_probs.shape[-1] == n_experts else frac
        return n_experts * torch.sum(frac * prob)


class AggregateSpec(Aggregate):
    """The speculative variant: the same combine."""

    op_type = OperatorType.AGGREGATE_SPEC


def _expert_ffn(x, w1, b1, w2, b2):
    """Two-layer ReLU FFN per expert: x (e, c, d)."""
    h = torch.relu(torch.bmm(x, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


class Experts(OpDef):
    """Inputs: data (t, d), assign int32 (t, k), gate_preds (t, k),
    gate_full (t, n).  Weights: w1 (n, d, h), b1 (n, h), w2 (n, h, d),
    b2 (n, d).  Output (t, d)."""

    op_type = OperatorType.EXPERTS

    def infer(self, layer: Layer) -> List[ShapeDtype]:
        data = layer.inputs[0]
        return [(data.shape, data.dtype)]

    def weights(self, layer: Layer) -> List[WeightSpec]:
        data = layer.inputs[0]
        n, d, h = layer.attrs["n_experts"], data.shape[-1], layer.attrs["hidden"]
        init, zi, dt = default_kernel_initializer(), default_bias_initializer(), data.dtype
        return [WeightSpec("w1", (n, d, h), dt, init), WeightSpec("b1", (n, h), dt, zi),
                WeightSpec("w2", (n, h, d), dt, init), WeightSpec("b2", (n, d), dt, zi)]

    def forward(self, layer, params, inputs, ctx: OpContext):
        x, assign, gate_preds = inputs[0], inputs[1], inputs[2]
        n = layer.attrs["n_experts"]
        cap = expert_capacity(x.shape[0], n, assign.shape[-1], layer.attrs.get("alpha", 1.0))
        slot, within = dispatch_indices(assign, n, cap)
        y = _expert_ffn(scatter_group(x, slot, within, n, cap),
                        params["w1"], params["b1"], params["w2"], params["b2"])
        return [gather_combine(y, slot, within, gate_preds).to(x.dtype)]


register_op(GroupBy())
register_op(Aggregate())
register_op(AggregateSpec())
register_op(Experts())
