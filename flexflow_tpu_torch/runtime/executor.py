"""The training step: forward, loss, backward, optimizer update.

Counterpart of ``flexflow_tpu/runtime/executor.py`` ``Executor``.  The
JAX executor traces the graph into one jitted program; here the same
graph runs eagerly in layer order, autograd gives the backward (through
the flash kernels' own backward where the attention core takes them),
and the optimizer updates the parameters in place.

Weights are created per layer, in layer order, on the device.  A
trainable one is a parameter, ``params[layer][weight]``; one that is not
(BatchNorm's running stats, ``Cache``'s last batch, a ``parameter`` with
``trainable=False`` or an integer dtype) is state, ``state[layer][weight]``,
kept apart as the JAX executor keeps it: the op's forward sees both, but
state takes no gradient and no optimizer slot, and a training step
rewrites it from the op's ``state_update`` after the optimizer's update.
Neither is depth-stacked: the JAX ``_stack_param_buckets`` is a storage
layout that its ``get_weights`` hides, so both packages expose the same
per-layer dictionary.  The load-balance losses of the MoE ops
(``Aggregate``, ``AggregateSpec``, ``Experts`` with ``lambda_bal`` > 0)
are added to the model's loss, as the JAX step adds them.

Mixed precision (``compute_dtype="bfloat16"``) follows the JAX
executor: master params, optimizer moments, loss and metrics stay
float32; graph inputs and params are cast to the compute dtype at use
(the cast's backward gives float32 gradients); the logits are cast back
to float32 before the loss; state is updated from float32 inputs.
``compute_dtype="float64"`` keeps float weights, moments, activations
and the loss in float64 (a reference run to hold a float32 run
against).  On a CUDA device the executor turns TF32 off for matmuls and
for cuDNN, so float32 products are float32 products.

:meth:`Executor.train_step` returns the loss and the metrics as device
tensors and makes no host sync: a numpy batch is staged through pinned
memory and copied without blocking, and nothing is read back.  The
loops above it (``FFModel.fit`` and ``eval``) sync on purpose, and count
each sync with :meth:`Executor.count_host_sync` (``host_syncs``).  The
fault plan's fit-site hook runs at the top of ``train_step``, keyed on
the step count, so a ``device_loss`` at step N raises before step N
changes anything.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.fftype import LossType, OperatorType
from flexflow_tpu_torch.loss import get_loss_fn
from flexflow_tpu_torch.metrics import Metrics
from flexflow_tpu_torch.ops.base import OpContext, get_op_def
from flexflow_tpu_torch.ops.moe import Aggregate
from flexflow_tpu_torch.optimizer import Optimizer, state_by_name
from flexflow_tpu_torch.runtime.faults import get_fault_plan
from flexflow_tpu_torch.tensor import Layer, Tensor

__all__ = ["Executor"]

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float64": torch.float64}
_AUX_LOSS_OPS = (OperatorType.AGGREGATE, OperatorType.AGGREGATE_SPEC, OperatorType.EXPERTS)


class Executor:
    """Runs (layers, optimizer, loss) on one device."""

    def __init__(
        self,
        layers: List[Layer],
        graph_inputs: List[Tensor],
        logits: Tensor,
        optimizer: Optimizer,
        loss_type: LossType,
        metrics: Optional[Metrics],
        device: torch.device,
        seed: int = 0,
        compute_dtype: str = "float32",
    ) -> None:
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: expected float32, bfloat16 "
                             f"or float64")
        self.layers = layers
        self.graph_inputs = graph_inputs
        self.logits = logits
        self.optimizer = optimizer
        self.loss_fn = get_loss_fn(loss_type)
        self.metrics = metrics
        self.device = device
        self.seed = int(seed)
        self.compute_dtype = _COMPUTE_DTYPES[compute_dtype]
        self._mixed = self.compute_dtype == torch.bfloat16
        self._wide = self.compute_dtype == torch.float64
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._wspecs = {int(l.layer_guid): get_op_def(l.op_type).weights(l) for l in layers}
        self._generator = torch.Generator(device=device)
        self._step_count = 0
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.opt_state: Any = None
        # deliberate host syncs of the fit/eval loops, and the seconds
        # the host spent blocked in them
        self.host_syncs = 0
        self.host_stall_s = 0.0
        self.dcn_degraded = False  # set by a dcn_degrade fault

    # --- parameters --------------------------------------------------------
    def init_params(self) -> None:
        """Draw every weight from one generator seeded with ``seed``, per
        layer in layer order, with the weight's declared initializer;
        trainable ones become parameters, the others state."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for layer in self.layers:
            for w in self._wspecs[int(layer.layer_guid)]:
                dt = w.dtype.to_torch()
                if self._wide and dt == torch.float32:
                    dt = torch.float64
                t = w.initializer(gen, w.shape, dt)
                if w.trainable:
                    params.setdefault(layer.name, {})[w.name] = t.requires_grad_()
                else:
                    state.setdefault(layer.name, {})[w.name] = t
        self.params, self.state = params, state
        self.opt_state = self.optimizer.init_state(self.param_list())

    def weight_tensors(self) -> Dict[Tuple[str, str], torch.Tensor]:
        """Every weight, parameters and state, by ``(layer, weight)``."""
        out = {(l, w): t for l, ws in self.params.items() for w, t in ws.items()}
        out.update({(l, w): t for l, ws in self.state.items() for w, t in ws.items()})
        return out

    def param_list(self) -> List[torch.Tensor]:
        """Trainable parameters in layer order (the optimizer's order)."""
        return [t for ws in self.params.values() for t in ws.values()]

    def param_names(self) -> List[Tuple[str, str]]:
        """``(layer, weight)`` of each parameter, in :meth:`param_list`'s order."""
        return [(l, w) for l, ws in self.params.items() for w in ws]

    def opt_state_by_name(self) -> Dict[str, Any]:
        """The optimizer state in the JAX layout (``optimizer.state_by_name``)."""
        return state_by_name(self.opt_state, self.param_names())

    def opt_writes(self, okey: str, entries: Dict[str, Dict[str, Any]]
                   ) -> List[Tuple[torch.Tensor, np.ndarray]]:
        """Check ``{layer: {weight: array}}`` against optimizer slot
        ``okey`` ("m", "v") and return the ``(tensor, array)`` writes,
        writing nothing; :meth:`apply_writes` applies them."""
        tree = self.opt_state_by_name().get(okey)
        if not isinstance(tree, dict):
            raise KeyError(f"no optimizer slot {okey!r}")
        pending = []
        for lname, ws in entries.items():
            for wname, arr in ws.items():
                cur = tree.get(lname, {}).get(wname)
                if cur is None:
                    raise KeyError(f"unknown opt entry {okey}/{lname}/{wname}")
                a = np.asarray(arr)
                if a.shape != tuple(cur.shape):
                    raise ValueError(f"opt {okey}/{lname}/{wname}: shape {a.shape} != "
                                     f"{tuple(cur.shape)}")
                pending.append((cur, a))
        return pending

    @staticmethod
    def apply_writes(pending: Sequence[Tuple[torch.Tensor, np.ndarray]]) -> None:
        """Copy each host array into its tensor, in place (converted to
        the tensor's dtype)."""
        with torch.no_grad():
            for t, a in pending:
                t.copy_(torch.from_numpy(np.array(a)).to(t.device, t.dtype))

    # --- forward -----------------------------------------------------------
    def _cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        """float32 -> compute dtype (identity in float32; integer tensors
        untouched)."""
        if (self._mixed or self._wide) and x.dtype == torch.float32:
            return x.to(self.compute_dtype)
        return x

    def _layer_seed(self, name: str, step: int) -> int:
        return (self.seed * 1000003 + step * 8191 + zlib.crc32(name.encode())) % (2**31)

    def _forward(self, inputs: Sequence[torch.Tensor], training: bool
                 ) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, Dict[str, torch.Tensor]]]:
        """Run the graph in layer order (layers are appended
        topologically by the builder).  Returns the logits (float32, or
        float64 in a float64 run), the weighted load-balance losses, and
        in training the new state of each stateful layer."""
        values: Dict[int, torch.Tensor] = {
            t.guid: self._cast_compute(x) for t, x in zip(self.graph_inputs, inputs)
        }
        step = self._step_count
        if training:
            self._generator.manual_seed(self.seed * 1000003 + step)
        aux: List[torch.Tensor] = []
        new_state: Dict[str, Dict[str, torch.Tensor]] = {}
        for layer in self.layers:
            opdef = get_op_def(layer.op_type)
            ins = [values[t.guid] for t in layer.inputs]
            lp32 = dict(self.params.get(layer.name, {}))
            lp32.update(self.state.get(layer.name, {}))
            lp = {k: self._cast_compute(v) for k, v in lp32.items()}
            ctx = OpContext(training, self.device, self._generator,
                            self._layer_seed(layer.name, step))
            for t, y in zip(layer.outputs, opdef.forward(layer, lp, ins, ctx)):
                values[t.guid] = y
            if training and layer.name in self.state and hasattr(opdef, "state_update"):
                with torch.no_grad():
                    ins32 = [x.detach().float() if x.dtype == self.compute_dtype and self._mixed
                             else x.detach() for x in ins]
                    new_state[layer.name] = opdef.state_update(
                        layer, {k: v.detach() for k, v in lp32.items()}, ins32)
            if layer.op_type in _AUX_LOSS_OPS and layer.attrs.get("lambda_bal", 0.0) > 0.0:
                # inputs[3] is the full softmax gate (t, n), inputs[1] the assignment
                n = layer.attrs.get("n", layer.attrs.get("n_experts"))
                aux.append(layer.attrs["lambda_bal"] * Aggregate.aux_loss(
                    values[layer.inputs[3].guid], values[layer.inputs[1].guid], n))
        logits = values[self.logits.guid]
        if self._mixed and logits.dtype == self.compute_dtype:
            logits = logits.float()  # loss and metrics in float32
        return logits, aux, new_state

    def place(self, x: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A batch array on the device.  A tensor already there is used as
        it is; a host array is copied through pinned memory without
        blocking the host."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x if dtype is None else x.to(dtype)
        # a read-only or strided host array (a broadcast view) is copied
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.require(x, requirements=("C", "W")))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _place_inputs(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        return [self.place(x, t.dtype.to_torch()) for x, t in zip(inputs, self.graph_inputs)]

    def place_batch(self, batch: Sequence[Any]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """One ``(x0..xk, y)`` batch on the device: the placement stage of
        the fit loop's input pipeline (``dataloader.DevicePrefetcher``).
        ``train_step`` uses the placed tensors as they are."""
        *bx, by = batch
        return self._place_inputs(bx), self.place(by)

    # --- public API --------------------------------------------------------
    def count_host_sync(self, n: int = 1, stall_s: float = 0.0) -> None:
        """Record ``n`` deliberate host syncs of a fit or eval loop and the
        seconds the host spent blocked in them."""
        self.host_syncs += n
        self.host_stall_s += stall_s

    def train_step(self, inputs: Sequence[Any], labels: Any
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step: forward, loss, backward, optimizer update.  Returns
        the loss and the metrics as device tensors, with no host sync."""
        plan = get_fault_plan()
        if plan is not None:
            plan.on_train_step(self)
        xs = self._place_inputs(inputs)
        y = self.place(labels)
        params = self.param_list()
        for p in params:
            p.grad = None
        logits, aux, new_state = self._forward(xs, training=True)
        loss = self.loss_fn(logits, y)
        for a in aux:
            loss = loss + a
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        self.optimizer.update(params, grads, self.opt_state)
        for p in params:
            p.grad = None
        with torch.no_grad():
            for lname, ws in new_state.items():
                for wname, v in ws.items():
                    cur = self.state[lname][wname]
                    cur.copy_(v.to(cur.dtype))
        m = self.metrics.compute(logits.detach(), y) if self.metrics else {}
        self._step_count += 1
        return loss.detach(), m

    @torch.no_grad()
    def forward(self, inputs: Sequence[Any]) -> torch.Tensor:
        """Inference forward (training off): the final output (float32,
        or float64 in a float64 run)."""
        return self._forward(self._place_inputs(inputs), training=False)[0]
