"""The training step: forward, loss, backward, optimizer update.

Counterpart of ``flexflow_tpu/runtime/executor.py`` ``Executor``.  The
JAX executor traces the graph into one jitted program; here the same
graph runs eagerly in layer order, autograd gives the backward (through
the flash kernels' own backward where the attention core takes them),
and the optimizer updates the parameters in place.

Parameters are created per layer, in layer order, as
``params[layer][weight]`` float32 tensors on the device.  They are not
depth-stacked: the JAX ``_stack_param_buckets`` is a storage layout that
its ``get_weights`` hides, so both packages expose the same per-layer
dictionary.

Mixed precision (``compute_dtype="bfloat16"``) follows the JAX
executor: master params, optimizer moments, loss and metrics stay
float32; graph inputs and params are cast to the compute dtype at use
(the cast's backward gives float32 gradients); the logits are cast back
to float32 before the loss.

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

from flexflow_tpu_torch.fftype import LossType
from flexflow_tpu_torch.loss import get_loss_fn
from flexflow_tpu_torch.metrics import Metrics
from flexflow_tpu_torch.ops.base import OpContext, get_op_def
from flexflow_tpu_torch.optimizer import Optimizer, state_by_name
from flexflow_tpu_torch.runtime.faults import get_fault_plan
from flexflow_tpu_torch.tensor import Layer, Tensor

__all__ = ["Executor"]

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
            raise ValueError(f"compute_dtype {compute_dtype!r}: expected float32 or bfloat16")
        self.layers = layers
        self.graph_inputs = graph_inputs
        self.logits = logits
        self.optimizer = optimizer
        self.loss_fn = get_loss_fn(loss_type)
        self.metrics = metrics
        self.device = device
        self.seed = int(seed)
        self.compute_dtype = _COMPUTE_DTYPES[compute_dtype]
        self._mixed = self.compute_dtype != torch.float32
        self._wspecs = {int(l.layer_guid): get_op_def(l.op_type).weights(l) for l in layers}
        self._generator = torch.Generator(device=device)
        self._step_count = 0
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.opt_state: Any = None
        # deliberate host syncs of the fit/eval loops, and the seconds
        # the host spent blocked in them
        self.host_syncs = 0
        self.host_stall_s = 0.0
        self.dcn_degraded = False  # set by a dcn_degrade fault

    # --- parameters --------------------------------------------------------
    def init_params(self) -> None:
        """Draw every weight from one generator seeded with ``seed``, per
        layer in layer order, with the weight's declared initializer."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for layer in self.layers:
            for w in self._wspecs[int(layer.layer_guid)]:
                t = w.initializer(gen, w.shape, w.dtype.to_torch())
                params.setdefault(layer.name, {})[w.name] = t.requires_grad_()
        self.params = params
        self.opt_state = self.optimizer.init_state(self.param_list())

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
        """Copy each host array into its tensor, in place."""
        with torch.no_grad():
            for t, a in pending:
                t.copy_(torch.from_numpy(np.array(a, np.float32)).to(t.device, t.dtype))

    # --- forward -----------------------------------------------------------
    def _cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        """float32 -> compute dtype (identity when not mixed; integer
        tensors untouched)."""
        if self._mixed and x.dtype == torch.float32:
            return x.to(self.compute_dtype)
        return x

    def _layer_seed(self, name: str, step: int) -> int:
        return (self.seed * 1000003 + step * 8191 + zlib.crc32(name.encode())) % (2**31)

    def _forward(self, inputs: Sequence[torch.Tensor], training: bool) -> torch.Tensor:
        """Run the graph in layer order (layers are appended
        topologically by the builder); returns float32 logits."""
        values: Dict[int, torch.Tensor] = {
            t.guid: self._cast_compute(x) for t, x in zip(self.graph_inputs, inputs)
        }
        step = self._step_count
        if training:
            self._generator.manual_seed(self.seed * 1000003 + step)
        for layer in self.layers:
            opdef = get_op_def(layer.op_type)
            ins = [values[t.guid] for t in layer.inputs]
            lp = {k: self._cast_compute(v) for k, v in self.params.get(layer.name, {}).items()}
            ctx = OpContext(training, self.device, self._generator,
                            self._layer_seed(layer.name, step))
            for t, y in zip(layer.outputs, opdef.forward(layer, lp, ins, ctx)):
                values[t.guid] = y
        logits = values[self.logits.guid]
        if self._mixed and logits.dtype == self.compute_dtype:
            logits = logits.float()  # loss and metrics in float32
        return logits

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
        logits = self._forward(xs, training=True)
        loss = self.loss_fn(logits, y)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        self.optimizer.update(params, grads, self.opt_state)
        for p in params:
            p.grad = None
        m = self.metrics.compute(logits.detach(), y) if self.metrics else {}
        self._step_count += 1
        return loss.detach(), m

    @torch.no_grad()
    def forward(self, inputs: Sequence[Any]) -> torch.Tensor:
        """Inference forward (training off): the float32 final output."""
        return self._forward(self._place_inputs(inputs), training=False)
