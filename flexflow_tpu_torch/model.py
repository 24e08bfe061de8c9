"""``FFModel``: the layer-builder API, compile, the fit loop, and
checkpoints.

Counterpart of ``flexflow_tpu/model.py`` ``FFModel`` on one device: the
single-device builders (``create_tensor``, ``dense``, ``conv2d``,
``pool2d``, ``batch_norm``, ``layer_norm``, ``rms_norm``, ``embedding``,
``gather``, ``multihead_attention``, ``softmax``, ``dropout``, ``flat``,
``concat``, ``split``, ``reshape``, ``transpose``, ``reverse``,
``reduce_sum``, ``reduce_mean``, ``batch_matmul``, ``cast``, ``top_k``,
the MoE ops ``group_by``, ``aggregate``, ``aggregate_spec``, ``experts``
and the composite ``moe``, ``cache``, ``parameter``, and the binary,
unary and scalar elementwise ops; same signatures and layer names),
``compile``, ``fit`` / ``eval`` / ``eval_batch``, ``get_weights`` /
``set_weights`` / ``num_parameters``, and ``save_checkpoint`` /
``load_checkpoint``.  The parallel ops (``repartition``, ``combine``,
``replicate``, ``reduction``, ``fused_parallel_op``) are mesh
parallelism, ROADMAP.md queue A item 5.

:meth:`FFModel.set_weights` carries weights across frameworks: it takes
the per-layer ``{layer: {weight: np.ndarray}}`` dictionary that the JAX
``FFModel.get_weights()`` returns, parameters and state (BatchNorm's
running stats) together, and checks every name and shape before it
writes anything.

:meth:`FFModel.fit` is the JAX loop's: loader thread, look-ahead
placement (``dataloader.py``), then the step; metrics stay on the device
and are read every K steps and at the end of each epoch, one counted
host sync each (``Executor.host_syncs``).  ``checkpoint_every`` writes a
checkpoint every K optimizer steps: the host snapshot is one counted
sync, the file is written on a background thread.  ``resume=`` restores
weights, moments, the step count (which keys dropout's seeds) and the
loader's cursor, so a killed and resumed run ends bit for bit where the
uninterrupted run ends.  ``RecompileState``, ``RecoveryPolicy`` and the
run-health monitor are not ported: ``fit`` raises ``NotImplementedError``
when it is given them.

Checkpoints are ``ffckpt/2``: one ``.npz`` written atomically
(:func:`_write_checkpoint_atomic`), with keys ``params/<layer>/<w>``,
``state/<layer>/<w>`` (non-trainable weights), ``opt/<m|v>/<layer>/<w>``,
``opt_scalar/step`` (int32) and ``meta/step_count``, and a manifest
(``meta/manifest``: schema, step, rng seed, loader cursor, a null
strategy, and a content digest).  The
digest hashes each array's key, dtype string, shape and bytes as the JAX
package does, so a file written by either package loads in the other.
The serve drain (``ffdrain/1``) and the ``ffkv/1`` frames use the same
writer and digest.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
import zipfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import flexflow_tpu_torch.ops  # noqa: F401  (registers every OpDef)
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.dataloader import BatchIterator, DevicePrefetcher, SingleDataLoader
from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.fftype import (
    ActiMode, AggrMode, DataType, LossType, MetricsType, OperatorType, PoolType,
)
from flexflow_tpu_torch.initializer import Initializer
from flexflow_tpu_torch.metrics import DeviceMetricAccumulator, Metrics, PerfMetrics
from flexflow_tpu_torch.ops.base import get_op_def
from flexflow_tpu_torch.optimizer import Optimizer, SGDOptimizer
from flexflow_tpu_torch.runtime.executor import Executor
from flexflow_tpu_torch.runtime.faults import configure_faults_from_config
from flexflow_tpu_torch.tensor import Layer, Tensor

__all__ = ["FFModel", "CheckpointError", "CHECKPOINT_SCHEMA", "DEFAULT_METRICS_SYNC_EVERY"]

# the fit loop's metric flush cadence when metrics_sync_every is 0 (auto)
DEFAULT_METRICS_SYNC_EVERY = 32

CHECKPOINT_SCHEMA = "ffckpt/2"


class CheckpointError(RuntimeError):
    """A checkpoint file that must not be loaded: a torn or truncated
    write, an unreadable manifest, or a content-digest mismatch.  The
    message names what failed."""


def _checkpoint_digest(flat: Dict[str, np.ndarray]) -> str:
    """Content digest over the payload arrays: keys in sorted order, each
    with its dtype string and shape, so a reinterpreted buffer fails too."""
    h = hashlib.sha256()
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return f"sha256:{h.hexdigest()}"


def _write_checkpoint_atomic(path: str, flat: Dict[str, np.ndarray],
                             manifest: Dict[str, Any]) -> str:
    """Write ``flat`` plus ``manifest`` (with the content digest added) as
    one ``.npz``: a temp file in the target directory, flush, fsync,
    ``os.replace``, then an fsync of the directory, so a reader sees the
    previous complete file or the new complete one, never a torn one.
    ``.npz`` is appended when missing.  Returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    manifest = dict(manifest)
    manifest["digest"] = _checkpoint_digest(flat)
    payload = dict(flat)
    payload["meta/manifest"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    # fsync the directory so the rename itself survives a power cut (not
    # every filesystem opens a directory for reading)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return path


class _CheckpointWriter:
    """One background thread that writes the fit loop's checkpoints off
    the step path.  The queue holds one snapshot: if the previous write
    is still running, the next hand-over blocks (backpressure, not an
    unbounded pile of host copies)."""

    def __init__(self) -> None:
        self._q: "queue.Queue[Optional[Tuple[str, Dict[str, np.ndarray], Dict[str, Any]]]]" = (
            queue.Queue(maxsize=1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, name="ffckpt-writer", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                _write_checkpoint_atomic(*item)
            except BaseException as e:  # raised at the next put or flush
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(f"background checkpoint write failed: {err}") from err

    def put(self, path: str, flat: Dict[str, np.ndarray], manifest: Dict[str, Any]) -> None:
        self._raise_pending()
        self._q.put((path, flat, manifest))

    def flush(self) -> None:
        """Block until every queued write is on disk; raise a failed one."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the thread, raise a failed write."""
        self._q.join()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    def shutdown(self) -> None:
        """Drain and stop without raising, for an error path: a failed
        write must not mask the error that is already on its way out."""
        try:
            self._q.join()
            self._q.put(None)
            self._thread.join()
        except BaseException:
            pass


def _host_copies(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host numpy copies of ``tensors`` (never views of live device or CPU
    storage), with one host sync: on CUDA each copy is queued into
    pinned memory without blocking, then the stream is synchronised
    once."""
    if not tensors:
        return []
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.detach().clone().numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t.detach(), non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [o.numpy() for o in outs]


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None) -> None:
        self.config = config or FFConfig()
        # the fault plan of --fault-plan; an unset field leaves the
        # process's current plan alone
        configure_faults_from_config(self.config)
        self.layers: List[Layer] = []
        self.graph_inputs: List[Tensor] = []
        self._name_counts: Dict[str, int] = {}
        self.executor: Optional[Executor] = None
        # the loader's position after the most recent fit step: what a
        # checkpoint's manifest records so that resume replays the batches
        self._fit_cursor: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ util
    def _name(self, base: str, name: Optional[str]) -> str:
        if name:
            return name
        n = self._name_counts.get(base, 0)
        self._name_counts[base] = n + 1
        return f"{base}_{n}"

    def _add_layer(self, op_type: OperatorType, name: str, inputs: List[Tensor],
                   attrs: Dict[str, Any]) -> List[Tensor]:
        layer = Layer(op_type, name, inputs, attrs)
        for i, (shape, dtype) in enumerate(get_op_def(op_type).infer(layer)):
            layer.outputs.append(
                Tensor(shape, dtype, owner_layer=layer, owner_idx=i, name=f"{name}:{i}"))
        self.layers.append(layer)
        return layer.outputs

    # ---------------------------------------------------------- input tensors
    def create_tensor(self, shape: Sequence[int], dtype: DataType = DataType.FLOAT,
                      name: Optional[str] = None) -> Tensor:
        """A graph input; ``shape`` includes the batch dim (dim 0)."""
        t = Tensor(tuple(shape), dtype, name=name or f"input_{len(self.graph_inputs)}")
        self.graph_inputs.append(t)
        return t

    # ------------------------------------------------------------- layer API
    def dense(self, input: Tensor, out_dim: int, activation: ActiMode = ActiMode.NONE,
              use_bias: bool = True, kernel_initializer: Optional[Initializer] = None,
              bias_initializer: Optional[Initializer] = None,
              name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.LINEAR, self._name("dense", name), [input],
            dict(out_dim=out_dim, activation=activation, use_bias=use_bias,
                 kernel_initializer=kernel_initializer, bias_initializer=bias_initializer),
        )[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.NONE, dtype: DataType = DataType.FLOAT,
                  kernel_initializer: Optional[Initializer] = None,
                  name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.EMBEDDING, self._name("embedding", name), [input],
            dict(num_entries=num_entries, out_dim=out_dim, aggr=aggr, dtype=dtype,
                 kernel_initializer=kernel_initializer),
        )[0]

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               activation: ActiMode = ActiMode.NONE, groups: int = 1, use_bias: bool = True,
               kernel_initializer: Optional[Initializer] = None,
               bias_initializer: Optional[Initializer] = None,
               name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.CONV2D, self._name("conv2d", name), [input],
            dict(out_channels=out_channels, kernel_h=kernel_h, kernel_w=kernel_w,
                 stride_h=stride_h, stride_w=stride_w, padding_h=padding_h,
                 padding_w=padding_w, activation=activation, groups=groups, use_bias=use_bias,
                 kernel_initializer=kernel_initializer, bias_initializer=bias_initializer),
        )[0]

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
               padding_h: int, padding_w: int, pool_type: PoolType = PoolType.MAX,
               activation: ActiMode = ActiMode.NONE, name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.POOL2D, self._name("pool2d", name), [input],
            dict(kernel_h=kernel_h, kernel_w=kernel_w, stride_h=stride_h, stride_w=stride_w,
                 padding_h=padding_h, padding_w=padding_w, pool_type=pool_type,
                 activation=activation),
        )[0]

    def batch_norm(self, input: Tensor, relu: bool = True, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.BATCHNORM, self._name("batch_norm", name), [input],
                               dict(relu=relu))[0]

    def rms_norm(self, input: Tensor, eps: float = 1e-6, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.RMS_NORM, self._name("rms_norm", name), [input],
                               dict(eps=eps))[0]

    def parameter(self, shape: Sequence[int], dtype: DataType = DataType.FLOAT,
                  initializer: Optional[Initializer] = None, trainable: bool = True,
                  name: Optional[str] = None) -> Tensor:
        """A free tensor with no producing layer (weight ``value``): a
        parameter, or state when ``trainable=False`` or ``dtype`` is not
        a float type."""
        return self._add_layer(
            OperatorType.WEIGHT, self._name("parameter", name), [],
            dict(shape=tuple(shape), dtype=dtype, initializer=initializer,
                 trainable=trainable),
        )[0]

    def cache(self, input: Tensor, name: Optional[str] = None) -> Tensor:
        """Passes ``input`` through and keeps its last training batch as
        state (``ops/tensor_ops.py`` ``Cache``)."""
        return self._add_layer(OperatorType.CACHE, self._name("cache", name), [input], {})[0]

    def layer_norm(self, input: Tensor, axes: Sequence[int], elementwise_affine: bool = True,
                   eps: float = 1e-5, name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.LAYERNORM, self._name("layer_norm", name), [input],
            dict(axes=tuple(a % input.ndim for a in axes),
                 elementwise_affine=elementwise_affine, eps=eps),
        )[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor, embed_dim: int,
                            num_heads: int, kdim: int = 0, vdim: int = 0, dropout: float = 0.0,
                            causal: bool = False, use_flash: bool = True, bias: bool = False,
                            kernel_initializer: Optional[Initializer] = None,
                            name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.MULTIHEAD_ATTENTION, self._name("attention", name),
            [query, key, value],
            dict(embed_dim=embed_dim, num_heads=num_heads, kdim=kdim or None,
                 vdim=vdim or None, dropout=dropout, causal=causal, use_flash=use_flash,
                 bias=bias, kernel_initializer=kernel_initializer),
        )[0]

    def softmax(self, input: Tensor, dim: int = -1, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.SOFTMAX, self._name("softmax", name), [input],
                               dict(dim=dim))[0]

    def dropout(self, input: Tensor, rate: float, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.DROPOUT, self._name("dropout", name), [input],
                               dict(rate=rate, seed=seed))[0]

    def flat(self, input: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.FLAT, self._name("flat", name), [input], {})[0]

    def concat(self, tensors: Sequence[Tensor], axis: int, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.CONCAT, self._name("concat", name), list(tensors),
                               dict(axis=axis))[0]

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]], axis: int,
              name: Optional[str] = None) -> List[Tensor]:
        """Split ``axis`` into ``sizes`` pieces, or into ``sizes`` equal
        pieces when it is an int."""
        if isinstance(sizes, int):
            if input.shape[axis] % sizes:
                raise ValueError(f"split: dim {axis} of {input.shape} is not divisible by "
                                 f"{sizes}")
            sizes = [input.shape[axis] // sizes] * sizes
        return self._add_layer(OperatorType.SPLIT, self._name("split", name), [input],
                               dict(sizes=tuple(sizes), axis=axis))

    def reshape(self, input: Tensor, shape: Sequence[int], name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.RESHAPE, self._name("reshape", name), [input],
                               dict(shape=tuple(shape)))[0]

    def transpose(self, input: Tensor, perm: Sequence[int], name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.TRANSPOSE, self._name("transpose", name), [input],
                               dict(perm=tuple(perm)))[0]

    def reverse(self, input: Tensor, axis: int, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.REVERSE, self._name("reverse", name), [input],
                               dict(axis=axis))[0]

    def reduce_sum(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                   name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.REDUCE_SUM, self._name("reduce_sum", name),
                               [input], dict(axes=tuple(axes), keepdims=keepdims))[0]

    def reduce_mean(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                    name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.REDUCE_MEAN, self._name("reduce_mean", name),
                               [input], dict(axes=tuple(axes), keepdims=keepdims))[0]

    def batch_matmul(self, a: Tensor, b: Tensor, a_seq_length_dim: Optional[int] = None,
                     b_seq_length_dim: Optional[int] = None,
                     name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OperatorType.BATCHMATMUL, self._name("batch_matmul", name), [a, b],
            dict(a_seq_length_dim=a_seq_length_dim, b_seq_length_dim=b_seq_length_dim),
        )[0]

    def gather(self, data: Tensor, index: Tensor, dim: int = 0,
               name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.GATHER, self._name("gather", name), [data, index],
                               dict(dim=dim))[0]

    def cast(self, input: Tensor, dtype: DataType, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.CAST, self._name("cast", name), [input],
                               dict(dtype=dtype))[0]

    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name: Optional[str] = None) -> List[Tensor]:
        """(values, int32 indices) of the ``k`` largest along the last dim."""
        return self._add_layer(OperatorType.TOPK, self._name("topk", name), [input],
                               dict(k=k, sorted=sorted))

    # ------------------------------------------------------------------- MoE
    def group_by(self, data: Tensor, assign: Tensor, n_experts: int, alpha: float = 1.0,
                 name: Optional[str] = None) -> List[Tensor]:
        return self._add_layer(OperatorType.GROUP_BY, self._name("group_by", name),
                               [data, assign], dict(n_experts=n_experts, alpha=alpha))

    def aggregate(self, inputs: Sequence[Tensor], n: int, lambda_bal: float = 0.0,
                  name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.AGGREGATE, self._name("aggregate", name),
                               list(inputs), dict(n=n, lambda_bal=lambda_bal))[0]

    def aggregate_spec(self, inputs: Sequence[Tensor], n: int, lambda_bal: float = 0.0,
                       name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.AGGREGATE_SPEC, self._name("aggregate_spec", name),
                               list(inputs), dict(n=n, lambda_bal=lambda_bal))[0]

    def experts(self, input: Tensor, assign: Tensor, gate_preds: Tensor, gate_full: Tensor,
                num_experts: int, hidden: int, alpha: float = 2.0, lambda_bal: float = 0.0,
                name: Optional[str] = None) -> Tensor:
        """The fused expert block (``ops/moe.py`` ``Experts``)."""
        return self._add_layer(
            OperatorType.EXPERTS, self._name("experts", name),
            [input, assign, gate_preds, gate_full],
            dict(n_experts=num_experts, hidden=hidden, alpha=alpha, lambda_bal=lambda_bal),
        )[0]

    def moe(self, input: Tensor, num_exp: int, num_select: int, expert_hidden_size: int,
            alpha: float = 2.0, lambda_bal: float = 0.04, fused: bool = False,
            name: Optional[str] = None) -> Tensor:
        """gate -> top_k -> group_by -> per-expert dense pairs -> aggregate;
        ``fused=True`` takes the one ``experts`` op for the tail."""
        gate = self.dense(input, num_exp, ActiMode.NONE, name=self._name("moe_gate", name))
        gate = self.softmax(gate)
        topk_out, topk_idx = self.top_k(gate, num_select)
        if fused:
            return self.experts(input, topk_idx, topk_out, gate, num_exp, expert_hidden_size,
                                alpha, lambda_bal, name=self._name("moe_experts", name))
        grouped = self.group_by(input, topk_idx, num_exp, alpha)
        experts = [self.dense(self.dense(g, expert_hidden_size, ActiMode.RELU), input.shape[-1])
                   for g in grouped]
        return self.aggregate([topk_out, topk_idx, topk_idx, gate] + experts, num_exp,
                              lambda_bal)

    # ----------------------------------------------------------- elementwise
    def add(self, x: Tensor, y: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.EW_ADD, self._name("add", name), [x, y], {})[0]

    def subtract(self, x: Tensor, y: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.EW_SUB, self._name("sub", name), [x, y], {})[0]

    def multiply(self, x: Tensor, y: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.EW_MUL, self._name("mul", name), [x, y], {})[0]

    def divide(self, x: Tensor, y: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.EW_DIV, self._name("div", name), [x, y], {})[0]

    def max(self, x: Tensor, y: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.EW_MAX, self._name("max", name), [x, y], {})[0]

    def min(self, x: Tensor, y: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.EW_MIN, self._name("min", name), [x, y], {})[0]

    def _unary(self, op: OperatorType, x: Tensor, name: Optional[str], **attrs) -> Tensor:
        return self._add_layer(op, self._name(op.value, name), [x], attrs)[0]

    def relu(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.RELU, x, name)

    def sigmoid(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.SIGMOID, x, name)

    def tanh(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.TANH, x, name)

    def elu(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.ELU, x, name)

    def gelu(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.GELU, x, name)

    def exp(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.EXP, x, name)

    def sin(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.SIN, x, name)

    def cos(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.COS, x, name)

    def rsqrt(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.RSQRT, x, name)

    def pow(self, x: Tensor, exponent: float, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.POW, x, name, exponent=exponent)

    def identity(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.IDENTITY, x, name)

    def scalar_multiply(self, x: Tensor, scalar: float, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.SCALAR_MULTIPLY, x, name, scalar=scalar)

    def scalar_add(self, x: Tensor, scalar: float, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.SCALAR_ADD, x, name, scalar=scalar)

    def scalar_sub(self, x: Tensor, scalar: float, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.SCALAR_SUB, x, name, scalar=scalar)

    def scalar_true_divide(self, x: Tensor, scalar: float, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.SCALAR_TRUE_DIV, x, name, scalar=scalar)

    # ---------------------------------------------------------------- compile
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: LossType = LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[MetricsType] = (), seed: Optional[int] = None) -> None:
        """Build the executor on ``config.device`` and initialise the
        weights.  The optimizer defaults to SGD at the config's learning
        rate and weight decay, as in the JAX package."""
        if not self.layers:
            raise ValueError("compile: the model has no layers")
        cfg = self.config
        optimizer = optimizer or SGDOptimizer(lr=cfg.learning_rate,
                                              weight_decay=cfg.weight_decay)
        self.executor = Executor(
            self.layers, self.graph_inputs, self.layers[-1].outputs[0], optimizer, loss_type,
            Metrics(loss_type, metrics) if metrics else None, resolve_device(cfg.device),
            seed=cfg.seed if seed is None else seed, compute_dtype=cfg.compute_dtype,
        )
        self.executor.init_params()

    # ------------------------------------------------------------ weights
    def _require_executor(self) -> Executor:
        if self.executor is None:
            raise RuntimeError("the model is not compiled")
        return self.executor

    def get_weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Host copy of every weight, parameters and state,
        ``{layer: {weight: np.ndarray}}``: copies, never views of the live
        tensors (on the CPU too)."""
        ex = self._require_executor()
        named = ex.weight_tensors()
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for (lname, w), arr in zip(named, _host_copies(list(named.values()))):
            out.setdefault(lname, {})[w] = arr
        return out

    def _weight_writes(self, weights: Mapping[str, Mapping[str, Any]]):
        """Check ``weights`` against the model's and return the writes."""
        ex = self._require_executor()
        want = ex.weight_tensors()
        got = {(l, w): np.asarray(a) for l, ws in weights.items() for w, a in ws.items()}
        missing = sorted("/".join(k) for k in set(want) - set(got))
        extra = sorted("/".join(k) for k in set(got) - set(want))
        if missing or extra:
            raise ValueError(f"set_weights: missing {missing or 'none'}, extra {extra or 'none'}")
        for key, arr in got.items():
            if arr.shape != tuple(want[key].shape):
                raise ValueError(f"set_weights: {'/'.join(key)} has shape {arr.shape}, the "
                                 f"model expects {tuple(want[key].shape)}")
        return [(want[key], arr) for key, arr in got.items()]

    def set_weights(self, weights: Mapping[str, Mapping[str, Any]]) -> None:
        """Write every weight, parameters and state, from
        ``{layer: {weight: array}}`` (the JAX ``get_weights()`` layout).
        Raises ``ValueError`` on a missing, extra or mis-shaped entry
        before anything is written."""
        self._require_executor().apply_writes(self._weight_writes(weights))

    def num_parameters(self) -> int:
        """Elements of the trainable parameters (state not counted)."""
        ex = self._require_executor()
        return sum(t.numel() for ws in ex.params.values() for t in ws.values())

    # -------------------------------------------------------------- fit
    def _resolve_metrics_sync_every(self, override: Optional[int] = None) -> int:
        """K of the K-step metric flush: 1 under ``profiling``, else the
        explicit value, or ``DEFAULT_METRICS_SYNC_EVERY`` when it is 0."""
        if self.config.profiling:
            return 1
        k = override if override is not None else self.config.metrics_sync_every
        return int(k) if k and k > 0 else DEFAULT_METRICS_SYNC_EVERY

    def _flush_metrics(self, acc: DeviceMetricAccumulator, pm: PerfMetrics) -> None:
        """Drain the window's device sums into ``pm``: one counted sync."""
        if acc.count == 0:
            return
        t0 = time.perf_counter()
        sums, count = acc.drain()
        self.executor.count_host_sync(1, stall_s=time.perf_counter() - t0)
        pm.merge_sums(sums, count)

    def fit(self, x: Union[np.ndarray, Sequence[np.ndarray]], y: np.ndarray,
            batch_size: Optional[int] = None, epochs: Optional[int] = None,
            verbose: bool = True, shuffle: bool = False, seed: int = 0,
            recompile_state: Any = None, metrics_sync_every: Optional[int] = None,
            resume: Optional[str] = None, checkpoint_every: Optional[int] = None,
            checkpoint_path: Optional[str] = None, recovery: Any = None) -> PerfMetrics:
        """Train for ``epochs`` epochs over ``(x, y)`` (one array per graph
        input, then the labels), ``batch_size`` rows a step, a trailing
        partial batch dropped.  Returns the last epoch's metrics.

        ``shuffle`` reshuffles the rows at every epoch from ``seed`` (the
        JAX loader's order).  ``resume`` (or ``config.resume_from``)
        loads a checkpoint and continues from its cursor: it refuses a
        cursor written with another shuffle, seed or batch count, replays
        the loader's reshuffles up to the cursor's epoch and skips the
        batches already trained.  ``checkpoint_every`` /
        ``checkpoint_path`` (or the config's) write a checkpoint every K
        optimizer steps on a background thread."""
        self._require_executor()
        cfg = self.config
        if recompile_state is not None:
            raise NotImplementedError(
                "fit(recompile_state=...): RecompileState is not ported "
                "(ROADMAP.md queue A item 3)")
        if recovery is not None:
            raise NotImplementedError(
                "fit(recovery=...): RecoveryPolicy is not ported; elastic recovery needs "
                "the strategy search (ROADMAP.md queue A item 3, after item 4)")
        if cfg.health != "off":
            raise NotImplementedError(
                f"health={cfg.health!r}: the run-health monitor (obs/health.py, and with it "
                f"--health restore) is not ported (ROADMAP.md queue A item 6)")
        if resume is None:
            resume = cfg.resume_from or None
        ckpt_every = checkpoint_every if checkpoint_every is not None else cfg.checkpoint_every
        ckpt_path = checkpoint_path if checkpoint_path is not None else cfg.checkpoint_path
        if ckpt_path and not ckpt_path.endswith(".npz"):
            ckpt_path += ".npz"
        bs = batch_size or cfg.batch_size
        epochs = epochs or cfg.epochs
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        depth = max(1, cfg.prefetch_depth)
        loaders = [SingleDataLoader(a, bs, shuffle=shuffle, seed=seed) for a in xs]
        loaders.append(SingleDataLoader(y, bs, shuffle=shuffle, seed=seed))
        # one seed for every loader: the same permutation keeps rows aligned
        it = BatchIterator(loaders, prefetch_depth=depth)
        nb = it.num_batches
        if nb == 0:
            raise ValueError(f"dataset has {len(xs[0])} samples < batch_size {bs}: zero batches")
        K = self._resolve_metrics_sync_every(metrics_sync_every)

        start_epoch, skip_batches = 0, 0
        if resume:
            manifest = self.load_checkpoint(resume)
            cursor = (manifest or {}).get("loader")
            if cursor:
                if (bool(cursor.get("shuffle", False)) != bool(shuffle)
                        or int(cursor.get("seed", 0)) != int(seed)):
                    raise CheckpointError(
                        f"resume {resume!r}: checkpoint was written with "
                        f"shuffle={cursor.get('shuffle')}/seed={cursor.get('seed')} but fit "
                        f"was called with shuffle={shuffle}/seed={seed}: the data order "
                        f"would diverge; pass the original values")
                if int(cursor.get("batches", nb)) != nb:
                    raise CheckpointError(
                        f"resume {resume!r}: checkpoint saw {cursor.get('batches')} "
                        f"batches/epoch, this fit has {nb}: the dataset or batch size "
                        f"changed, so the saved cursor does not map onto this run")
                start_epoch = int(cursor.get("epoch", 0))
                skip_batches = int(cursor.get("batch", 0))
                if skip_batches >= nb:  # written after an epoch's last step
                    start_epoch, skip_batches = start_epoch + 1, 0
            # replay the reshuffles of the epochs before start_epoch; the
            # loop below makes the one for start_epoch
            for _ in range(start_epoch):
                it.reset()

        writer = (_CheckpointWriter() if (ckpt_every and ckpt_every > 0 and ckpt_path)
                  else None)
        prefetch = DevicePrefetcher(it, lambda b: self.executor.place_batch(b), depth=depth)
        ok = False
        try:
            pm = self._fit_loop(prefetch=prefetch, it=it, epochs=epochs, nb=nb, bs=bs, K=K,
                                verbose=verbose, shuffle=shuffle, seed=seed,
                                start_epoch=start_epoch, skip_batches=skip_batches,
                                writer=writer, ckpt_every=ckpt_every, ckpt_path=ckpt_path)
            ok = True
        finally:
            if writer is not None:
                if ok:
                    writer.close()
                else:
                    writer.shutdown()
        return pm

    def _fit_loop(self, *, prefetch, it, epochs, nb, bs, K, verbose, shuffle, seed,
                  start_epoch, skip_batches, writer, ckpt_every, ckpt_path) -> PerfMetrics:
        """The epoch and batch loops of :meth:`fit`."""
        ex = self.executor
        pm = PerfMetrics()
        loss = None
        for epoch in range(start_epoch, epochs):
            it.reset()
            pm = PerfMetrics()  # per-epoch metrics
            acc = DeviceMetricAccumulator()
            for bi, (inputs, labels) in enumerate(prefetch):
                if epoch == start_epoch and bi < skip_batches:
                    continue  # trained before the checkpoint: skip, keep the order
                loss, m = ex.train_step(inputs, labels)
                # the position after this step, which a checkpoint written
                # now records
                self._fit_cursor = {"epoch": epoch, "batch": bi + 1, "shuffle": bool(shuffle),
                                    "seed": int(seed), "batches": nb}
                if writer is not None and ex._step_count % ckpt_every == 0:
                    t0 = time.perf_counter()
                    flat, manifest = self._snapshot_checkpoint()
                    ex.count_host_sync(1, stall_s=time.perf_counter() - t0)
                    writer.put(ckpt_path, flat, manifest)
                if K <= 1:
                    t0 = time.perf_counter()
                    keys = list(m)
                    vals = torch.stack([loss.reshape(())] + [m[k].reshape(()) for k in keys])
                    vals = vals.float().cpu().tolist()
                    ex.count_host_sync(1, stall_s=time.perf_counter() - t0)
                    pm.update(dict(zip(keys, vals[1:])), bs)
                    continue
                acc.add(m, bs)
                if (bi + 1) % K == 0 or bi + 1 == nb:
                    self._flush_metrics(acc, pm)
            if verbose and loss is not None:
                # the epoch's last flush has already waited for its last step
                print(f"epoch {epoch}: loss={float(loss):.4f} accuracy={pm.accuracy:.4f} "
                      f"throughput={pm.throughput():.2f} samples/s")
        return pm

    def eval(self, x: Union[np.ndarray, Sequence[np.ndarray]], y: np.ndarray,
             batch_size: Optional[int] = None, verbose: bool = False) -> PerfMetrics:
        """Loss and metrics with training off over the whole dataset,
        batch by batch, with one host sync for the pass.  A tail batch
        shorter than ``batch_size`` is padded to the compiled batch by
        repeating its last row; only its real rows enter the metrics."""
        ex = self._require_executor()
        bs = batch_size or self.config.batch_size
        xs = [np.asarray(a) for a in (x if isinstance(x, (list, tuple)) else [x])]
        ya = np.asarray(y)
        n = xs[0].shape[0]
        if any(a.shape[0] != n for a in xs) or ya.shape[0] != n:
            raise ValueError(f"inputs and labels disagree on the sample count: "
                             f"{[a.shape[0] for a in xs]} against labels {ya.shape[0]}")

        def batches():
            for start in range(0, n, bs):
                rows = min(bs, n - start)
                bx = [a[start:start + rows] for a in xs]
                if rows < bs:
                    bx = [np.concatenate([b, np.repeat(b[-1:], bs - rows, axis=0)]) for b in bx]
                yield bx, ya[start:start + rows], rows

        def place(item):
            bx, yb, rows = item
            return ex._place_inputs(bx), ex.place(yb), rows

        pm = PerfMetrics()
        acc = DeviceMetricAccumulator()
        prefetch = DevicePrefetcher(batches(), place, depth=max(1, self.config.prefetch_depth))
        for placed, yb, rows in prefetch:
            probs = ex.forward(placed)
            m = ex.metrics.compute(probs[:rows], yb) if ex.metrics else {}
            acc.add(m, rows)
        t0 = time.perf_counter()
        sums, count = acc.drain()
        ex.count_host_sync(1, stall_s=time.perf_counter() - t0)
        pm.merge_sums(sums, count)
        if verbose:
            print(f"eval: accuracy={pm.accuracy:.4f}")
        return pm

    def eval_batch(self, x: Sequence[Any]) -> torch.Tensor:
        """Inference forward (training off) on one batch: the final op's
        float32 output as a device tensor."""
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        return self._require_executor().forward(xs)

    # ----------------------------------------------------- checkpoints
    def _snapshot_checkpoint(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Host copy of the training state (one host sync; the caller
        counts it) and the ``ffckpt/2`` manifest."""
        ex = self._require_executor()
        keys: List[str] = []
        tensors: List[torch.Tensor] = []
        for prefix, tree in (("params", ex.params), ("state", ex.state)):
            for lname, ws in tree.items():
                for wname, t in ws.items():
                    keys.append(f"{prefix}/{lname}/{wname}")
                    tensors.append(t)
        named = ex.opt_state_by_name()
        for slot, tree in named.items():
            if slot == "step":
                continue
            for lname, ws in tree.items():
                for wname, t in ws.items():
                    keys.append(f"opt/{slot}/{lname}/{wname}")
                    tensors.append(t)
        flat = dict(zip(keys, _host_copies(tensors)))
        flat["opt_scalar/step"] = np.asarray(named["step"], np.int32)
        flat["meta/step_count"] = np.asarray(ex._step_count)
        manifest: Dict[str, Any] = {
            "schema": CHECKPOINT_SCHEMA,
            "step": int(ex._step_count),
            "rng_seed": int(ex.seed),
            "strategy": None,
            "loader": dict(self._fit_cursor) if self._fit_cursor else None,
        }
        return flat, manifest

    def save_checkpoint(self, path: str) -> str:
        """Weights (parameters and state), optimizer state, step count
        and the manifest in one atomically written ``.npz``; returns the path written (``.npz``
        appended when missing)."""
        flat, manifest = self._snapshot_checkpoint()
        return _write_checkpoint_atomic(path, flat, manifest)

    def load_checkpoint(self, path: str) -> Optional[Dict[str, Any]]:
        """Restore a checkpoint of either package into the compiled model;
        returns its manifest (``None`` for a manifest-less ``ffckpt/1``
        file, which has no digest to check).  A torn archive, an
        unreadable manifest, a digest mismatch or a name or shape that
        does not fit raise before anything is written."""
        ex = self._require_executor()
        try:
            with np.load(path) as z:
                flat = {key: np.asarray(z[key]) for key in z.files}
        except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
            raise CheckpointError(
                f"checkpoint {path!r} is torn or truncated: the archive is unreadable "
                f"({type(e).__name__}: {e}); refusing to load") from e
        manifest: Optional[Dict[str, Any]] = None
        raw = flat.pop("meta/manifest", None)
        if raw is not None:
            try:
                manifest = json.loads(raw.tobytes().decode())
            except (UnicodeDecodeError, ValueError) as e:
                raise CheckpointError(
                    f"checkpoint {path!r} has an unreadable manifest ({e}); refusing to load"
                ) from e
            want, got = manifest.get("digest"), _checkpoint_digest(flat)
            if want != got:
                raise CheckpointError(
                    f"checkpoint {path!r} failed its content-digest check: the manifest "
                    f"records {want}, the file hashes to {got}; refusing to load")
        weights: Dict[str, Dict[str, np.ndarray]] = {}
        opt: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        step_count, opt_step = None, None
        for key, arr in flat.items():
            # a layer name may hold '/', a weight name never does
            prefix, rest = key.split("/", 1)
            if prefix == "meta":
                if rest == "step_count":
                    step_count = int(arr)
            elif prefix == "opt_scalar":
                if rest != "step":
                    raise CheckpointError(f"checkpoint {path!r}: unknown scalar {key!r}")
                opt_step = int(arr)
            elif prefix == "opt":
                okey, rest = rest.split("/", 1)
                lname, wname = rest.rsplit("/", 1)
                opt.setdefault(okey, {}).setdefault(lname, {})[wname] = arr
            elif prefix in ("params", "state"):
                lname, wname = rest.rsplit("/", 1)
                weights.setdefault(lname, {})[wname] = arr
            else:
                raise CheckpointError(f"checkpoint {path!r}: unknown key {key!r}")
        pending = self._weight_writes(weights)
        for okey, entries in opt.items():
            pending += ex.opt_writes(okey, entries)
        ex.apply_writes(pending)
        if opt_step is not None:
            ex.opt_state["step"] = opt_step
        if step_count is not None:
            ex._step_count = step_count
        return manifest
