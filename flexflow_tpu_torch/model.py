"""``FFModel``: the layer-builder API, compile, and weight access.

Counterpart of ``flexflow_tpu/model.py`` ``FFModel``, limited to what the
encoder train path uses: the builders ``create_tensor``, ``dense``,
``multihead_attention``, ``add``, ``layer_norm``, ``dropout``,
``reduce_mean``, ``softmax`` and ``reshape`` (same signatures and layer
names), ``compile`` on one device, and ``get_weights`` / ``set_weights``
/ ``num_parameters``.

:meth:`FFModel.set_weights` carries weights across frameworks: it takes
the per-layer ``{layer: {weight: np.ndarray}}`` dictionary that the JAX
``FFModel.get_weights()`` returns, and checks every name and shape
before it writes anything.

The checkpoint writer (:func:`_write_checkpoint_atomic`, with
:func:`_checkpoint_digest` and :class:`CheckpointError`) is the JAX
package's: one ``.npz`` written atomically, its manifest and content
digest inside as ``meta/manifest``.  The digest hashes each array's key,
dtype string, shape and bytes the same way, so a file written by either
package verifies in the other.  The serve drain (``ffdrain/1``) and the
``ffkv/1`` frames use it; ``ffckpt/2`` train checkpoints are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

import flexflow_tpu_torch.ops  # noqa: F401  (registers every OpDef)
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.fftype import ActiMode, DataType, LossType, MetricsType, OperatorType
from flexflow_tpu_torch.initializer import Initializer
from flexflow_tpu_torch.metrics import Metrics
from flexflow_tpu_torch.ops.base import get_op_def
from flexflow_tpu_torch.optimizer import Optimizer, SGDOptimizer
from flexflow_tpu_torch.runtime.executor import Executor
from flexflow_tpu_torch.tensor import Layer, Tensor

__all__ = ["FFModel", "CheckpointError"]


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


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None) -> None:
        self.config = config or FFConfig()
        self.layers: List[Layer] = []
        self.graph_inputs: List[Tensor] = []
        self._name_counts: Dict[str, int] = {}
        self.executor: Optional[Executor] = None

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

    def reshape(self, input: Tensor, shape: Sequence[int], name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.RESHAPE, self._name("reshape", name), [input],
                               dict(shape=tuple(shape)))[0]

    def reduce_mean(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                    name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.REDUCE_MEAN, self._name("reduce_mean", name),
                               [input], dict(axes=tuple(axes), keepdims=keepdims))[0]

    def add(self, x: Tensor, y: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.EW_ADD, self._name("add", name), [x, y], {})[0]

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
        """Host copy of every weight, ``{layer: {weight: np.ndarray}}``."""
        ex = self._require_executor()
        return {lname: {w: t.detach().cpu().numpy() for w, t in ws.items()}
                for lname, ws in ex.params.items()}

    def set_weights(self, weights: Mapping[str, Mapping[str, Any]]) -> None:
        """Write every weight from ``{layer: {weight: array}}`` (the JAX
        ``get_weights()`` layout).  Raises ``ValueError`` on a missing,
        extra or mis-shaped entry before anything is written."""
        ex = self._require_executor()
        want = {(l, w): t for l, ws in ex.params.items() for w, t in ws.items()}
        got = {(l, w): np.asarray(a) for l, ws in weights.items() for w, a in ws.items()}
        missing = sorted("/".join(k) for k in set(want) - set(got))
        extra = sorted("/".join(k) for k in set(got) - set(want))
        if missing or extra:
            raise ValueError(f"set_weights: missing {missing or 'none'}, extra {extra or 'none'}")
        for key, arr in got.items():
            if arr.shape != tuple(want[key].shape):
                raise ValueError(f"set_weights: {'/'.join(key)} has shape {arr.shape}, the "
                                 f"model expects {tuple(want[key].shape)}")
        with torch.no_grad():
            for key, arr in got.items():
                t = want[key]
                t.copy_(torch.from_numpy(np.array(arr, np.float32)).to(t.device, t.dtype))

    def num_parameters(self) -> int:
        ex = self._require_executor()
        return sum(t.numel() for ws in ex.params.values() for t in ws.values())
