"""Paged decode/prefill programs and the one-sync-per-window serve loop.

Counterpart of ``flexflow_tpu/serve/engine.py`` ``ServeEngine``, as
plain PyTorch functions over the paged pools of a
:class:`~flexflow_tpu_torch.serve.kvcache.PagedKVCache`:

* the **decode step** (:meth:`ServeEngine._decode`) serves every slot
  with one query row each; idle lanes carry an all-zero table row, so
  their K/V writes land in the trash block;
* the **batched chunked prefill** (:meth:`ServeEngine._prefill`)
  ingests up to ``prefill_chunk`` prompt positions of EVERY mid-prefill
  slot in one dispatch per window; padded rows and idle lanes write the
  trash block;
* with ``spec_k`` > 0, greedy **speculative decoding**: a **draft**
  program (:meth:`ServeEngine._draft`, the decode step cut to the first
  ``spec_draft_layers`` layers, writing only their K/V) proposes
  ``spec_k`` tokens one after another, and one **verify** program
  (:meth:`ServeEngine._verify`) runs all layers over the W = k+1 rows
  of every lane and accepts, on the device, the longest draft prefix
  the full model agrees with; a row past the end of its lane's block
  table (a macro may run up to ``spec_k`` positions past a budget)
  writes the trash block;
* the loop runs in **flush windows**: one prefill dispatch, then up to
  ``sync_every`` decode steps (or speculative macro steps: k drafts and
  one verify) whose next tokens are chained on the device (greedy
  argmax on the device), then ONE device-to-host copy that drains the
  window's tokens, finishes and recycles slots, admits queued requests
  and writes one ``ffmetrics/1`` record.

Quantized pools (``kv_dtype`` "int8" or "fp8") store each written
position through :func:`~flexflow_tpu_torch.serve.kvcache.quantize_kv`
with its scale; ``weight_dtype="int8"`` holds every matrix as int8 with
per-channel scales and dequantizes each layer's weights where the
program uses them (the products stay ``torch.matmul``).

Every program scatters the new K/V into the pools IN PLACE, then attends
through :func:`~flexflow_tpu_torch.ops.cuda.paged_attention.paged_attention`
(the CUDA kernel, ``attn="paged"``) or its plain version
(``attn="gather"``).  ``attn="auto"`` takes the kernel on a CUDA device
and the gather on the CPU.  Float32 matmuls stay float32: the engine
turns TF32 off for CUDA matmuls.

**Preemption, drain and resume.**  An interactive request that finds
every slot held preempts a batch request (the scheduler spills its K/V
to host between windows; the request later restores it bit for bit and
resumes mid-stream).  SIGTERM during :meth:`ServeEngine.run` asks for a
drain: at the next window boundary every in-flight request spills (or,
mid-prefill, drops its partial K/V) and the run ends; the payload is
written atomically as one ``ffdrain/1`` file (:func:`save_drain`) when
``drain_path`` is set, and a fresh engine picks it up with
:func:`load_drain` and :meth:`ServeEngine.resume_from_drain`.  Spill
and restore copies are counted apart from the window's host sync
(``kv_spill_copies``, ``kv_restore_copies`` and their bytes in the
report): ``host_syncs`` still counts one per window.  A fault plan
(:mod:`flexflow_tpu_torch.runtime.faults`) is consulted at the top of
every window; ``watchdog_s`` counts windows slower than the budget and
``shed_after_windows`` sheds the queued batch tier after that many
consecutive windows over ``slo_ms`` per token.

Not ported yet (ROADMAP.md): temperature sampling, and the ``obs``
spans and tracer instants of the JAX loop (queue A item 6).
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from flexflow_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from flexflow_tpu_torch.model import CheckpointError, _write_checkpoint_atomic
from flexflow_tpu_torch.models.gpt_decode import layer_norm, make_cast, quantize_weights_int8
from flexflow_tpu_torch.models.transformer import GPTDecoder
from flexflow_tpu_torch.obs.metrics import MetricsStream, step_record
from flexflow_tpu_torch.ops.cuda.paged_attention import (
    paged_attention,
    paged_attention_plain,
    resolve_serve_attn,
)
from flexflow_tpu_torch.runtime.faults import get_fault_plan
from flexflow_tpu_torch.serve.kvcache import PagedKVCache, pool_bits, quantize_kv
from flexflow_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestState,
)
from flexflow_tpu_torch.serve.wire import (
    HandoffError,
    flatten_requests,
    unflatten_requests,
    verify_flat,
)

__all__ = ["ServeEngine", "ServeReport", "DRAIN_SCHEMA", "load_drain", "save_drain"]

# drain payload schema id: in-flight KV spills and the queues, written
# atomically, with the ffkv/1 flattening and digest (serve/wire.py)
DRAIN_SCHEMA = "ffdrain/1"


def save_drain(path: str, payload: Dict[str, Any]) -> str:
    """Write a :meth:`ServeEngine.drain` payload as one atomic,
    digest-checked ``.npz`` (the checkpoint writer).  Returns the path."""
    flat, metas = flatten_requests(payload["requests"])
    return _write_checkpoint_atomic(path, flat, {"schema": DRAIN_SCHEMA, "requests": metas})


def load_drain(path: str) -> Dict[str, Any]:
    """Read a :func:`save_drain` file back into the payload that
    :meth:`ServeEngine.resume_from_drain` takes.  A torn file or a digest
    mismatch raises :class:`~flexflow_tpu_torch.model.CheckpointError`."""
    try:
        with np.load(path) as z:
            flat = {k: np.asarray(z[k]) for k in z.files}
    except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
        raise CheckpointError(
            f"drain file {path!r} is torn or truncated ({type(e).__name__}: {e}); "
            f"refusing to load") from e
    try:
        manifest = verify_flat(flat, f"drain file {path!r}")
    except HandoffError as e:
        raise CheckpointError(str(e)) from e
    return {"schema": manifest["schema"],
            "requests": unflatten_requests(flat, manifest["requests"])}


def _pct(vals: Sequence[Optional[float]], q: float) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


@dataclasses.dataclass
class ServeReport:
    """End-of-run aggregate (the driver's summary payload)."""

    wall_s: float
    new_tokens: int
    tok_s: float
    requests_finished: int
    requests_rejected: int
    ttft_p50_ms: Optional[float]
    ttft_p99_ms: Optional[float]
    tpot_p50_ms: Optional[float]
    tpot_p99_ms: Optional[float]
    occupancy_mean: float
    windows: int
    decode_steps: int
    prefill_chunks: int
    host_syncs: int
    per_request: List[Dict[str, Any]]
    prefix_hit_rate: Optional[float] = None
    per_tier: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    per_tenant: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    peak_active: int = 0
    requests_expired: int = 0
    # one batched prefill dispatch per window with any mid-prefill slot
    # (prefill_chunks counts per-slot logical chunks)
    prefill_dispatches: int = 0
    prefill_attn_kernel: Optional[str] = None
    # speculative decoding (0 = off); accept rate = accepted / drafted
    spec_k: int = 0
    spec_draft_layers: int = 0
    spec_accept_rate: Optional[float] = None
    spec_drafted: int = 0
    spec_accepted: int = 0
    # preemption, drain and resilience
    preemptions: int = 0  # batch requests spilled or dropped for the interactive tier
    drained: bool = False  # the run ended in a drain, not with an empty queue
    shed: int = 0  # queued batch requests shed under SLO pressure
    watchdog_fires: int = 0  # windows slower than watchdog_s
    # spill (device to host) and restore (host to device) copies, one per
    # spill or restore, apart from the window's host sync
    kv_spill_copies: int = 0
    kv_spill_bytes: int = 0
    kv_restore_copies: int = 0
    kv_restore_bytes: int = 0

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("per_request")
        return d


class ServeEngine:
    """Continuous-batching serving of one :class:`GPTDecoder` on ``device``.

    The model's parameters must already live on ``device``.  The KV pool
    defaults to full provisioning (``slots`` x blocks-per-max-seq +
    trash); a smaller ``num_blocks`` makes requests share the pool, and
    admission then waits on the free list.  ``kv_dtype`` picks the pool
    format ("fp32" = the compute dtype, "bf16", "int8", "fp8"),
    ``weight_dtype`` "int8" the weight-only int8 arm, ``spec_k`` > 0
    greedy speculative decoding with a draft of the first
    ``spec_draft_layers`` layers (default, or when out of range: half
    the depth, at least one layer).  ``watchdog_s`` > 0 counts windows
    slower than that; ``shed_after_windows`` > 0 sheds the queued batch
    tier after that many consecutive windows over ``slo_ms`` per flushed
    token; ``drain_path`` is where a SIGTERM drain writes its file.
    """

    def __init__(
        self,
        model: GPTDecoder,
        *,
        slots: int = 4,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefill_chunk: int = 32,
        sync_every: int = 4,
        eos_id: Optional[int] = None,
        metrics_out: Optional[str] = None,
        prefix_sharing: bool = True,
        attn: str = "auto",
        kv_dtype: str = "fp32",
        weight_dtype: str = "fp32",
        spec_k: int = 0,
        spec_draft_layers: int = 0,
        watchdog_s: float = 0.0,
        shed_after_windows: int = 0,
        slo_ms: float = 50.0,
        drain_path: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> None:
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        on = {p.device for p in model.parameters()}
        if on != {self.device}:
            raise ValueError(
                f"model parameters are on {sorted(map(str, on))}, the engine on {self.device}"
            )
        if self.device.type == "cuda":
            # float32 matmuls stay float32 (TF32 keeps ~3 decimal digits);
            # this is PyTorch's default, set here explicitly
            torch.backends.cuda.matmul.allow_tf32 = False
        self.spec = model.spec(slots)
        self.slots = int(slots)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.sync_every = max(1, int(sync_every))
        self.eos_id = eos_id
        self.attn_kernel = resolve_serve_attn(attn, self.device)
        self.kv_dtype = kv_dtype
        self.weight_dtype = str(weight_dtype)
        if self.weight_dtype not in ("fp32", "int8"):
            raise ValueError(f"weight_dtype {self.weight_dtype!r}: expected fp32 | int8")
        spec = self.spec
        self.spec_k = max(0, int(spec_k))
        self.spec_draft_layers = max(0, int(spec_draft_layers))
        if self.spec_k and not 0 < self.spec_draft_layers < spec.num_layers:
            self.spec_draft_layers = max(1, spec.num_layers // 2)
        self.kv = PagedKVCache(
            spec.num_layers, spec.heads, spec.head_dim,
            slots=self.slots, block_size=block_size, num_blocks=num_blocks,
            max_seq_len=spec.seq, dtype=dtype, kv_dtype=kv_dtype,
            prefix_sharing=prefix_sharing, device=self.device,
        )
        self.sched = ContinuousBatchingScheduler(self.slots, self.kv)
        self.metrics = MetricsStream(metrics_out)
        self._cast = cast = make_cast(dtype)
        params, self._wscales = model.param_tree(), None
        if self.weight_dtype == "int8":
            # int8 leaves and their per-channel scales; _weights
            # dequantizes (then casts) each int8 leaf at use
            params, self._wscales = quantize_weights_int8(params)
        # the other leaves, cast once to the compute dtype (no copy when it
        # is float32)
        self._params = {
            layer: {leaf: t if t.dtype == torch.int8 else cast(t) for leaf, t in leaves.items()}
            for layer, leaves in params.items()
        }
        B, P = self.slots, self.prefill_chunk
        MB = self.kv.max_blocks_per_seq
        self._scale = 1.0 / math.sqrt(spec.head_dim)
        self._lane = torch.arange(B, device=self.device)
        self._rows = torch.arange(max(P, self.spec_k + 1), device=self.device)
        self._pinned: Dict[str, torch.Tensor] = {}
        # persistent host staging for the batched prefill chunk arrays
        self._pf_toks = np.zeros((B, P), np.int32)
        self._pf_start = np.zeros((B,), np.int32)
        self._pf_n = np.zeros((B,), np.int32)
        self._pf_bt = np.zeros((B, MB), np.int32)

        # warm every program once (this builds the CUDA kernel and sets up
        # the BLAS handles before any request's clock starts); all-zero
        # tables, so only the trash block is written
        z = np.zeros((B,), np.int32)
        bt0 = np.zeros((B, MB), np.int32)
        self._decode(*self._to_device("decode", z, z, bt0))
        self._prefill(*self._to_device(
            "prefill", np.zeros((B, P), np.int32), z, np.ones((B,), np.int32), bt0,
        ))
        if self.spec_k:
            self._draft(*self._to_device("decode", z, z, bt0))
            self._verify(*self._to_device(
                "verify", np.zeros((B, self.spec_k + 1), np.int32), z, bt0))
        if self.device.type == "cuda":
            # the staging buffers are refilled by the first window
            torch.cuda.synchronize(self.device)

        self.host_syncs = 0
        self.windows = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_dispatches = 0
        self.peak_active = 0
        self._occ_sum = 0.0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._t0: Optional[float] = None
        # resilience: SIGTERM only sets a flag, and the loop drains at the
        # next window boundary
        self.watchdog_s = float(watchdog_s)  # 0 = off
        self.shed_after_windows = int(shed_after_windows)  # 0 = off
        self.slo_ms = float(slo_ms)
        self.drain_path = drain_path
        self._drain_requested = False
        self.drained = False
        self.drain_payload: Optional[Dict[str, Any]] = None
        self.sigterm_installed = False  # whether the last run() held the handler
        self.watchdog_fires = 0
        self._slo_breach_windows = 0  # consecutive windows over the SLO
        self.dcn_degraded = False  # set by a dcn_degrade fault

    # --- submission ---------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        req_id: int = -1,
        eos_id: Optional[int] = None,
        arrival_s: float = 0.0,
        tenant: str = "default",
        tier: str = "batch",
        deadline_ms: Optional[float] = None,
        session: Optional[str] = None,
    ) -> Request:
        """Queue one request now; a budget past the position range or the
        pool comes back REJECTED with a reason."""
        req = Request(
            prompt=prompt, max_new_tokens=max_new_tokens, id=req_id,
            eos_id=eos_id if eos_id is not None else self.eos_id,
            arrival_s=arrival_s, tenant=tenant, tier=tier,
            deadline_ms=deadline_ms, session=session,
        )
        return self.sched.submit(req, now=self._now())

    # --- host -> device staging -------------------------------------------
    def _to_device(self, key: str, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Copy int32 host arrays to the device in ONE transfer and return
        device views of the same shapes.  On CUDA the copy goes through a
        pinned buffer per ``key`` without blocking the host; the buffer
        is refilled only after the window's flush has synchronized."""
        flat = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in arrays])
        if self.device.type == "cuda":
            buf = self._pinned.get(key)
            if buf is None or buf.numel() != flat.size:
                buf = torch.empty(flat.size, dtype=torch.int32, pin_memory=True)
                self._pinned[key] = buf
            buf.numpy()[:] = flat
            dev = buf.to(self.device, non_blocking=True)
        else:
            dev = torch.from_numpy(flat)
        out, i = [], 0
        for a in arrays:
            n = int(np.prod(a.shape))
            out.append(dev[i:i + n].view(a.shape))
            i += n
        return out

    # --- the programs ------------------------------------------------------
    def _weights(self, layer: str) -> Dict[str, torch.Tensor]:
        """Layer ``layer``'s leaves in the compute dtype; with int8 weights
        each int8 leaf is dequantized here, where the program uses it."""
        leaves = self._params[layer]
        if self._wscales is None:
            return leaves
        sc = self._wscales[layer]
        return {k: self._cast(w.float() * sc[k]) if w.dtype == torch.int8 else w
                for k, w in leaves.items()}

    def _embed(self, tok, pos):
        """Token plus position embeddings of ``tok`` at ``pos`` (same
        shapes).  int8 tables are gathered first and then dequantized: the
        scales are per column, so the rows equal those of the dequantized
        table."""
        x = []
        for layer, leaf, idx in (("tok_embed", "kernel", tok.long()),
                                 ("pos_embed", "value", pos.long().clamp(0, self.spec.seq - 1))):
            w = self._params[layer][leaf][idx]
            if w.dtype == torch.int8:
                w = self._cast(w.float() * self._wscales[layer][leaf])
            x.append(w)
        return x[0] + x[1]

    def _attend(self, q, i, pos, bt):
        """Attention of ``q`` (B, G, H, D) over layer ``i``'s pool."""
        attend = paged_attention if self.attn_kernel == "paged" else paged_attention_plain
        kv = self.kv
        sk = kv.scale_k[i] if kv.quantized else None
        sv = kv.scale_v[i] if kv.quantized else None
        return attend(q, kv.cache_k[i], kv.cache_v[i], pos, bt, self._scale, sk, sv)

    def _write_kv(self, i, blk, off, k, v):
        """Scatter ``k``/``v`` (B, G, H, D) into layer ``i``'s pools at
        block ``blk`` offset ``off`` (both (B, G)), IN PLACE; a quantized
        pool stores them through ``quantize_kv`` with their scales."""
        kv = self.kv
        if kv.quantized:
            k, ksc = quantize_kv(k, kv.kv_dtype)
            v, vsc = quantize_kv(v, kv.kv_dtype)
            kv.scale_k[i, blk, off] = ksc
            kv.scale_v[i, blk, off] = vsc
        pool_bits(kv.cache_k)[i, blk, :, off, :] = pool_bits(k.to(kv.dtype))
        pool_bits(kv.cache_v)[i, blk, :, off, :] = pool_bits(v.to(kv.dtype))

    def _layers(self, x, blk, off, pos, bt, depth=None):
        """The first ``depth`` (default all) decoder layers over rows ``x``
        (B, G, hidden) whose K/V go to pool block ``blk`` offset ``off``
        (both (B, G)); row ``g`` of lane ``b`` sits at ``pos[b] + g``."""
        spec = self.spec
        B, G, hid = x.shape
        H, D = spec.heads, spec.head_dim
        for i in range(spec.num_layers if depth is None else depth):
            pa = self._weights(f"dec{i}_attn")
            h = layer_norm(self._weights(f"dec{i}_ln0"), x, spec.eps).reshape(B * G, hid)
            q, k, v = h @ pa["wq"], h @ pa["wk"], h @ pa["wv"]
            if spec.has_bias:
                q, k, v = q + pa["bq"], k + pa["bk"], v + pa["bv"]
            # scatter this chunk's K/V into the pools IN PLACE, then attend:
            # row g's mask reaches the chunk's own rows 0..g
            self._write_kv(i, blk, off, k.reshape(B, G, H, D), v.reshape(B, G, H, D))
            o = self._attend(q.reshape(B, G, H, D), i, pos, bt)
            o = o.reshape(B * G, H * D) @ pa["wo"]
            if spec.has_bias:
                o = o + pa["bo"]
            x = x + o.reshape(B, G, hid)
            h = layer_norm(self._weights(f"dec{i}_ln1"), x, spec.eps).reshape(B * G, hid)
            p0, p1 = self._weights(f"dec{i}_ff0"), self._weights(f"dec{i}_ff1")
            f = F.gelu(h @ p0["kernel"] + p0["bias"], approximate="tanh")
            x = x + (f @ p1["kernel"] + p1["bias"]).reshape(B, G, hid)
        return x

    def _head(self, x):
        """Final layer norm, LM head, float32 softmax, greedy argmax over
        rows ``x`` (N, hidden)."""
        x = layer_norm(self._weights("final_ln"), x, self.spec.eps)
        probs = torch.softmax((x @ self._weights("lm_head")["kernel"]).float(), dim=-1)
        return torch.argmax(probs, dim=-1).to(torch.int32), probs

    def _slots(self, pos, bt):
        """Pool block and offset (both (B, R)) of rows at positions
        ``pos`` (B, R) through tables ``bt`` (B, MB).  A speculative row
        past the table's end (position >= MB x BS, beyond its request's
        budget) goes to the trash block 0 at offset 0, as a padded
        prefill row does: clipped to the last page it would overwrite the
        lane's real position there."""
        BS, MB = self.kv.block_size, self.kv.max_blocks_per_seq
        inside = pos < MB * BS
        blk = bt.long().gather(1, (pos // BS).clamp(0, MB - 1))
        return torch.where(inside, blk, 0), torch.where(inside, pos % BS, 0)

    def _step(self, tok, pos, bt, depth=None):
        """One token per lane through ``depth`` layers: ``tok``/``pos``
        (B,) int32, ``bt`` (B, MB) int32."""
        x = self._embed(tok, pos)
        blk, off = self._slots(pos.long()[:, None], bt)
        x = self._layers(x[:, None], blk, off, pos, bt, depth)
        return self._head(x[:, 0])

    @torch.inference_mode()
    def _decode(self, tok, pos, bt):
        """One decode step for every lane: ``tok``/``pos`` (B,) int32,
        ``bt`` (B, MB) int32.  Returns (next token (B,) int32, probs)."""
        return self._step(tok, pos, bt)

    @torch.inference_mode()
    def _draft(self, tok, pos, bt):
        """The decode step cut to the first ``spec_draft_layers`` layers
        (the shared final layer norm and LM head on top), writing only
        those layers' K/V.  Returns the draft's next token (B,) int32.  A
        rejected position's K/V is rewritten by the verify step before any
        row's mask can reach it."""
        return self._step(tok, pos, bt, self.spec_draft_layers)[0]

    @torch.inference_mode()
    def _verify(self, toks, pos0, bt) -> Tuple[torch.Tensor, ...]:
        """All layers over W = k+1 rows per lane: ``toks`` (B, W) is
        [current, draft_1 .. draft_k], row ``j`` at ``pos0[b] + j``.
        Returns ``(n, acc, next_cur, next_pos)``: the full model's argmax
        after every row (B, W), the accepted draft count (B,) (the
        longest prefix where each draft equals the argmax of the row
        before it), the first token not yet fed (``n[lane, acc]``) and
        its position (``pos0 + acc + 1``), all on the device."""
        B, W = toks.shape
        pos = pos0.long()[:, None] + self._rows[None, :W]  # (B, W)
        x = self._embed(toks, pos)
        x = self._layers(x, *self._slots(pos, bt), pos0, bt)
        n = self._head(x.reshape(B * W, -1))[0].reshape(B, W)
        agree = (toks[:, 1:] == n[:, :-1]).to(torch.int32)  # (B, k)
        acc = torch.cumprod(agree, dim=1).sum(dim=1).to(torch.int32)
        next_cur = n[self._lane, acc.long()]
        return n, acc, next_cur, pos0 + acc + 1

    @torch.inference_mode()
    def _prefill(self, toks, start, n_valid, bt):
        """One chunk of every mid-prefill slot: ``toks`` (B, P), ``start``
        and ``n_valid`` (B,), ``bt`` (B, MB), all int32.  Lanes with
        ``n_valid == 0`` ride along on the trash block.  Returns the next
        token after each lane's last valid row, and its probs."""
        BS, MB = self.kv.block_size, self.kv.max_blocks_per_seq
        P = toks.shape[1]
        pos = start.long()[:, None] + self._rows[None, :P]  # (B, P)
        valid = self._rows[None, :P] < n_valid.long()[:, None]
        x = self._embed(toks, pos)
        page = (pos // BS).clamp(0, MB - 1)
        blk = torch.where(valid, bt.long().gather(1, page), 0)
        off = torch.where(valid, pos % BS, 0)
        x = self._layers(x, blk, off, start, bt)
        # layer norm is per row, so pick each lane's last valid row first
        row = x[self._lane, (n_valid.long() - 1).clamp(0, P - 1)]
        return self._head(row)

    @staticmethod
    def _now() -> float:
        return time.perf_counter()

    # --- the serve loop ----------------------------------------------------
    def run(self, requests: Optional[Sequence[Request]] = None) -> ServeReport:
        """Serve ``requests`` (plus anything already submitted) until the
        queue drains, or until a drain is asked for (SIGTERM, or
        :meth:`request_drain`).  Each request is submitted once its
        open-loop ``arrival_s`` offset from the run's start has passed."""
        pending = sorted(requests or (), key=lambda r: (r.arrival_s, r.id))
        t0 = self._t0 = self._now()
        syncs0 = self.host_syncs
        self.windows = self.decode_steps = self.prefill_chunks = 0
        self.prefill_dispatches = 0
        self.peak_active = 0
        self._occ_sum = 0.0
        self.spec_drafted = self.spec_accepted = 0
        self.watchdog_fires = 0
        self._slo_breach_windows = 0
        fin0 = len(self.sched.finished)
        rej0 = len(self.sched.rejected)
        exp0 = self.sched.expired
        pre0 = self.sched.preemptions
        shed0 = self.sched.shed
        kv = self.kv
        copies0 = (kv.spill_copies, kv.spill_bytes, kv.restore_copies, kv.restore_bytes)
        for r in self.sched.queue:  # queued before run(): arrive at t0
            if r.arrival_abs_s is None:
                r.arrival_abs_s = t0
                r.t_submit = 0.0
                r.t_enqueued = 0.0
        # SIGTERM asks for a drain at the next window boundary; the old
        # handler comes back in finally.  Off the main thread the handler
        # cannot be installed: request_drain() still works there
        self.drained = False
        self._drain_requested = False
        self.sigterm_installed = False
        old_handler = None
        try:
            old_handler = signal.signal(signal.SIGTERM, lambda signum, frame: self.request_drain())
            self.sigterm_installed = True
        except ValueError:
            pass
        n_sub = 0
        try:
            while True:
                if self._drain_requested:
                    self.drain_payload = self.drain()
                    if self.drain_path:
                        save_drain(self.drain_path, self.drain_payload)
                    self.drained = True
                    break
                now = self._now() - t0
                while n_sub < len(pending) and pending[n_sub].arrival_s <= now:
                    r = pending[n_sub]
                    self.sched.submit(r, now=now)
                    r.arrival_abs_s = t0 + r.arrival_s
                    n_sub += 1
                self.sched.admit(now=now)
                if self.sched.idle:
                    if n_sub >= len(pending):
                        break
                    dt_next = pending[n_sub].arrival_s - (self._now() - t0)
                    if dt_next > 0:
                        time.sleep(min(dt_next, 0.05))
                    continue
                self._window()
        finally:
            if self.sigterm_installed:
                signal.signal(signal.SIGTERM,
                              signal.SIG_DFL if old_handler is None else old_handler)
        copies = tuple(b - a for a, b in zip(copies0, (
            kv.spill_copies, kv.spill_bytes, kv.restore_copies, kv.restore_bytes)))
        return self._report(
            self._now() - t0, self.host_syncs - syncs0, self.sched.finished[fin0:],
            len(self.sched.rejected) - rej0, self.sched.expired - exp0,
            self.sched.preemptions - pre0, self.sched.shed - shed0, copies,
        )

    def request_drain(self) -> None:
        """Ask the run loop to drain at the next window boundary (what the
        SIGTERM handler calls)."""
        self._drain_requested = True

    # --- drain / resume -------------------------------------------------------
    def drain(self) -> Dict[str, Any]:
        """Spill every in-flight slot to host and unload the queues into one
        payload that a fresh engine resumes from.  DECODE slots spill their
        live K/V bit for bit (the preemption convention); mid-PREFILL slots
        drop their partial K/V and prefill again on resume.  Greedy decode
        and an exact restore make the streams before and after the drain
        together equal an uninterrupted run's."""
        sched = self.sched
        reqs: List[Request] = []
        for slot in sorted(sched.active):
            req = sched.active.pop(slot)
            if req.state is RequestState.DECODE and req.done_tokens > 0:
                live = req.prompt_len + max(0, req.done_tokens - 1)
                req.kv_spill = self.kv.spill(slot, live)
                req.state = RequestState.PREEMPTED
            else:
                self.kv.release(slot)
                req.kv_spill = None
                req.prefill_pos = 0
                req.state = RequestState.QUEUED
            sched.free_slots.append(slot)
            req.slot = -1
            reqs.append(req)
        reqs.extend(sched.queue)  # admission order, interactive first
        for q in sched._queues.values():
            q.clear()
        return {
            "schema": DRAIN_SCHEMA,
            "requests": [
                {
                    "id": int(r.id),
                    "prompt": np.asarray(r.prompt, np.int32),
                    "max_new_tokens": int(r.max_new_tokens),
                    "eos_id": r.eos_id,
                    "tenant": r.tenant,
                    "tier": r.tier,
                    "deadline_ms": r.deadline_ms,
                    "session": r.session,
                    "preemptions": int(r.preemptions),
                    "tokens": list(r.tokens),
                    "kv_spill": r.kv_spill,
                }
                for r in reqs
            ],
        }

    def resume_from_drain(self, payload: Dict[str, Any]) -> List[Request]:
        """Load a :meth:`drain` payload into this engine's queues; call
        before :meth:`run`.  Spilled requests re-enter as PREEMPTED (the
        scheduler restores their K/V and they rejoin decode mid-stream),
        the rest as QUEUED."""
        schema = payload.get("schema")
        if schema != DRAIN_SCHEMA:
            raise ValueError(f"drain payload schema {schema!r} != {DRAIN_SCHEMA!r}")
        out: List[Request] = []
        for d in payload["requests"]:
            req = Request(
                prompt=d["prompt"], max_new_tokens=int(d["max_new_tokens"]), id=int(d["id"]),
                eos_id=d.get("eos_id"), tenant=d.get("tenant", "default"),
                tier=d.get("tier", "batch"), deadline_ms=d.get("deadline_ms"),
                session=d.get("session"),
            )
            req.tokens = [int(t) for t in d.get("tokens", ())]
            req.preemptions = int(d.get("preemptions", 0))
            req.kv_spill = d.get("kv_spill")
            req.state = RequestState.PREEMPTED if req.kv_spill is not None else RequestState.QUEUED
            # no submit(): admissibility held before the drain, and the
            # shared-prefix arithmetic would run against a cold index
            self.sched._queues[req.tier].append(req)
            self.sched._next_id = max(self.sched._next_id, req.id) + 1
            out.append(req)
        return out

    def _window(self) -> None:
        plan = get_fault_plan()  # one call and a None check with no plan
        if plan is not None:
            plan.on_serve_window(self)
        t_win = self._now()
        B, MB = self.slots, self.kv.max_blocks_per_seq
        fin_before = len(self.sched.finished)
        self.peak_active = max(self.peak_active, len(self.sched.active))

        # 1) prefill: ONE batched dispatch covers every mid-prefill slot
        prefill_done: List[Any] = []  # (req, slot) whose prompt completes
        chunks = []  # (slot, lo, hi)
        for slot in self.sched.prefill_slots():
            req = self.sched.active[slot]
            lo = req.prefill_pos
            chunks.append((slot, lo, min(lo + self.prefill_chunk, req.prompt_len)))
        pf_nxt = None
        if chunks:
            toks, start, n_valid, bt_pf = self._pf_toks, self._pf_start, self._pf_n, self._pf_bt
            for a in (toks, start, n_valid, bt_pf):
                a.fill(0)
            for slot, lo, hi in chunks:
                req = self.sched.active[slot]
                toks[slot, : hi - lo] = req.prompt[lo:hi]
                start[slot] = lo
                n_valid[slot] = hi - lo
                bt_pf[slot] = self.kv.table_row(slot)
            pf_nxt, _ = self._prefill(*self._to_device("prefill", toks, start, n_valid, bt_pf))
            self.prefill_chunks += len(chunks)
            self.prefill_dispatches += 1
            for slot, lo, hi in chunks:
                req = self.sched.active[slot]
                req.prefill_pos = hi
                # register fully written prompt blocks now, so a request
                # admitted next window can re-attach them
                self.kv.commit_prefix(req.slot, req.prompt, req.prefill_pos)
                if req.prefill_pos >= req.prompt_len:
                    prefill_done.append((req, slot))

        # 2) decode: chain next tokens on the device for an adaptive window
        dec_slots = self.sched.decode_slots()
        buffered: List[torch.Tensor] = []  # per step: next tokens (B,)
        spec_buf: List[Tuple[torch.Tensor, torch.Tensor]] = []  # per macro: (n, acc)
        steps = 0
        if dec_slots:
            remaining = [
                self.sched.active[s].max_new_tokens - self.sched.active[s].done_tokens
                for s in dec_slots
            ]
            cur = np.zeros((B,), np.int32)
            pos = np.zeros((B,), np.int32)
            inc = np.zeros((B,), np.int32)  # decode lanes advance, idle lanes stay
            bt = np.zeros((B, MB), np.int32)
            for s in dec_slots:
                r = self.sched.active[s]
                cur[s] = r.tokens[-1]
                pos[s] = r.prompt_len + r.done_tokens - 1
                inc[s] = 1
                bt[s] = self.kv.tables[s]
            cur_d, pos_d, inc_d, bt_d = self._to_device("decode", cur, pos, inc, bt)
            if self.spec_k:
                # speculative macro steps: k chained drafts, then ONE verify
                # over the k+1 rows; verify returns the next macro's token
                # and position on the device, so macros chain with no host
                # fetch either
                W = self.spec_k + 1
                macros = max(1, min(self.sync_every, -(-min(remaining) // W)))
                for _ in range(macros):
                    cur_j, pos_j, drafts = cur_d, pos_d, []
                    for _ in range(self.spec_k):
                        cur_j = self._draft(cur_j, pos_j, bt_d)
                        drafts.append(cur_j)
                        pos_j = pos_j + 1
                    rows = torch.stack([cur_d] + drafts, dim=1)  # (B, W)
                    n, acc, cur_d, pos_d = self._verify(rows, pos_d, bt_d)
                    spec_buf.append((n, acc))
                steps = macros * W  # program invocations this window
            else:
                steps = max(1, min(self.sync_every, min(remaining)))
                for _ in range(steps):
                    nxt, _ = self._decode(cur_d, pos_d, bt_d)
                    buffered.append(nxt)
                    cur_d = nxt  # device-to-device chain: no host fetch
                    pos_d = pos_d + inc_d
            self.decode_steps += steps

        # 3) flush: the window's ONE device-to-host copy
        t_sync = self._now()
        parts = buffered + [t for pair in spec_buf for t in pair] + ([pf_nxt] if chunks else [])
        host = torch.cat([t.reshape(-1) for t in parts]).cpu().numpy() if parts else None
        stall = self._now() - t_sync
        self.host_syncs += 1
        flushed = 0
        W = self.spec_k + 1
        i = B * len(buffered)
        host_tok = host[:i].reshape(-1, B) if buffered else []
        host_spec = []  # per macro: (n (B, W), acc (B,))
        for _ in spec_buf:
            host_spec.append((host[i:i + B * W].reshape(B, W), host[i + B * W:i + B * W + B]))
            i += B * W + B
        host_pf = host[i:] if chunks else None
        for ki in range(len(host_tok)):
            for s in dec_slots:
                req = self.sched.active.get(s)
                if req is None or req.state is not RequestState.DECODE:
                    continue  # finished earlier in this flush
                tok = int(host_tok[ki][s])
                req.tokens.append(tok)
                flushed += 1
                self._finish_if_done(req, tok)
        # speculative lanes: each macro gives its accepted drafts plus the
        # verify row's own argmax; tokens past a finish are dropped
        spec_drafted_w = spec_accepted_w = 0
        for n_h, acc_h in host_spec:
            for s in dec_slots:
                req = self.sched.active.get(s)
                if req is None or req.state is not RequestState.DECODE:
                    continue
                a = int(acc_h[s])
                spec_drafted_w += self.spec_k
                spec_accepted_w += a
                for j in range(a + 1):
                    tok = int(n_h[s, j])
                    req.tokens.append(tok)
                    flushed += 1
                    self._finish_if_done(req, tok)
                    if req.state is not RequestState.DECODE:
                        break
        self.spec_drafted += spec_drafted_w
        self.spec_accepted += spec_accepted_w
        for req, slot in prefill_done:
            tok = int(host_pf[slot])
            req.state = RequestState.DECODE
            req.tokens.append(tok)
            flushed += 1
            req.t_first_token = self._now()
            self._finish_if_done(req, tok)

        self.windows += 1
        self._occ_sum += self.sched.occupancy
        win_wall = self._now() - t_win
        if self.watchdog_s and win_wall > self.watchdog_s:
            self.watchdog_fires += 1
        # after shed_after_windows consecutive windows over the per-token
        # SLO, reject the queued batch tier with the reason
        if self.shed_after_windows and flushed:
            per_tok_ms = win_wall / flushed * 1e3
            self._slo_breach_windows = self._slo_breach_windows + 1 if per_tok_ms > self.slo_ms else 0
            if self._slo_breach_windows >= self.shed_after_windows:
                self.sched.shed_batch_queue(
                    self._now() - (self._t0 or 0.0),
                    f"sustained SLO pressure: per-token {per_tok_ms:.1f} ms > "
                    f"{self.slo_ms:.1f} ms SLO for {self._slo_breach_windows} consecutive windows",
                )
                self._slo_breach_windows = 0
        if self.metrics.enabled:
            fin = [
                {"id": r.id, "tokens": r.done_tokens, "reason": r.finish_reason,
                 "tenant": r.tenant, "tier": r.tier, "preempted": r.preemptions,
                 **r.latency_ms()}
                for r in self.sched.finished[fin_before:]
            ]
            serve_m = {
                "queue_depth": self.sched.queue_depth,
                "occupancy": self.sched.occupancy,
                "decode_steps": steps,
                "prefill_chunks": len(chunks),
                "active": len(self.sched.active),
                "finished": fin,
                "rejected_total": len(self.sched.rejected),
                "expired_total": self.sched.expired,
                "shed_total": self.sched.shed,
                "prefix_hit_rate": self.kv.prefix_hit_rate,
                "cached_blocks": self.kv.cached_blocks,
                "preemptions_total": self.sched.preemptions,
                "attn_kernel": self.attn_kernel,
                "prefill_attn_kernel": self.attn_kernel,
                "prefill_dispatches": 1 if chunks else 0,
                "kv_dtype": self.kv_dtype,
                "weight_dtype": self.weight_dtype,
                "kv_bytes_per_token": self.kv.bytes_per_token,
                "device": str(self.device),
            }
            if self.spec_k:
                serve_m["spec"] = {
                    "k": self.spec_k,
                    "draft_layers": self.spec_draft_layers,
                    "drafted": spec_drafted_w,
                    "accepted": spec_accepted_w,
                }
            self.metrics.append(step_record(
                step=self.windows - 1, t=time.time(),
                step_wall_s=self._now() - t_win, host_stall_s=stall,
                tokens=flushed, samples=len(dec_slots),
                metrics={"serve": serve_m},
            ))

    def _finish_if_done(self, req: Request, tok: int) -> None:
        if req.eos_id is not None and tok == req.eos_id:
            self.sched.finish(req, self._now(), "eos")
        elif req.done_tokens >= req.max_new_tokens:
            self.sched.finish(req, self._now(), "length")

    # --- report -------------------------------------------------------------
    def _report(self, wall: float, host_syncs: int, fin: List[Request], rejected: int,
                expired: int, preemptions: int, shed: int,
                copies: Tuple[int, int, int, int]) -> ServeReport:
        lat = [r.latency_ms() for r in fin]
        new_tokens = sum(r.done_tokens for r in fin)
        per_tier: Dict[str, Dict[str, Any]] = {}
        for tier in sorted({r.tier for r in fin}):
            rs = [r for r in fin if r.tier == tier]
            tl = [r.latency_ms() for r in rs]
            per_tier[tier] = {
                "finished": len(rs),
                "preemptions": sum(r.preemptions for r in rs),
                "ttft_p50_ms": _pct([d["ttft_ms"] for d in tl], 50),
                "ttft_p99_ms": _pct([d["ttft_ms"] for d in tl], 99),
                "tpot_p99_ms": _pct([d["tpot_ms"] for d in tl], 99),
            }
        per_tenant: Dict[str, Dict[str, Any]] = {}
        for tenant, d in sorted(self.sched.tenant_summary().items()):
            ttfts = d.pop("ttft_ms")
            d["ttft_p50_ms"] = _pct(ttfts, 50)
            d["ttft_p99_ms"] = _pct(ttfts, 99)
            per_tenant[tenant] = d
        rep = ServeReport(
            wall_s=wall,
            new_tokens=new_tokens,
            tok_s=new_tokens / wall if wall > 0 else 0.0,
            requests_finished=len(fin),
            requests_rejected=rejected,
            ttft_p50_ms=_pct([d["ttft_ms"] for d in lat], 50),
            ttft_p99_ms=_pct([d["ttft_ms"] for d in lat], 99),
            tpot_p50_ms=_pct([d["tpot_ms"] for d in lat], 50),
            tpot_p99_ms=_pct([d["tpot_ms"] for d in lat], 99),
            occupancy_mean=self._occ_sum / self.windows if self.windows else 0.0,
            windows=self.windows,
            decode_steps=self.decode_steps,
            prefill_chunks=self.prefill_chunks,
            host_syncs=host_syncs,
            per_request=[
                {"id": r.id, "prompt_len": r.prompt_len, "tokens": list(r.tokens),
                 "reason": r.finish_reason, "tenant": r.tenant, "tier": r.tier,
                 "preemptions": r.preemptions, "shared_prefix_pos": r.shared_prefix_pos,
                 **r.latency_ms()}
                for r in fin
            ],
            prefix_hit_rate=self.kv.prefix_hit_rate,
            per_tier=per_tier,
            per_tenant=per_tenant,
            peak_active=self.peak_active,
            requests_expired=expired,
            prefill_dispatches=self.prefill_dispatches,
            prefill_attn_kernel=self.attn_kernel,
            spec_k=self.spec_k,
            spec_draft_layers=self.spec_draft_layers if self.spec_k else 0,
            spec_accept_rate=(self.spec_accepted / self.spec_drafted
                              if self.spec_drafted else None),
            spec_drafted=self.spec_drafted,
            spec_accepted=self.spec_accepted,
            preemptions=preemptions,
            drained=self.drained,
            shed=shed,
            watchdog_fires=self.watchdog_fires,
            kv_spill_copies=copies[0],
            kv_spill_bytes=copies[1],
            kv_restore_copies=copies[2],
            kv_restore_bytes=copies[3],
        )
        self.metrics.close()
        return rep
