"""Flash attention, forward and backward.

Counterpart of ``flexflow_tpu/ops/pallas/flash_attention.py``, with the
same public signature and contract: ``q`` (B, H, Sq, D), ``k``/``v``
(B, H, Sk, D), float32 or bfloat16, one dtype; the scale is
``1/sqrt(D)``; the causal mask is end-aligned (row ``i`` sees keys
``j <= i + Sk - Sq``) and a row that sees no key outputs 0; dropout
drops probabilities by the counter hash :func:`uniform01` of (seed,
b * H + h, q position, k position), the JAX package's ``_uniform01`` bit
for bit, so forward and backward rebuild the same mask from the seed.

* :func:`flash_attention` is the public entry, through
  :class:`FlashAttention` (the counterpart of the ``_flash_core``
  custom_vjp).  On CUDA tensors its forward launches ``flash_fwd`` and
  its backward ``flash_bwd_dq`` and ``flash_bwd_dkv``, the hand-written
  kernels of ``csrc/flash_attention.cu``, adding one to
  ``LAUNCHES[kind]`` per launch; a build or launch failure raises, and
  nothing falls back.  On CPU tensors it runs the plain versions.  On
  bfloat16 inputs each of the three launches its Hopper redesign on
  ``wgmma``; on float32 inputs all three run on the tensor cores as
  3xTF32 (each product as three TF32 products of the operands' split
  halves: within the float32 gates of the plain version, though farther
  off than FMAs, as the tensor cores round their float32 sums mostly
  toward zero; the forward sums each key tile's P.V apart and adds it to
  the running output in float32).  ``first_design=True`` (keyword-only,
  on ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``) launches the
  design a redesign replaced (the float32 kernels' FMA designs on the
  CUDA cores), for timing the two side by side.
* :func:`flash_attention_fwd_plain`, :func:`flash_attention_bwd_dq_plain`
  and :func:`flash_attention_bwd_dkv_plain` are the plain PyTorch versions
  of the three kernels, with the same contract (O and a compact float32
  lse of shape (B * H, Sq); dQ, and dK with dV, from the saved lse and
  ``delta = rowsum(dO * O)``); :func:`flash_attention_bwd_plain` runs
  both backward halves.  They materialise the (Sq, Sk) scores and follow
  the JAX one-pass forward and the two backward kernels operation by
  operation, including where the bfloat16 casts sit.

The kernel's contract, checked on every device so that the CPU and the
card take the same inputs: Sq and Sk multiples of 128 (the JAX
``default_blocks`` rule), head dim 64 or 128 (BERT's 64; other head dims
are refused and the attention op takes ``sdpa`` for them), contiguous
(B, H, S, D) tensors of one dtype.  ``block_q`` / ``block_k`` are
accepted for the JAX signature and only checked to divide Sq / Sk: the
kernels use their own 64-row tiles.  B * H has no limit of its own, as in
the JAX kernels' grid: the grid's y extent holds at most ``GRID_Y_MAX``
rows, so a call over more launches its kernel once per chunk of rows
(:func:`bh_chunks`), each kernel reading its row as the chunk's first
row plus ``blockIdx.y``; the call counts as one launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FlashAttention",
    "GRID_Y_MAX",
    "HEAD_DIMS",
    "LAUNCHES",
    "NEG_INF",
    "SEQ_MULTIPLE",
    "check_inputs",
    "flash_attention",
    "flash_attention_bwd_dkv_plain",
    "flash_attention_bwd_dq_plain",
    "flash_attention_bwd_plain",
    "flash_attention_fwd_plain",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_delta",
    "bh_chunks",
    "flash_fwd",
    "kernel_takes",
    "uniform01",
]

# kernel launches by kind through FlashAttention; read and reset by
# callers that need to show which path a run took
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
# the most B * H rows one launch takes (the grid's y extent); a call over
# more rows launches its kernel once for each chunk of rows (bh_chunks)
GRID_Y_MAX = 65535
SEQ_MULTIPLE = 128
_FLOATS = (torch.float32, torch.bfloat16)
_M32 = 0xFFFFFFFF
_lib = None


# ------------------------------------------------------------------ hash
def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) without int64
    overflow: the constant is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def uniform01(seed, bh, q_pos, k_pos) -> torch.Tensor:
    """The JAX ``_uniform01`` hash: float32 uniform [0, 1) per (seed, bh,
    q position, k position).  Arguments are ints or int tensors that
    broadcast together; the arithmetic is uint32 with wrap-around, done
    in int64 masked to 32 bits."""
    def u32(x):
        return torch.as_tensor(x, dtype=torch.int64) & _M32

    h = (_mul32(u32(q_pos), 0x9E3779B1) + _mul32(u32(k_pos), 0x85EBCA77)
         + u32(seed) + _mul32(u32(bh), 0xC2B2AE35)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _rates(dropout_rate: float) -> Tuple[float, float]:
    """(rate, keep) as float32 values, as the JAX kernels compare and
    divide: ``u >= rate`` and ``p / float32(1 - rate)``."""
    return float(np.float32(dropout_rate)), float(np.float32(1.0 - dropout_rate))


# ------------------------------------------------------ plain versions
def _scores(q, k, causal):
    """float32 scores (B, H, Sq, Sk), masked to NEG_INF where invisible,
    and the visibility mask (None when not causal)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if not causal:
        return s, None
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    vis = q_pos + (sk - sq) >= k_pos
    return s.masked_fill(~vis, NEG_INF), vis


def _keep_hash(shape, seed, rate, device) -> torch.Tensor:
    """``u >= rate`` over (B, H, Sq, Sk)."""
    B, H, sq, sk = shape
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    q_pos = torch.arange(sq, device=device).reshape(1, 1, sq, 1)
    k_pos = torch.arange(sk, device=device).reshape(1, 1, 1, sk)
    return uniform01(int(seed), bh, q_pos, k_pos) >= rate


def flash_attention_fwd_plain(q, k, v, causal=False, dropout_rate=0.0, seed=0):
    """(out, lse): ``out`` like ``q``, ``lse`` float32 (B * H, Sq).  The
    JAX one-pass forward (``_fwd_kernel_onepass``) over whole rows."""
    B, H, sq, _ = q.shape
    s, vis = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        # a row with no visible key has s == m == NEG_INF: zero it
        p = p.masked_fill(~vis, 0.0)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    if dropout_rate > 0.0:
        rate, keep = _rates(dropout_rate)
        p = torch.where(_keep_hash(s.shape, seed, rate, q.device), p / keep, 0.0)
    out = torch.matmul((p / l_safe).to(v.dtype).float(), v.float()).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(B * H, sq)
    return out, lse


def _probs(q, k, lse, causal):
    """p = exp(s - lse), zeroed where invisible: rows with no visible key
    saved lse ~ NEG_INF, so exp(s - lse) of a masked score does not
    vanish and the mask must zero it."""
    B, H, sq, _ = q.shape
    s, vis = _scores(q, k, causal)
    p = torch.exp(s - lse.reshape(B, H, sq, 1))
    return p if vis is None else p.masked_fill(~vis, 0.0)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False, dropout_rate=0.0,
                                 seed=0):
    """dq from the saved ``lse`` and ``delta`` (both float32 (B * H, Sq)):
    the JAX ``_dq_kernel`` over whole rows."""
    B, H, sq, d = q.shape
    p = _probs(q, k, lse, causal)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    if dropout_rate > 0.0:
        rate, keep = _rates(dropout_rate)
        dp = torch.where(_keep_hash(p.shape, seed, rate, q.device), dp / keep, 0.0)
    ds = p * (dp - delta.reshape(B, H, sq, 1))
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * (1.0 / math.sqrt(d))
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False, dropout_rate=0.0,
                                  seed=0):
    """(dk, dv) from the saved ``lse`` and ``delta``: the JAX
    ``_dkv_kernel`` over whole rows."""
    B, H, sq, d = q.shape
    p = _probs(q, k, lse, causal)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_eff = p
    if dropout_rate > 0.0:
        rate, keep = _rates(dropout_rate)
        keep_mask = _keep_hash(p.shape, seed, rate, q.device).float() / keep
        p_eff, dp = p * keep_mask, dp * keep_mask
    ds = p * (dp - delta.reshape(B, H, sq, 1))
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * (1.0 / math.sqrt(d))
    dv = torch.matmul(p_eff.to(do.dtype).float().transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(out, do) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in float32, (B * H, Sq): computed
    outside the kernels, as the JAX package leaves it to XLA."""
    B, H, sq, _ = out.shape
    return (do.float() * out.float()).sum(-1).reshape(B * H, sq)


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False, dropout_rate=0.0, seed=0):
    """(dq, dk, dv) from the saved ``lse`` (B * H, Sq): both halves."""
    delta = flash_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, dropout_rate, seed)
    return (flash_attention_bwd_dq_plain(*args),) + flash_attention_bwd_dkv_plain(*args)


# --------------------------------------------------------------- checks
def kernel_takes(sq: int, sk: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel's shape and type contract holds (the attention
    op's dispatch test)."""
    return (sq >= SEQ_MULTIPLE and sk >= SEQ_MULTIPLE and sq % SEQ_MULTIPLE == 0
            and sk % SEQ_MULTIPLE == 0 and d in HEAD_DIMS and dtype in _FLOATS)


def check_inputs(q, k, v, block_q: Optional[int] = None, block_k: Optional[int] = None):
    """Raise on what the kernel does not take (see the module docstring)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: expected q, k, v of shape (B, H, S, D)")
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q/k/v {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
            f"takes float32 or bfloat16, one dtype for all three"
        )
    B, H, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (B, H, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    for name, s in (("Sq", sq), ("Sk", sk)):
        if s < SEQ_MULTIPLE or s % SEQ_MULTIPLE:
            raise ValueError(
                f"flash_attention: {name} = {s} is not a multiple of {SEQ_MULTIPLE}; "
                f"use the sdpa path for ragged lengths"
            )
    for name, s, blk in (("Sq", sq, block_q), ("Sk", sk, block_k)):
        if blk is not None and (blk < 1 or s % blk):
            raise ValueError(f"flash_attention: {name} = {s} is not divisible by block {blk}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(
            f"flash_attention: tensors on {sorted(map(str, devs))}; expected all on one "
            f"CUDA device (kernel) or all on the CPU (plain version)"
        )


# -------------------------------------------------------------- kernels
def _library():
    global _lib
    if _lib is None:
        from flexflow_tpu_torch.ops.cuda import load

        lib = load("flash_attention")
        # bh0, bh, sq, sk, d, causal, scale, rate, keep, seed, bf16_in, first_design, stream
        tail = [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [ctypes.c_uint32, ctypes.c_int,
                                                             ctypes.c_int, ctypes.c_void_p]
        lib.ff_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.ff_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.ff_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        for fn in (lib.ff_flash_fwd, lib.ff_flash_bwd_dq, lib.ff_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.ff_flash_error_string.argtypes = [ctypes.c_int]
        lib.ff_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def bh_chunks(bh: int):
    """``(first row, rows)`` of each launch over ``bh`` rows: at most
    ``GRID_Y_MAX`` rows a launch, the grid's y limit."""
    return [(b0, min(GRID_Y_MAX, bh - b0)) for b0 in range(0, bh, GRID_Y_MAX)]


def _stream(device: torch.device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _launch(kind: str, fn, ptrs, q, sk, causal, dropout_rate, seed, *extra) -> None:
    """One kernel call over all B * H rows, in launches of at most
    ``GRID_Y_MAX`` rows (:func:`bh_chunks`); it counts as one launch."""
    if any(p % 16 for p in ptrs):
        raise ValueError(f"flash_attention {kind}: every tensor must be 16-byte aligned "
                         f"(the kernels copy rows in 16-byte pieces)")
    B, H, sq, d = q.shape
    rate, keep = _rates(dropout_rate)
    stream = _stream(q.device)
    for bh0, rows in bh_chunks(B * H):
        rc = fn(*ptrs, bh0, rows, sq, sk, d, int(bool(causal)), 1.0 / math.sqrt(d), rate, keep,
                int(seed) & 0xFFFFFFFF, int(q.dtype == torch.bfloat16), *extra, stream)
        if rc != 0:
            msg = _library().ff_flash_error_string(rc).decode(errors="replace")
            raise RuntimeError(f"flash_attention {kind} kernel launch failed: {msg} "
                               f"(cudaError {rc})")
    LAUNCHES[kind] += 1


def flash_fwd(q, k, v, causal=False, dropout_rate=0.0, seed=0, *, first_design=False):
    """(out, lse) of contiguous (B, H, S, D) inputs: the ``flash_fwd``
    kernel on CUDA tensors, :func:`flash_attention_fwd_plain` on CPU ones.
    ``first_design`` launches the forward's first design in place of its
    redesign, for timing (bfloat16: the mma.sync kernel; float32: the FMA
    kernel)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, dropout_rate, seed)
    B, H, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, sq), dtype=torch.float32, device=q.device)
    _launch("fwd", _library().ff_flash_fwd,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()),
            q, k.shape[2], causal, dropout_rate, seed, int(bool(first_design)))
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, dropout_rate=0.0, seed=0, *,
                 first_design=False):
    """dq: the ``flash_bwd_dq`` kernel on CUDA tensors,
    :func:`flash_attention_bwd_dq_plain` on CPU ones.  ``first_design``
    launches the kernel's first design in place of its redesign, for
    timing: the ``mma.sync`` design for bfloat16 inputs, the FMA design for
    float32 ones (CPU tensors: the plain version whatever it says)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal, dropout_rate, seed)
    dq = torch.empty_like(q)
    _launch("dq", _library().ff_flash_bwd_dq,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr()),
            q, k.shape[2], causal, dropout_rate, seed, int(bool(first_design)))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, dropout_rate=0.0, seed=0, *,
                  first_design=False):
    """(dk, dv): the ``flash_bwd_dkv`` kernel on CUDA tensors,
    :func:`flash_attention_bwd_dkv_plain` on CPU ones.  ``first_design``
    as for :func:`flash_bwd_dq`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal, dropout_rate,
                                             seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", _library().ff_flash_bwd_dkv,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k.shape[2], causal, dropout_rate, seed, int(bool(first_design)))
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Counterpart of the ``_flash_core`` custom_vjp: the forward saves q,
    k, v, out, lse and the seed; the backward recomputes the probability
    tiles from lse.  ``q``/``k``/``v`` must be contiguous (B, H, S, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, dropout_rate: float, seed: int):
        out, lse = flash_fwd(q, k, v, causal, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.dropout_rate, ctx.seed = bool(causal), float(dropout_rate), int(seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if do.data_ptr() % 16:
            do = do.clone()
        args = (q, k, v, do, lse, flash_delta(out, do), ctx.causal, ctx.dropout_rate, ctx.seed)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, dropout_rate: float = 0.0, seed=0,
                    block_q: Optional[int] = None, block_k: Optional[int] = None):
    """(B, H, S, D) attention through the flash kernels (see the module
    docstring); differentiable in q, k and v."""
    check_inputs(q, k, v, block_q, block_k)
    if not 0.0 <= float(dropout_rate) < 1.0:
        raise ValueError(f"flash_attention: dropout_rate {dropout_rate} not in [0, 1)")
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    return FlashAttention.apply(q, k, v, bool(causal), float(dropout_rate), int(seed))
