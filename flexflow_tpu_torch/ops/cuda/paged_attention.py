"""Paged attention over a block-table-indexed K/V pool.

Counterpart of ``flexflow_tpu/ops/pallas/paged_attention.py``, with the
same signature and layouts: ``q`` is (B, G, H, D), G consecutive query
rows per lane (row ``g`` of lane ``b`` at ``positions[b] + g``); the
pools are one layer's (num_blocks, H, BS, D); ``block_tables`` is
(B, MB) int32, logical page -> physical block; physical block 0 is the
allocator's trash block.  Row ``g`` attends positions
``0 .. positions[b] + g`` with a float32 softmax; the result is in
``q.dtype``.

* :func:`paged_attention` is the wrapper.  On CUDA tensors it launches
  the hand-written kernel ``csrc/paged_attention.cu`` (which replaces
  the TPU kernel ``_kernel`` of the JAX module) and adds one to
  :data:`LAUNCHES`; a build or launch failure raises.  On CPU tensors
  it takes the plain version.  It never falls back from CUDA to the
  plain version.
* :func:`paged_attention_plain` is the plain PyTorch version: gather
  ``pool[block_tables]`` to (B, H, SV, D), mask ``k_pos <= pos0 + g``,
  mul+sum score contraction, float32 softmax.  It is the function the
  engine's ``attend`` computes (``attn="gather"``) and what the CPU
  tests run.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "LAUNCHES",
    "MAX_HEAD_DIM",
    "paged_attention",
    "paged_attention_plain",
    "paged_decode_attention",
    "paged_prefill_attention",
    "resolve_serve_attn",
]

# kernel launches through paged_attention(); read and reset by callers
# that need to show which path a run took
LAUNCHES = 0

MAX_HEAD_DIM = 256  # the kernel keeps D / 32 accumulators per lane, at most 8
_FLOATS = (torch.float32, torch.bfloat16)
_lib = None


def resolve_serve_attn(mode: str, device: torch.device) -> str:
    """Resolve ``--serve-attn`` to a concrete path.  ``auto`` takes the
    kernel on a CUDA device and the plain gather on the CPU; an explicit
    ``paged`` on the CPU raises instead of running something else."""
    m = (mode or "auto").strip().lower()
    if m == "auto":
        return "paged" if device.type == "cuda" else "gather"
    if m == "gather":
        return "gather"
    if m == "paged":
        if device.type != "cuda":
            raise ValueError(
                f"--serve-attn paged: the paged-attention kernel needs a CUDA "
                f"device, not {str(device)!r}; use auto or gather on the CPU"
            )
        return "paged"
    raise ValueError(f"--serve-attn {mode!r}: expected auto | gather | paged")


def paged_attention_plain(q, pool_k, pool_v, positions, block_tables, scale=None):
    """The plain PyTorch version (see the module docstring)."""
    B, G, H, D = q.shape
    BS = pool_k.shape[2]
    MB = block_tables.shape[1]
    SV = MB * BS
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    keys = pool_k[bt].float().permute(0, 2, 1, 3, 4).reshape(B, H, SV, D)
    vals = pool_v[bt].float().permute(0, 2, 1, 3, 4).reshape(B, H, SV, D)
    scores = (q.float()[..., None, :] * keys[:, None]).sum(-1) * scale  # (B, G, H, SV)
    k_pos = torch.arange(SV, device=q.device)
    row_pos = positions.long()[:, None] + torch.arange(G, device=q.device)  # (B, G)
    mask = k_pos[None, None, :] <= row_pos[:, :, None]  # (B, G, SV)
    scores = torch.where(
        mask[:, :, None, :], scores, torch.finfo(torch.float32).min
    )
    w = torch.softmax(scores, dim=-1)
    return (w[..., None] * vals[:, None]).sum(-2).to(q.dtype)


def _check(q, pool_k, pool_v, positions, block_tables) -> None:
    dev = q.device
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("positions", positions), ("block_tables", block_tables)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} is on {t.device}, q on {dev}")
    if q.dtype not in _FLOATS or pool_k.dtype not in _FLOATS:
        raise TypeError(
            f"paged_attention: q {q.dtype} / pools {pool_k.dtype}: the kernel "
            f"takes float32 or bfloat16"
        )
    if pool_v.dtype != pool_k.dtype:
        raise TypeError(f"paged_attention: pool_k {pool_k.dtype} != pool_v {pool_v.dtype}")
    if q.dtype == torch.bfloat16 and pool_k.dtype == torch.float32:
        raise TypeError("paged_attention: a bfloat16 q over a float32 pool is not taken")
    if positions.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("paged_attention: positions and block_tables must be int32")
    if q.dim() != 4 or pool_k.dim() != 4 or positions.dim() != 1 or block_tables.dim() != 2:
        raise ValueError(
            "paged_attention: expected q (B, G, H, D), pools (N, H, BS, D), "
            "positions (B,), block_tables (B, MB)"
        )
    B, G, H, D = q.shape
    N, Hp, BS, Dp = pool_k.shape
    if pool_v.shape != pool_k.shape or (Hp, Dp) != (H, D):
        raise ValueError(
            f"paged_attention: pools {tuple(pool_k.shape)} / {tuple(pool_v.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    if positions.shape[0] != B or block_tables.shape[0] != B:
        raise ValueError("paged_attention: positions/block_tables lane count != q's")
    if min(B, G, H, D, N, BS, block_tables.shape[1]) < 1:
        raise ValueError("paged_attention: empty dimension")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if H > 65535:
        raise ValueError(f"paged_attention: {H} heads exceed the grid's y limit")
    if (D * pool_k.element_size()) % 16:
        raise ValueError(
            f"paged_attention: head_dim {D} x {pool_k.element_size()} bytes is not a "
            f"multiple of 16 (the kernel copies pages in 16-byte pieces)"
        )
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("positions", positions), ("block_tables", block_tables)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")


def _library():
    global _lib
    if _lib is None:
        from flexflow_tpu_torch.ops.cuda import load

        lib = load("paged_attention")
        lib.ff_paged_attention.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.ff_paged_attention.restype = ctypes.c_int
        lib.ff_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ff_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def paged_attention(q, pool_k, pool_v, positions, block_tables, scale=None):
    """Attention of ``q``'s G rows per lane over the paged pool (see the
    module docstring).  ``scale`` defaults to ``1/sqrt(D)``.  Returns
    (B, G, H, D) in ``q.dtype``."""
    global LAUNCHES
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kinds = {t.device.type for t in (q, pool_k, pool_v, positions, block_tables)}
    if kinds == {"cpu"}:
        return paged_attention_plain(q, pool_k, pool_v, positions, block_tables, scale)
    if kinds != {"cuda"}:
        raise ValueError(
            f"paged_attention: tensors on {sorted(kinds)}; expected all on one "
            f"CUDA device (kernel) or all on the CPU (plain version)"
        )
    _check(q, pool_k, pool_v, positions, block_tables)
    lib = _library()
    B, G, H, D = q.shape
    BS = pool_k.shape[2]
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ff_paged_attention(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            positions.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            B, G, H, D, BS, MB, float(scale),
            int(q.dtype == torch.bfloat16), int(pool_k.dtype == torch.bfloat16),
            stream,
        )
    if rc != 0:
        msg = lib.ff_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES += 1
    return out


def paged_decode_attention(q, pool_k, pool_v, positions, block_tables, scale=None):
    """Decode (G=1) or any G consecutive rows per lane: :func:`paged_attention`."""
    return paged_attention(q, pool_k, pool_v, positions, block_tables, scale)


def paged_prefill_attention(q, pool_k, pool_v, start, block_tables, scale=None):
    """A prefill chunk: ``q`` is (B, P, H, D), row ``g`` of lane ``b`` at
    ``start[b] + g``.  The caller scatters the chunk's K/V into the pool
    first; idle lanes ride with ``start = 0`` and an all-zero table row
    (the trash block) and their rows are discarded.  The same kernel at
    G = P: :func:`paged_attention`."""
    return paged_attention(q, pool_k, pool_v, start, block_tables, scale)
