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
  the TPU kernel ``_kernel`` of the JAX module, full-precision and
  quantized) on one of three routes (:func:`route`): the decode path,
  split over pages, for one row per lane (G = 1, decode) at D 64 or 128
  (:func:`decode_plan`); the row-group path, split over pages, for
  G >= :data:`SPLIT_MIN_ROWS` rows at D 64 and a BS dividing 64
  (:func:`split_plan`); the single pass for every other call.  Every
  route takes every pool format.  It adds one to :data:`LAUNCHES`, to
  :data:`LAUNCHES_BY_POOL` under the pool's dtype and to
  :data:`LAUNCHES_BY_ROUTE` under the route, once per call (the
  row-group path's split and combine kernels are one call); a build or launch
  failure raises.  On CPU tensors it takes the plain version and counts
  nothing.  It never falls back from CUDA to the plain version or from
  one route to another.
* :func:`paged_attention_plain` is the plain PyTorch version: gather
  ``pool[block_tables]`` to (B, H, SV, D) (times the gathered scale rows
  when quantized), mask ``k_pos <= pos0 + g``,
  mul+sum score contraction, float32 softmax.  It is the function the
  engine's ``attend`` computes (``attn="gather"``) and what the CPU
  tests run.
* :func:`paged_attention_split_plain` is the plain version of the
  kernel's two split paths (decode and row groups): the softmax taken
  over segments of pages, each segment's (max, sum, weighted sum) kept,
  then merged.  Only the tests use it.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "LAUNCHES",
    "LAUNCHES_BY_POOL",
    "LAUNCHES_BY_ROUTE",
    "MAX_HEAD_DIM",
    "decode_plan",
    "paged_attention",
    "paged_attention_plain",
    "paged_attention_split_plain",
    "paged_decode_attention",
    "paged_prefill_attention",
    "resolve_serve_attn",
    "route",
    "split_plan",
]

# kernel launches through paged_attention(); read and reset by callers
# that need to show which path a run took
LAUNCHES = 0
# the same launches by pool dtype name ("float32", "bfloat16", "int8",
# "float8_e4m3fn")
LAUNCHES_BY_POOL: dict = {}
# the same launches by route: "single" (the single pass), "split" (the
# row-group path, split over pages, and its combine) or "decode" (the
# decode path, split over pages, whose last split of a lane merges them)
LAUNCHES_BY_ROUTE = {"single": 0, "split": 0, "decode": 0}

MAX_HEAD_DIM = 256  # the kernel keeps D / 32 accumulators per lane, at most 8
# calls with at least this many rows per lane take the kernel's row-group
# path (at D 64 and a BS dividing 64, over every pool format): 64-key tiles
# on the tensor cores, the lane's pages split over blocks of two tiles
# each, a combine pass after
SPLIT_MIN_ROWS = 2
# the path's shapes, as csrc/paged_attention.cu fixes them (kTileKeys,
# kSplitTiles, its one head dim); the kernel computes its splits itself and
# refuses a workspace smaller than these give
_TILE_KEYS, _SPLIT_TILES, _SPLIT_HEAD_DIM = 64, 2, 64
# calls with one row per lane (decode) take the kernel's decode path at
# these head dims, over every pool format and any BS; False sends them to
# the single pass (or, with SPLIT_MIN_ROWS 1, the row-group path), which is
# how the designs it replaced are timed beside it
DECODE_PATH = True
# the decode path's shapes, as csrc/paged_attention.cu fixes them
# (kDecodeKeys: a split holds that many keys' worth of whole pages, at
# least one); the kernel computes its splits itself and refuses a smaller
# workspace
_DECODE_KEYS, _DECODE_HEAD_DIMS = 64, (64, 128)
_FLOATS = (torch.float32, torch.bfloat16)
_QUANT = (torch.int8, torch.float8_e4m3fn)
# the kernel's pool-format codes (csrc/paged_attention.cu)
_POOL_FORMAT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_lib = None
# the decode path's per-(lane, head) split counts, int32 zeros by (device,
# stream): the kernel's last split of a lane sets its count back to 0, so a
# buffer stays zero between the calls of its stream, which run in order
_COUNTS: dict = {}


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


def _check_scales(pool_k, pool_v, scale_k, scale_v) -> None:
    """Scale rows come with a quantized pool and only with one."""
    if (scale_k is None) != (scale_v is None):
        raise ValueError("paged_attention: pass both scale_k and scale_v, or neither")
    quant = pool_k.dtype in _QUANT or pool_v.dtype in _QUANT
    if quant and scale_k is None:
        raise ValueError(
            f"paged_attention: a {pool_k.dtype} pool needs its scale_k/scale_v rows")
    if scale_k is not None and not quant:
        raise ValueError(
            f"paged_attention: scale rows given with a {pool_k.dtype} pool; they "
            f"belong to int8 or float8_e4m3fn pools")


def _pages(pool, bt, scales):
    """``pool[bt]`` as float32 (B, MB, H, BS, D), dequantized as the pool's
    rule does when ``scales`` (N, BS) are given."""
    if scales is None:
        return pool[bt].float()
    # float8 pages are gathered as their bytes (serve/kvcache.py pool_bits)
    fp8 = pool.dtype == torch.float8_e4m3fn
    pages = pool.view(torch.uint8)[bt].view(pool.dtype) if fp8 else pool[bt]
    return pages.float() * scales[bt][:, :, None, :, None]


def _scores(q, pool_k, pool_v, positions, block_tables, scale, scale_k, scale_v):
    """The plain versions' float32 scores (B, G, H, SV) over the gathered
    (dequantized) keys, their visibility (B, G, 1, SV) and the values
    (B, H, SV, D)."""
    _check_scales(pool_k, pool_v, scale_k, scale_v)
    B, G, H, D = q.shape
    SV = block_tables.shape[1] * pool_k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    keys = _pages(pool_k, bt, scale_k).permute(0, 2, 1, 3, 4).reshape(B, H, SV, D)
    vals = _pages(pool_v, bt, scale_v).permute(0, 2, 1, 3, 4).reshape(B, H, SV, D)
    scores = (q.float()[..., None, :] * keys[:, None]).sum(-1) * scale  # (B, G, H, SV)
    k_pos = torch.arange(SV, device=q.device)
    row_pos = positions.long()[:, None] + torch.arange(G, device=q.device)  # (B, G)
    vis = (k_pos[None, None, :] <= row_pos[:, :, None])[:, :, None, :]
    return scores, vis, vals


def paged_attention_plain(q, pool_k, pool_v, positions, block_tables, scale=None,
                          scale_k=None, scale_v=None):
    """The plain PyTorch version (see the module docstring)."""
    scores, vis, vals = _scores(q, pool_k, pool_v, positions, block_tables, scale,
                                scale_k, scale_v)
    w = torch.softmax(torch.where(vis, scores, torch.finfo(torch.float32).min), dim=-1)
    return (w[..., None] * vals[:, None]).sum(-2).to(q.dtype)


def split_plan(G, D, BS, MB, pool_dtype):
    """``(splits, pages per split)`` of the kernel's row-group path for
    ``G`` rows per lane over tables of ``MB`` pages of ``BS`` in a pool of
    ``pool_dtype`` (float32, bfloat16, int8 or float8_e4m3fn), or None
    where the path does not take the call (fewer rows, a head dim or page
    size it does not take); :func:`route` tries :func:`decode_plan` first."""
    if (pool_dtype not in _POOL_FORMAT or G < SPLIT_MIN_ROWS or D != _SPLIT_HEAD_DIM
            or _TILE_KEYS % BS):
        return None
    pages = _SPLIT_TILES * (_TILE_KEYS // BS)
    return -(-MB // pages), pages


def decode_plan(G, D, BS, MB, pool_dtype):
    """``(splits, pages per split)`` of the kernel's decode path for one
    row per lane (``G`` 1) over tables of ``MB`` pages of ``BS`` in a pool
    of ``pool_dtype``, or None where another path runs (more rows, a head
    dim other than 64 and 128, :data:`DECODE_PATH` off)."""
    if (not DECODE_PATH or pool_dtype not in _POOL_FORMAT or G != 1
            or D not in _DECODE_HEAD_DIMS):
        return None
    pages = max(1, _DECODE_KEYS // BS)
    return -(-MB // pages), pages


def route(G, D, BS, MB, pool_dtype):
    """The kernel path a call of these shapes takes: ``"decode"``
    (:func:`decode_plan`), else ``"split"`` (:func:`split_plan`), else
    ``"single"``."""
    if decode_plan(G, D, BS, MB, pool_dtype) is not None:
        return "decode"
    if split_plan(G, D, BS, MB, pool_dtype) is not None:
        return "split"
    return "single"


def paged_attention_split_plain(q, pool_k, pool_v, positions, block_tables, scale=None,
                                scale_k=None, scale_v=None, pages_per_split=4):
    """The plain version of the split-and-combine arithmetic: the lane's
    pages in segments of ``pages_per_split`` (the last one shorter); per
    segment and row the max ``m`` of the visible scores, ``l = sum
    exp(s - m)`` and ``acc = sum exp(s - m) v`` (``l = 0`` where the row
    sees none of the segment); then ``M = max m`` over segments with
    ``l > 0`` and ``out = sum acc e^(m - M) / sum l e^(m - M)``."""
    scores, vis, vals = _scores(q, pool_k, pool_v, positions, block_tables, scale,
                                scale_k, scale_v)
    SV, BS = scores.shape[-1], pool_k.shape[2]
    neg = torch.finfo(torch.float32).min
    ms, ls, accs = [], [], []
    for lo in range(0, SV, pages_per_split * BS):
        seg = slice(lo, min(SV, lo + pages_per_split * BS))
        v = vis[..., seg]
        s = torch.where(v, scores[..., seg], neg)
        m = s.amax(-1)
        p = torch.where(v, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append((p[..., None] * vals[:, None, :, seg]).sum(-2))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)  # segments first
    top = torch.where(l > 0, m, neg).amax(0)
    w = torch.where(l > 0, torch.exp(m - top), 0.0)
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0)[..., None]
    return out.to(q.dtype)


def _check(q, pool_k, pool_v, positions, block_tables, scale_k=None, scale_v=None) -> None:
    _check_scales(pool_k, pool_v, scale_k, scale_v)
    dev = q.device
    tensors = [("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
               ("positions", positions), ("block_tables", block_tables)]
    if scale_k is not None:
        tensors += [("scale_k", scale_k), ("scale_v", scale_v)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} is on {t.device}, q on {dev}")
    if q.dtype not in _FLOATS or pool_k.dtype not in _FLOATS + _QUANT:
        raise TypeError(
            f"paged_attention: q {q.dtype} / pools {pool_k.dtype}: the kernel "
            f"takes a float32 or bfloat16 q over float32, bfloat16, int8 or "
            f"float8_e4m3fn pools"
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
    if scale_k is not None:
        for name, t in (("scale_k", scale_k), ("scale_v", scale_v)):
            if t.dtype != torch.float32 or tuple(t.shape) != (N, BS):
                raise ValueError(
                    f"paged_attention: {name} must be float32 of shape ({N}, {BS}) "
                    f"(one row per pool block), not {t.dtype} {tuple(t.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if H > 65535:
        raise ValueError(f"paged_attention: {H} heads exceed the grid's y limit")
    if (D * pool_k.element_size()) % 16:
        raise ValueError(
            f"paged_attention: head_dim {D} x {pool_k.element_size()} bytes is not a "
            f"multiple of 16 (the kernel copies pages in 16-byte pieces)"
        )
    for name, t in tensors:
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
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.ff_paged_attention.restype = ctypes.c_int
        lib.ff_paged_attention_split.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.ff_paged_attention_split.restype = ctypes.c_int
        lib.ff_paged_attention_decode.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.ff_paged_attention_decode.restype = ctypes.c_int
        lib.ff_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ff_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _decode_counts(device, stream, n):
    """At least ``n`` int32 zeros for the decode path's split counts, kept
    for ``device`` and ``stream``."""
    key = (device.index, stream)
    counts = _COUNTS.get(key)
    if counts is None or counts.numel() < n:
        counts = _COUNTS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return counts


def paged_attention(q, pool_k, pool_v, positions, block_tables, scale=None,
                    scale_k=None, scale_v=None):
    """Attention of ``q``'s G rows per lane over the paged pool (see the
    module docstring).  ``scale`` defaults to ``1/sqrt(D)``; ``scale_k``
    and ``scale_v`` are the layer's scale rows of a quantized pool (both
    or neither).  Returns (B, G, H, D) in ``q.dtype``."""
    global LAUNCHES
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    tensors = (q, pool_k, pool_v, positions, block_tables, scale_k, scale_v)
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return paged_attention_plain(q, pool_k, pool_v, positions, block_tables, scale,
                                     scale_k, scale_v)
    if kinds != {"cuda"}:
        raise ValueError(
            f"paged_attention: tensors on {sorted(kinds)}; expected all on one "
            f"CUDA device (kernel) or all on the CPU (plain version)"
        )
    _check(q, pool_k, pool_v, positions, block_tables, scale_k, scale_v)
    lib = _library()
    B, G, H, D = q.shape
    BS = pool_k.shape[2]
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    path = route(G, D, BS, MB, pool_k.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tensors = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                   None if scale_k is None else scale_k.data_ptr(),
                   None if scale_v is None else scale_v.data_ptr(),
                   positions.data_ptr(), block_tables.data_ptr(), out.data_ptr())
        formats = (int(q.dtype == torch.bfloat16), _POOL_FORMAT[pool_k.dtype], stream)
        if path == "single":
            rc = lib.ff_paged_attention(*tensors, B, G, H, D, BS, MB, float(scale), *formats)
        else:
            # the splits' (acc, m, l) partials, which the launch merges
            plan = (decode_plan if path == "decode" else split_plan)(G, D, BS, MB,
                                                                     pool_k.dtype)
            part = torch.empty(B * H * plan[0] * G * (D + 2), dtype=torch.float32,
                               device=q.device)
            if path == "decode":
                counts = _decode_counts(q.device, stream, B * H)
                rc = lib.ff_paged_attention_decode(
                    *tensors, part.data_ptr(), part.numel(), counts.data_ptr(), B, H, D, BS, MB,
                    float(scale), *formats)
            else:
                rc = lib.ff_paged_attention_split(
                    *tensors, part.data_ptr(), part.numel(), B, G, H, D, BS, MB,
                    float(scale), *formats)
    if rc != 0:
        msg = lib.ff_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES += 1
    name = str(pool_k.dtype).replace("torch.", "")
    LAUNCHES_BY_POOL[name] = LAUNCHES_BY_POOL.get(name, 0) + 1
    LAUNCHES_BY_ROUTE[path] += 1
    return out


def paged_decode_attention(q, pool_k, pool_v, positions, block_tables, scale=None,
                           scale_k=None, scale_v=None):
    """Decode (G=1) or any G consecutive rows per lane: :func:`paged_attention`."""
    return paged_attention(q, pool_k, pool_v, positions, block_tables, scale, scale_k, scale_v)


def paged_prefill_attention(q, pool_k, pool_v, start, block_tables, scale=None,
                            scale_k=None, scale_v=None):
    """A prefill chunk: ``q`` is (B, P, H, D), row ``g`` of lane ``b`` at
    ``start[b] + g``.  The caller scatters the chunk's K/V into the pool
    first; idle lanes ride with ``start = 0`` and an all-zero table row
    (the trash block) and their rows are discarded.  The same kernel at
    G = P: :func:`paged_attention`."""
    return paged_attention(q, pool_k, pool_v, start, block_tables, scale, scale_k, scale_v)
