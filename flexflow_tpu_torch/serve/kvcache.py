"""Paged KV-cache allocator with copy-on-write prefix sharing.

Counterpart of ``flexflow_tpu/serve/kvcache.py`` ``PagedKVCache``.  The
host side is the same allocator: a free list, per-slot block tables, and
ref-counted prefix blocks keyed by the cumulative hash of the prompt
tokens they hold (retained in an LRU once unreferenced and evicted when
the free list runs dry).  The device side is two torch tensors
``cache_k``/``cache_v`` of shape ``(L, num_blocks, H, block_size, D)`` on
the engine's device, which the serve programs update in place.

Pools are full precision (``kv_dtype`` "fp32", meaning the engine's
compute dtype, or "bf16") or quantized ("int8", "fp8" =
``torch.float8_e4m3fn``).  A quantized pool stores each position's K and
V with one symmetric float32 scale over its (H, D) elements
(:func:`quantize_kv`); the scales live in ``scale_k``/``scale_v`` of
shape ``(L, num_blocks, block_size)``, addressed by physical block like
the pools, and every reader dequantizes with :func:`dequantize_kv`.
Zero scales (the initial state) dequantize never-written positions to
exact zeros.

Physical block 0 is the trash block: never allocated, it absorbs the
writes of idle decode lanes and padded prefill rows (their table rows
are all zero).

Not ported yet (ROADMAP.md): ``spill``/``restore``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "PagedKVCache", "KVCacheOOM", "KV_DTYPES", "kv_pool_dtype", "kv_qmax",
    "quantize_kv", "dequantize_kv", "pool_bits",
]

# the --serve-kv-dtype vocabulary; "fp32" means the engine's compute dtype
KV_DTYPES = ("fp32", "bf16", "int8", "fp8")

# symmetric quantization range per storage format: int8 clips at +-127
# (-128 stays unused so the grid is symmetric); 448 is the largest
# finite float8_e4m3fn value
_QMAX = {"int8": 127.0, "fp8": 448.0}


def kv_qmax(kv_dtype: str) -> Optional[float]:
    """Quantization ceiling of ``kv_dtype``; None for full precision."""
    return _QMAX.get(kv_dtype)


def kv_pool_dtype(kv_dtype: str, fallback: torch.dtype = torch.float32) -> torch.dtype:
    """The pool element dtype of ``kv_dtype`` ("fp32" is ``fallback``, the
    engine's compute dtype)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r}: expected one of {KV_DTYPES}")
    return {"fp32": fallback, "bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[kv_dtype]


def quantize_kv(x: torch.Tensor, kv_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The write-side rule: symmetric per-position scales over the
    trailing (H, D) axes.  ``x`` is (..., H, D); returns ``(q, scale)``,
    ``q`` in the pool dtype and ``scale`` float32 of shape
    ``x.shape[:-2]``.  An all-zero position gets scale 1.0.  int8 rounds
    half to even and clips at +-127; fp8 is a plain cast (``x / scale``
    stays within 448 x (1 + 2^-23), which rounds to 448)."""
    qmax = _QMAX[kv_dtype]
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = xf / scale[..., None, None]
    if kv_dtype == "int8":
        return torch.round(q).clamp(-qmax, qmax).to(torch.int8), scale
    return q.to(torch.float8_e4m3fn), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The read-side rule every reader shares: the stored elements widened
    to float32 times their position's scale.  ``q`` is (..., S, D) with
    positions on the second-to-last axis, ``scale`` (..., S)."""
    return q.float() * scale[..., None]


def pool_bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for float8 its bytes as uint8: indexing and
    scattering float8 tensors is not implemented on every device, and the
    bytes are the same values bit for bit."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


class KVCacheOOM(RuntimeError):
    """A reservation asked for more blocks than the free list (plus
    evictable cached blocks) holds.  The scheduler pre-checks
    :meth:`PagedKVCache.can_reserve`, so this surfaces only on misuse."""


class PagedKVCache:
    """Free-list block allocator plus the device-side paged K/V pools."""

    def __init__(
        self,
        num_layers: int,
        heads: int,
        head_dim: int,
        *,
        slots: int,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_blocks_per_seq: Optional[int] = None,
        max_seq_len: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        kv_dtype: str = "fp32",
        prefix_sharing: bool = True,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> None:
        if block_size < 1 or slots < 1:
            raise ValueError(f"block_size {block_size} and slots {slots} must be >= 1")
        pool_dtype = kv_pool_dtype(kv_dtype, fallback=dtype)
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.heads = heads
        self.head_dim = head_dim
        self.slots = slots
        self.block_size = block_size
        self.prefix_sharing = bool(prefix_sharing)
        if max_blocks_per_seq is None:
            if max_seq_len is None:
                raise ValueError("need max_blocks_per_seq or max_seq_len")
            max_blocks_per_seq = -(-max_seq_len // block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        # positions a request may occupy: the table's reach, tightened to
        # the model's position range when given
        self.position_limit = self.max_blocks_per_seq * block_size
        if max_seq_len is not None:
            self.position_limit = min(self.position_limit, int(max_seq_len))
        if num_blocks is None:
            # full provisioning: every slot can hold max length, + trash
            num_blocks = slots * self.max_blocks_per_seq + 1
        if num_blocks < 2:
            raise ValueError("need at least the trash block + one real block")
        self.num_blocks = int(num_blocks)
        self.kv_dtype = kv_dtype
        self.dtype = pool_dtype
        self.quantized = kv_dtype in _QMAX
        self.qmax = kv_qmax(kv_dtype)

        self._free: deque = deque(range(1, self.num_blocks))  # block 0 never enters
        self._owned: Dict[int, List[int]] = {}  # slot -> blocks, in order
        # sharing state: refcount per mapped block, cumulative-hash index,
        # retained (refcount-0 but still indexed) LRU, and the per-slot
        # count of leading read-only logical blocks
        self._refcount: Dict[int, int] = {}
        self._index: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        self._cached: "OrderedDict[int, bytes]" = OrderedDict()
        self._protected: Dict[int, int] = {}
        self.prefix_hits = 0
        self.prefix_lookups = 0
        self.evictions = 0
        self.cow_copies = 0
        self.tables = np.zeros((slots, self.max_blocks_per_seq), np.int32)
        shape = (num_layers, self.num_blocks, heads, block_size, head_dim)
        self.cache_k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.cache_v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        # per-position scales of a quantized pool, rows addressed by
        # physical block like the pools
        self.scale_k: Optional[torch.Tensor] = None
        self.scale_v: Optional[torch.Tensor] = None
        if self.quantized:
            sshape = (num_layers, self.num_blocks, block_size)
            self.scale_k = torch.zeros(sshape, dtype=torch.float32, device=self.device)
            self.scale_v = torch.zeros(sshape, dtype=torch.float32, device=self.device)

    # --- capacity queries --------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        """Retained prefix blocks: refcount 0, still indexed, evictable."""
        return len(self._cached)

    @property
    def allocatable_blocks(self) -> int:
        """Blocks a single request could ever hold (pool minus trash)."""
        return self.num_blocks - 1

    @property
    def max_seq_len(self) -> int:
        return self.position_limit

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        if not self.prefix_lookups:
            return None
        return self.prefix_hits / self.prefix_lookups

    def blocks_for(self, seq_len: int) -> int:
        return -(-int(seq_len) // self.block_size)

    def shareable_blocks(self, prompt) -> int:
        """Leading FULL blocks of ``prompt`` eligible for sharing; the last
        prompt position stays private so the consumer's own prefill
        computes the first next-token distribution."""
        if prompt is None or not self.prefix_sharing:
            return 0
        return max(0, (int(len(prompt)) - 1) // self.block_size)

    def _prefix_key(self, prompt, nblocks: int) -> bytes:
        tok = np.asarray(prompt, np.int32)[: nblocks * self.block_size]
        return hashlib.sha1(tok.tobytes()).digest()

    def prefix_matches(self, prompt) -> List[int]:
        """Physical ids of the longest indexed run of leading full blocks
        of ``prompt`` (stops at the first miss; no refcount changes)."""
        out: List[int] = []
        for b in range(self.shareable_blocks(prompt)):
            blk = self._index.get(self._prefix_key(prompt, b + 1))
            if blk is None:
                break
            out.append(blk)
        return out

    def blocks_needed(self, seq_len: int, prompt=None) -> Tuple[int, int]:
        """``(total, shared)`` blocks for a reservation; admission charges
        ``total - shared``."""
        total = self.blocks_for(seq_len)
        shared = min(len(self.prefix_matches(prompt)), total)
        return total, shared

    def can_reserve(self, seq_len: int, prompt=None) -> bool:
        total, shared = self.blocks_needed(seq_len, prompt)
        # cached blocks the reservation itself re-attaches are not
        # evictable for it
        matches = set(self.prefix_matches(prompt))
        evictable = sum(1 for b in self._cached if b not in matches)
        return total - shared <= len(self._free) + evictable

    def fits_with_sharing(self, seq_len: int, prompt=None) -> bool:
        """Could this request ever be admitted given the prefix blocks
        currently indexed?"""
        if seq_len > self.max_seq_len:
            return False
        total, shared = self.blocks_needed(seq_len, prompt)
        return total - shared <= self.allocatable_blocks

    # --- reserve / release -------------------------------------------------
    def _acquire(self, n: int, protect=()) -> List[int]:
        """Take ``n`` writable blocks: free list first, then evict LRU
        retained prefix blocks (never one in ``protect``)."""
        protect = set(protect)
        out: List[int] = []
        while len(out) < n:
            if self._free:
                out.append(self._free.popleft())
                continue
            victim = next((b for b in self._cached if b not in protect), None)
            if victim is None:
                self._free.extendleft(reversed(out))  # a failed reserve takes nothing
                raise KVCacheOOM(
                    f"need {n} KV blocks, {len(self._free)} free + "
                    f"{len(self._cached)} cached (pool "
                    f"{self.allocatable_blocks}, block {self.block_size})"
                )
            self._evict(victim)
            out.append(self._free.popleft())
        return out

    def _evict(self, blk: int) -> None:
        self._cached.pop(blk)
        key = self._block_key.pop(blk)
        self._index.pop(key, None)
        self._free.append(blk)
        self.evictions += 1

    def reserve(self, slot: int, seq_len: int, prompt=None) -> List[int]:
        """Map ``blocks_for(seq_len)`` blocks into ``slot``'s table: prefix
        hits re-attached (refcount bump), the rest taken off the free list.
        Raises :exc:`KVCacheOOM` when short."""
        if not 0 <= slot < self.slots or slot in self._owned:
            raise ValueError(f"slot {slot}: out of range or already reserved")
        n = self.blocks_for(seq_len)
        if n > self.max_blocks_per_seq:
            raise ValueError(
                f"seq_len {seq_len} exceeds max_blocks_per_seq "
                f"{self.max_blocks_per_seq} x block_size {self.block_size}"
            )
        shared = self.prefix_matches(prompt)[:n]
        want = self.shareable_blocks(prompt)
        if want:
            self.prefix_lookups += min(want, n)
            self.prefix_hits += len(shared)
        fresh = self._acquire(n - len(shared), protect=shared)
        for b in shared:
            self._cached.pop(b, None)  # revive a retained block
            self._refcount[b] = self._refcount.get(b, 0) + 1
        for b in fresh:
            self._refcount[b] = 1
        blocks = shared + fresh
        self._owned[slot] = blocks
        self._protected[slot] = len(shared)
        self.tables[slot, :] = 0
        self.tables[slot, :n] = blocks
        return blocks

    def shared_len(self, slot: int) -> int:
        """Positions of ``slot`` served by re-attached prefix blocks."""
        return self._protected.get(slot, 0) * self.block_size

    def release(self, slot: int) -> None:
        """Drop ``slot``'s references.  Registered blocks whose refcount
        reaches zero are retained in the LRU; the rest go back to the
        free list."""
        blocks = self._owned.pop(slot, None)
        if blocks is None:
            raise ValueError(f"slot {slot} holds no reservation")
        self._protected.pop(slot, None)
        for b in blocks:
            rc = self._refcount.get(b, 0) - 1
            if rc < 0:
                raise AssertionError(f"double-free of block {b}")
            if rc:
                self._refcount[b] = rc
                continue
            del self._refcount[b]
            if b in self._block_key:
                self._cached[b] = self._block_key[b]  # LRU tail
            else:
                self._free.append(b)
        self.tables[slot, :] = 0

    def refcount(self, blk: int) -> int:
        return self._refcount.get(blk, 0)

    def owned(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._owned.get(slot, ()))

    # --- prefix registration / copy-on-write -------------------------------
    def commit_prefix(self, slot: int, prompt, upto: int) -> int:
        """Register ``slot``'s fully written full-prompt blocks (all
        positions < ``upto``) under their cumulative hashes; they become
        read-only for the producer too.  Returns how many blocks of the
        slot are now registered."""
        if not self.prefix_sharing or slot not in self._owned:
            return 0
        full = min(int(upto), int(len(prompt))) // self.block_size
        done = 0
        for b in range(min(full, len(self._owned[slot]))):
            blk = self._owned[slot][b]
            if blk in self._block_key:
                done += 1
                continue  # already registered (ours or re-attached)
            key = self._prefix_key(prompt, b + 1)
            if key in self._index:
                continue  # another slot registered identical content first
            self._index[key] = blk
            self._block_key[blk] = key
            done += 1
        self._protected[slot] = max(self._protected.get(slot, 0), done)
        return done

    def ensure_private(self, slot: int, logical_idx: int) -> int:
        """Copy-on-write: make ``slot``'s ``logical_idx``-th block writable.
        A block shared with other tables is replaced by a fresh copy of
        its device contents; a sole-owned indexed block is de-registered.
        Returns the (possibly new) physical id."""
        blocks = self._owned[slot]
        blk = blocks[logical_idx]
        if self._refcount.get(blk, 0) <= 1:
            if blk in self._block_key:
                self._index.pop(self._block_key.pop(blk), None)
            self._protected[slot] = min(self._protected.get(slot, 0), logical_idx)
            return blk
        new = self._acquire(1, protect=blocks)[0]
        # in place: copy every layer's page (and its scale row) into the
        # fresh block
        for pool in (self.cache_k, self.cache_v, self.scale_k, self.scale_v):
            if pool is not None:
                pool_bits(pool)[:, new] = pool_bits(pool)[:, blk]
        self.cow_copies += 1
        self._refcount[blk] -= 1
        self._refcount[new] = 1
        blocks[logical_idx] = new
        self.tables[slot, logical_idx] = new
        self._protected[slot] = min(self._protected.get(slot, 0), logical_idx)
        return new

    # --- invariants ---------------------------------------------------------
    def check_invariants(self) -> None:
        """Every block is free, retained (refcount 0 + indexed), or mapped
        by >= 1 table with a matching refcount; the trash block is none of
        these; the index and reverse map agree.  Raises AssertionError."""
        free = list(self._free)
        cached = list(self._cached)
        owned = [b for bs in self._owned.values() for b in bs]

        def require(cond: bool, what: str) -> None:
            if not cond:
                raise AssertionError(what)

        require(0 not in free + cached + owned, "trash block allocated")
        counts: Dict[int, int] = {}
        for b in owned:
            counts[b] = counts.get(b, 0) + 1
        require(counts == self._refcount, "refcounts disagree with table ownership")
        require(not (set(free) | set(cached)) & set(owned), "block both free/cached and owned")
        require(not set(free) & set(cached), "block both free and cached")
        require(
            sorted(free + cached + sorted(set(owned))) == list(range(1, self.num_blocks)),
            "blocks leaked or invented",
        )
        for key, blk in self._index.items():
            require(self._block_key.get(blk) == key, "index/reverse mismatch")
        for blk in cached:
            require(blk in self._block_key, "retained block lost its key")

    # --- views --------------------------------------------------------------
    def table_row(self, slot: int) -> np.ndarray:
        """One slot's (max_blocks_per_seq,) block table."""
        return self.tables[slot].copy()

    def gather_dense(self, slot: int, seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``slot``'s first ``seq_len`` cached positions as dense
        ``(L, H, seq_len, D)`` CPU tensors (dtype preserved)."""
        n = self.blocks_for(seq_len)
        row = torch.as_tensor(self.tables[slot, :n], dtype=torch.long, device=self.device)
        L, H, BS, D = self.num_layers, self.heads, self.block_size, self.head_dim

        def dense(pool: torch.Tensor) -> torch.Tensor:
            pages = pool_bits(pool)[:, row]  # (L, n, H, BS, D)
            out = pages.permute(0, 2, 1, 3, 4).reshape(L, H, n * BS, D)
            return out[:, :, :seq_len].cpu().view(pool.dtype)

        return dense(self.cache_k), dense(self.cache_v)

    def gather_scales(self, slot: int, seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``slot``'s first ``seq_len`` per-position scales as dense
        ``(L, seq_len)`` float32 CPU tensors (quantized pools only)."""
        if not self.quantized:
            raise ValueError("a full-precision pool has no scales")
        n = self.blocks_for(seq_len)
        row = torch.as_tensor(self.tables[slot, :n], dtype=torch.long, device=self.device)

        def dense(sc: torch.Tensor) -> torch.Tensor:
            return sc[:, row].reshape(self.num_layers, -1)[:, :seq_len].cpu()

        return dense(self.scale_k), dense(self.scale_v)

    def gather_dense_dequant(self, slot: int, seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`gather_dense` as float32, dequantized with
        :func:`dequantize_kv` when the pool is quantized."""
        k, v = self.gather_dense(slot, seq_len)
        if not self.quantized:
            return k.float(), v.float()
        sk, sv = self.gather_scales(slot, seq_len)
        # k is (L, H, S, D); the (L, S) scales broadcast over heads
        return dequantize_kv(k, sk[:, None]), dequantize_kv(v, sv[:, None])

    @property
    def bytes_per_token(self) -> int:
        """Device bytes one cached position costs across all layers: its K
        and V elements, plus two float32 scales per layer when quantized."""
        n = 2 * self.num_layers * self.heads * self.head_dim * self.cache_k.element_size()
        if self.quantized:
            n += 2 * self.num_layers * 4
        return n
