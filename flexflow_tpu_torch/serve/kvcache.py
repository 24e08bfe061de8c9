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

**Spill and restore** (preemption, drain, the ``ffkv/1`` handoff):
:meth:`PagedKVCache.spill` moves a slot's live positions to host numpy
arrays in ONE device-to-host copy and releases the reservation;
:meth:`PagedKVCache.restore` re-reserves, re-attaches the prefix blocks
still indexed and writes the private span back in ONE host-to-device
copy.  The payload is the JAX package's: ``{"length", "layers":
{"layer{i}": {"k", "v"[, "sk", "sv"]}}[, "kv_dtype"]}`` with dense
``(H, length, D)`` arrays per layer (scales ``(length,)``), free of the
pool's block geometry.  numpy holds neither bfloat16 nor float8, so
those pages travel as their bits (:data:`PAYLOAD_DTYPES`): bfloat16 as
``np.dtype("V2")`` (what ``np.savez`` writes for the JAX package's
bfloat16 arrays) and float8 e4m3 as ``uint8`` (the JAX frames' fp8
storage view).  The round trip is bit-exact.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "PagedKVCache", "KVCacheOOM", "KV_DTYPES", "PAYLOAD_DTYPES", "kv_pool_dtype",
    "kv_qmax", "quantize_kv", "dequantize_kv", "pool_bits",
]

# the --serve-kv-dtype vocabulary; "fp32" means the engine's compute dtype
KV_DTYPES = ("fp32", "bf16", "int8", "fp8")

# symmetric quantization range per storage format: int8 clips at +-127
# (-128 stays unused so the grid is symmetric); 448 is the largest
# finite float8_e4m3fn value
_QMAX = {"int8": 127.0, "fp8": 448.0}


# the numpy dtype a spill payload holds each pool element dtype as: bfloat16
# and float8 pages as their bits (numpy has neither type)
PAYLOAD_DTYPES = {
    torch.float32: np.dtype(np.float32),
    torch.bfloat16: np.dtype("V2"),
    torch.int8: np.dtype(np.int8),
    torch.float8_e4m3fn: np.dtype(np.uint8),
}


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
        # spill/restore copies between host and device, and their bytes
        self.spill_copies = 0
        self.spill_bytes = 0
        self.restore_copies = 0
        self.restore_bytes = 0
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

    def fits_ever(self, seq_len: int) -> bool:
        """Could an EMPTY pool with no shared prefix serve this length?"""
        return self.blocks_for(seq_len) <= self.allocatable_blocks and seq_len <= self.max_seq_len

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

    def shared_write_hazards(self) -> List[Tuple[int, int, int]]:
        """Every block a slot may write (logical index at or past its
        protected boundary) must be private and unindexed.  Returns the
        ``(slot, logical_idx, block)`` rows that are not; empty is safe."""
        out: List[Tuple[int, int, int]] = []
        for slot, blocks in self._owned.items():
            for i in range(self._protected.get(slot, 0), len(blocks)):
                b = blocks[i]
                if self._refcount.get(b, 0) > 1 or b in self._block_key:
                    out.append((slot, i, b))
        return out

    # --- spill / restore (preemption, drain, handoff) ----------------------
    def spill(self, slot: int, length: int) -> Dict[str, Any]:
        """Move ``slot``'s first ``length`` positions to host as a payload
        (module docstring) and release the reservation.  The pages (and a
        quantized pool's scales) are gathered on the device into one
        buffer that crosses to the host in ONE copy."""
        length = int(length)
        # scales first: every part of the one buffer then starts aligned
        names = ("sk", "sv", "k", "v") if self.quantized else ("k", "v")
        dense = self._slot_dense(slot, length, names)
        parts = [(name, dense[name], np.dtype(np.float32) if name in ("sk", "sv")
                  else PAYLOAD_DTYPES[self.dtype]) for name in names]
        flat = torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for _, t, _ in parts])
        host = flat.cpu().numpy()
        self.spill_copies += 1
        self.spill_bytes += int(host.nbytes)
        arrays, at = {}, 0
        for name, t, np_dtype in parts:
            nbytes = t.numel() * t.element_size()
            arrays[name] = host[at:at + nbytes].view(np_dtype).reshape(t.shape)
            at += nbytes
        payload: Dict[str, Any] = {
            "length": length,
            "layers": {
                f"layer{i}": {name: arrays[name][i] for name in arrays}
                for i in range(self.num_layers)
            },
        }
        if self.quantized:
            payload["kv_dtype"] = self.kv_dtype
        self.release(slot)
        return payload

    def restore(self, slot: int, payload: Dict[str, Any], seq_len: int, prompt=None) -> int:
        """Re-reserve ``seq_len`` for ``slot`` (prefix blocks still in the
        index re-attach: they hold the spilled positions' K/V bit for bit)
        and write the payload's private span back into the fresh blocks in
        ONE host-to-device copy.  Returns the re-attached length in
        positions.

        Refused, with the reservation released first: a quantized payload
        into a pool of another ``kv_dtype``, a full-precision payload into
        a quantized pool (re-quantizing would change the stream), and a
        payload whose model shape (layers, heads, head_dim) differs.  The
        payload may come from a pool of another block geometry.  A
        quantized payload's ints and scales are written verbatim; a
        full-precision payload is cast to the pool's dtype (no change when
        they agree)."""
        self.reserve(slot, seq_len, prompt=prompt)
        payload_dtype = str(payload.get("kv_dtype", "fp32"))
        if (self.quantized or payload_dtype in _QMAX) and payload_dtype != (
                self.kv_dtype if self.quantized else "fp32"):
            self.release(slot)
            raise ValueError(
                f"KV payload kv_dtype {payload_dtype!r} cannot restore into a kv_dtype "
                f"{self.kv_dtype!r} pool: re-quantizing a payload would change the stream; "
                f"spill and restore pools must agree on kv_dtype"
            )
        shared_pos = self.shared_len(slot)
        length = int(payload["length"])
        if length <= shared_pos:
            return shared_pos
        L, H, BS, D = self.num_layers, self.heads, self.block_size, self.head_dim
        layers = payload["layers"]
        names = ("k", "v") + (("sk", "sv") if self.quantized else ())
        if sorted(layers) != sorted(f"layer{i}" for i in range(L)):
            self.release(slot)
            raise ValueError(
                f"KV payload holds {len(layers)} layers, this pool {L}: payloads are "
                f"portable across block geometries, not across model shapes"
            )
        host = [{name: np.asarray(layers[f"layer{i}"][name]) for name in names}
                for i in range(L)]
        k = host[0]["k"]
        if any(h[n].shape != ((H, length, D) if n in ("k", "v") else (length,))
               or (n in ("k", "v") and h[n].dtype != k.dtype) for h in host for n in names):
            self.release(slot)
            raise ValueError(
                f"KV payload shape {(L,) + k.shape} does not match this pool's model shape "
                f"(layers={L}, heads={H}, length={length}, head_dim={D}): payloads are "
                f"portable across block geometries, not across model shapes"
            )
        # the payload's element bits and their torch dtype: 1-byte ints
        # verbatim into a quantized pool; float32, or bfloat16 bits (a
        # 2-byte non-float element: ``|V2`` or ml_dtypes' bfloat16), into
        # a full-precision one
        if self.quantized and k.dtype.itemsize == 1:
            bits_np, bits_t = np.dtype(np.uint8), torch.uint8
        elif not self.quantized and k.dtype == np.float32:
            bits_np, bits_t = k.dtype, torch.float32
        elif not self.quantized and k.dtype.kind == "V" and k.dtype.itemsize == 2:
            bits_np, bits_t = np.dtype(np.int16), torch.int16
        else:
            self.release(slot)
            raise ValueError(f"KV payload elements of dtype {k.dtype} cannot restore into a "
                             f"kv_dtype {self.kv_dtype!r} pool")
        lo_blk = shared_pos // BS
        nb = self.blocks_for(length) - lo_blk
        ids = self._owned[slot][lo_blk:lo_blk + nb]
        if any(self._refcount.get(b, 0) > 1 or b in self._block_key for b in ids):
            raise AssertionError("restore would write a shared block (copy-on-write breached)")
        # one host buffer (scales first, so every part starts aligned),
        # filled layer by layer with the private span of each part and
        # zero-padded to whole blocks
        span, lo, live = nb * BS, lo_blk * BS, length - lo_blk * BS
        shapes = {"sk": (L, span), "sv": (L, span), "k": (L, H, span, D), "v": (L, H, span, D)}
        dtypes = {"sk": np.dtype(np.float32), "sv": np.dtype(np.float32), "k": bits_np, "v": bits_np}
        order = [n for n in ("sk", "sv", "k", "v") if n in names]
        sizes = [int(np.prod(shapes[n])) * dtypes[n].itemsize for n in order]
        buf = np.empty(sum(sizes), np.uint8)
        at = 0
        for name, nbytes in zip(order, sizes):
            dst = buf[at:at + nbytes].view(dtypes[name]).reshape(shapes[name])
            if name in ("k", "v"):
                for i in range(L):
                    dst[i, :, :live] = host[i][name][:, lo:].view(bits_np)
                dst[:, :, live:] = 0
            else:
                for i in range(L):
                    dst[i, :live] = host[i][name][lo:]
                dst[:, live:] = 0
            at += nbytes
        dev = torch.from_numpy(buf).to(self.device)
        self.restore_copies += 1
        self.restore_bytes += int(buf.nbytes)
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        at = 0
        for name, nbytes in zip(order, sizes):
            part = dev[at:at + nbytes]
            at += nbytes
            if name in ("sk", "sv"):
                sc = self.scale_k if name == "sk" else self.scale_v
                sc[:, ids_t] = part.view(torch.float32).view(L, nb, BS)
                continue
            x = part.view(bits_t).view(L, H, span, D)
            pool = pool_bits(self.cache_k if name == "k" else self.cache_v)
            if self.quantized:
                x = x.view(pool.dtype)  # the ints verbatim
            else:
                x = (x.view(torch.bfloat16) if bits_t == torch.int16 else x).to(self.dtype)
            pool[:, ids_t] = x.reshape(L, H, nb, BS, D).permute(0, 2, 1, 3, 4)
        return shared_pos

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

    def _slot_dense(self, slot: int, seq_len: int, names) -> Dict[str, torch.Tensor]:
        """``slot``'s first ``seq_len`` positions gathered on the device:
        ``k``/``v`` as ``(L, H, seq_len, D)`` pool bits (:func:`pool_bits`),
        ``sk``/``sv`` as ``(L, seq_len)`` float32 scales."""
        n = self.blocks_for(seq_len)
        row = torch.as_tensor(self.tables[slot, :n], dtype=torch.long, device=self.device)
        L, H, BS, D = self.num_layers, self.heads, self.block_size, self.head_dim
        pools = {"k": self.cache_k, "v": self.cache_v, "sk": self.scale_k, "sv": self.scale_v}
        out = {}
        for name in names:
            if name in ("sk", "sv"):
                out[name] = pools[name][:, row].reshape(L, n * BS)[:, :seq_len]
            else:
                pages = pool_bits(pools[name])[:, row]  # (L, n, H, BS, D)
                out[name] = pages.permute(0, 2, 1, 3, 4).reshape(L, H, n * BS, D)[:, :, :seq_len]
        return out

    def gather_dense(self, slot: int, seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``slot``'s first ``seq_len`` cached positions as dense
        ``(L, H, seq_len, D)`` CPU tensors (dtype preserved)."""
        d = self._slot_dense(slot, seq_len, ("k", "v"))
        return d["k"].cpu().view(self.dtype), d["v"].cpu().view(self.dtype)

    def gather_scales(self, slot: int, seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``slot``'s first ``seq_len`` per-position scales as dense
        ``(L, seq_len)`` float32 CPU tensors (quantized pools only)."""
        if not self.quantized:
            raise ValueError("a full-precision pool has no scales")
        d = self._slot_dense(slot, seq_len, ("sk", "sv"))
        return d["sk"].cpu(), d["sv"].cpu()

    def gather_dense_dequant(self, slot: int, seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`gather_dense` as float32, dequantized with
        :func:`dequantize_kv` when the pool is quantized."""
        k, v = self.gather_dense(slot, seq_len)
        if not self.quantized:
            return k.float(), v.float()
        sk, sv = self.gather_scales(slot, seq_len)
        # k is (L, H, S, D); the (L, S) scales broadcast over heads
        return dequantize_kv(k, sk[:, None]), dequantize_kv(v, sv[:, None])

    def hbm_bytes(self) -> int:
        """Device bytes of the pools (both caches, plus the scales)."""
        n = 2 * self.cache_k.numel() * self.cache_k.element_size()
        if self.quantized:
            n += 2 * self.scale_k.numel() * 4
        return n

    @property
    def bytes_per_token(self) -> int:
        """Device bytes one cached position costs across all layers: its K
        and V elements, plus two float32 scales per layer when quantized."""
        n = 2 * self.num_layers * self.heads * self.head_dim * self.cache_k.element_size()
        if self.quantized:
            n += 2 * self.num_layers * 4
        return n
