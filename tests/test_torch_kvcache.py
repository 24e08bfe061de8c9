"""The port's paged KV allocator and traffic generator against the JAX ones.

The same sequence of ``reserve`` / ``commit_prefix`` / ``ensure_private``
/ ``release`` on the JAX and the port ``PagedKVCache`` must leave
identical block tables, refcounts, free lists and prefix state, with
``check_invariants`` holding on both after every step; copy-on-write
must copy the same device contents.  ``synthetic_requests`` must give
identical requests for the same ``TrafficSpec``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from flexflow_tpu.serve.kvcache import PagedKVCache as JaxKV  # noqa: E402
from flexflow_tpu.serve.traffic import TrafficSpec as JaxSpec  # noqa: E402
from flexflow_tpu.serve.traffic import synthetic_requests as jax_requests  # noqa: E402
from flexflow_tpu_torch.serve.kvcache import KVCacheOOM, PagedKVCache  # noqa: E402
from flexflow_tpu_torch.serve.scheduler import RequestState  # noqa: E402
from flexflow_tpu_torch.serve.traffic import TrafficSpec, synthetic_requests  # noqa: E402

L, H, D, BS = 2, 2, 4, 4


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(slots=3, num_blocks=12, max_seq_len=24):
    kw = dict(slots=slots, block_size=BS, num_blocks=num_blocks, max_seq_len=max_seq_len)
    return JaxKV(L, H, D, **kw), PagedKVCache(L, H, D, device="cpu", **kw)


def _same_state(j, t):
    np.testing.assert_array_equal(j.tables, t.tables)
    assert list(j._free) == list(t._free)
    assert list(j._cached) == list(t._cached)
    assert {b: j.refcount(b) for b in range(j.num_blocks)} == {
        b: t.refcount(b) for b in range(t.num_blocks)
    }
    assert {s: j.owned(s) for s in range(j.slots)} == {s: t.owned(s) for s in range(t.slots)}
    assert j._index == t._index and j._protected == t._protected
    assert (j.prefix_hits, j.prefix_lookups, j.evictions, j.cow_copies) == (
        t.prefix_hits, t.prefix_lookups, t.evictions, t.cow_copies)
    j.check_invariants()
    t.check_invariants()


def test_allocator_sequence_matches_jax():
    j, t = _pair()
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, 50, size=9).astype(np.int32)
    p1 = np.concatenate([sys_prompt, [1, 2, 3]]).astype(np.int32)
    p2 = np.concatenate([sys_prompt, [7, 8]]).astype(np.int32)
    p3 = rng.integers(0, 50, size=5).astype(np.int32)
    steps = [
        ("reserve", (0, 16, p1)),
        ("commit_prefix", (0, p1, 8)),
        ("reserve", (1, 14, p2)),  # re-attaches slot 0's two prompt blocks
        ("ensure_private", (1, 1)),  # shared -> CoW copy
        ("ensure_private", (1, 2)),  # private already
        ("commit_prefix", (1, p2, 11)),
        ("release", (0,)),  # registered blocks retained in the LRU
        ("reserve", (2, 20, p3)),
        ("release", (1,)),
        ("reserve", (0, 24, p1)),  # evicts retained blocks when short
        ("release", (2,)),
        ("release", (0,)),
    ]
    for name, args in steps:
        rj = getattr(j, name)(*args)
        rt = getattr(t, name)(*args)
        assert rj == rt, (name, rj, rt)
        _same_state(j, t)
        assert j.can_reserve(16, p1) == t.can_reserve(16, p1)
        assert j.blocks_needed(14, p2) == t.blocks_needed(14, p2)
        assert j.prefix_hit_rate == t.prefix_hit_rate


def test_copy_on_write_copies_device_contents():
    j, t = _pair()
    prompt = np.arange(1, 10, dtype=np.int32)
    for kv in (j, t):
        kv.reserve(0, 12, prompt)
        kv.commit_prefix(0, prompt, 8)
        kv.reserve(1, 12, prompt)
    vals = np.random.default_rng(0).standard_normal(j.cache_k.shape).astype(np.float32)
    j.cache_k = j.cache_k.at[:].set(vals)
    t.cache_k.copy_(torch.from_numpy(vals))
    assert j.ensure_private(1, 0) == t.ensure_private(1, 0)
    np.testing.assert_array_equal(np.asarray(j.cache_k), t.cache_k.numpy())
    gk_j, _ = j.gather_dense(1, 9)
    gk_t, _ = t.gather_dense(1, 9)
    np.testing.assert_array_equal(np.asarray(gk_j), gk_t.numpy())
    _same_state(j, t)


def test_oom_and_bounds_match_jax():
    j, t = _pair(slots=2, num_blocks=4)
    assert j.fits_with_sharing(12) == t.fits_with_sharing(12)
    assert j.fits_with_sharing(13) == t.fits_with_sharing(13)
    for kv in (j, t):
        kv.reserve(0, 8)
    with pytest.raises(KVCacheOOM):
        t.reserve(1, 8)
    _same_state(j, t)  # a failed reserve takes nothing
    assert t.bytes_per_token == j.bytes_per_token
    t8 = PagedKVCache(L, H, D, slots=1, max_seq_len=8, kv_dtype="int8", device="cpu")
    j8 = JaxKV(L, H, D, slots=1, max_seq_len=8, kv_dtype="int8")
    assert t8.cache_k.dtype == torch.int8
    assert t8.bytes_per_token == j8.bytes_per_token == 2 * L * H * D + 2 * L * 4
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCache(L, H, D, slots=1, max_seq_len=8, kv_dtype="int4", device="cpu")


def test_bf16_pool_dtype():
    t = PagedKVCache(L, H, D, slots=1, max_seq_len=8, kv_dtype="bf16", device="cpu")
    assert t.cache_k.dtype == torch.bfloat16
    assert t.bytes_per_token == 2 * L * H * D * 2


@pytest.mark.parametrize("kw", [
    dict(n_requests=12, seed=3, rate_rps=40.0, prompt_len=(2, 30), max_new=(1, 9), vocab=97),
    dict(n_requests=9, seed=1, rate_rps=10.0, burst_factor=4.0),
    dict(n_requests=10, seed=2, tenants=3, shared_prefix=8, interactive_frac=0.34,
         session_turns=2),
])
def test_synthetic_requests_match_jax(kw):
    got = synthetic_requests(TrafficSpec(**kw))
    want = jax_requests(JaxSpec(**kw))
    assert TrafficSpec(**kw).identity == JaxSpec(**kw).identity
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.id, g.max_new_tokens, g.arrival_s, g.tenant, g.tier, g.session) == (
            w.id, w.max_new_tokens, w.arrival_s, w.tenant, w.tier, w.session)
        assert g.state is RequestState.QUEUED
