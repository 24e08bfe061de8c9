"""The port's quantized serving (int8/fp8 KV pools, weight-only int8)
against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions and the port's:

* ``quantize_kv`` must give the same ints / float8 bits and scales,
  exactly (all-zero rows, the +-448 fp8 boundary and the amax element
  included), and ``dequantize_kv`` the same floats;
* ``PagedKVCache`` must count ``bytes_per_token`` as JAX does, and
  copy-on-write must carry a block's scale rows with its page;
* the plain quantized paged attention must match the JAX Pallas kernel
  (interpret mode) within 1e-5 absolute (float32; the two sum in
  different orders);
* the engines' prefill and decode programs must give the same next
  tokens, probabilities within 1e-5, and the same pool bytes outside the
  trash block (whose content is whichever of several padded rows wrote
  last), scales within 1e-6 relative;
* greedy streams and the window schedule must equal the JAX gather
  engine's at int8, fp8 and int8 weights;
* ``quantize_weights_int8`` must give JAX's ints and scales exactly.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig, FFModel  # noqa: E402
from flexflow_tpu.models.gpt_decode import quantize_weights_int8 as jax_qweights  # noqa: E402
from flexflow_tpu.models.transformer import gpt_decoder  # noqa: E402
from flexflow_tpu.obs import read_metrics  # noqa: E402
from flexflow_tpu.ops.pallas import paged_attention as jpa  # noqa: E402
from flexflow_tpu.serve import ServeEngine as JaxEngine  # noqa: E402
from flexflow_tpu.serve import TrafficSpec as JaxSpec  # noqa: E402
from flexflow_tpu.serve import synthetic_requests as jax_requests  # noqa: E402
from flexflow_tpu.serve import kvcache as jkv  # noqa: E402
from flexflow_tpu_torch.models.gpt_decode import (  # noqa: E402
    dequantize_weights_int8,
    quantize_weights_int8,
)
from flexflow_tpu_torch.models.transformer import GPTDecoder, load_jax_params  # noqa: E402
from flexflow_tpu_torch.ops.cuda import paged_attention as tpa  # noqa: E402
from flexflow_tpu_torch.serve import ServeEngine, TrafficSpec, synthetic_requests  # noqa: E402
from flexflow_tpu_torch.serve import kvcache as tkv  # noqa: E402
from flexflow_tpu_torch.serve.driver import main as driver_main  # noqa: E402

SLOTS, SEQ, VOCAB = 4, 48, 31
SHAPE = dict(hidden=32, heads=4, ff_dim=64, num_layers=2, vocab=VOCAB)
TRAFFIC = dict(n_requests=6, seed=3, prompt_len=(4, 10), max_new=(3, 8), vocab=VOCAB)
ENGINE = dict(slots=SLOTS, block_size=8, prefill_chunk=8, sync_every=3)
KV_QUANT = ["int8", "fp8"]


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_model():
    cfg = FFConfig(batch_size=SLOTS, compute_dtype="float32")
    m = FFModel(cfg)
    gpt_decoder(m, SLOTS, SEQ, use_flash=False, **SHAPE)
    m.compile(seed=0)
    return m


@pytest.fixture(scope="module")
def port_model(jax_model):
    params = {
        layer: {leaf: np.asarray(v) for leaf, v in leaves.items()}
        for layer, leaves in jax_model.executor.params.items()
    }
    m = GPTDecoder(seq=SEQ, device="cpu", **SHAPE)
    load_jax_params(m, params)
    return m


def _bits(t) -> np.ndarray:
    """The stored bytes of an int8 or float8 array, torch or JAX."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


# ---------------------------------------------------------- quantize rules
@pytest.mark.parametrize("kv_dtype", KV_QUANT)
def test_quantize_kv_matches_jax_bit_for_bit(kv_dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((9, 4, 16)) * 3.0).astype(np.float32)
    x[2] = 0.0  # an all-zero position: scale 1.0, all zeros
    x[3, 1, 5] = 448.0  # amax exactly the fp8 maximum: scale 1.0, 448 kept
    x[4] = np.clip(x[4], -1, 1)
    x[4, 0, 0] = -448.0
    x[5, 2, 7] = 1e-30  # a tiny amax
    x[5] = np.where(np.arange(16) == 7, x[5], 0.0)
    x[6, 3, 3] = 7.0 * 448.0 / 447.0  # x / scale just above 448 before rounding
    qt, st = tkv.quantize_kv(torch.from_numpy(x), kv_dtype)
    qj, sj = jkv.quantize_kv(jnp, jnp.asarray(x), kv_dtype)
    assert qt.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv_dtype]
    assert st.dtype == torch.float32 and tuple(st.shape) == (9,)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    assert float(st[2]) == 1.0 and not _bits(qt)[2].any()
    assert np.all(np.isfinite(qt.float().numpy()))
    if kv_dtype == "fp8":
        assert float(qt[3, 1, 5].float()) == 448.0 and float(qt[4, 0, 0].float()) == -448.0
    else:
        assert int(qt.abs().max()) <= 127
    # the read-side rule: positions on the second-to-last axis
    back_t = tkv.dequantize_kv(qt.permute(1, 0, 2), st)
    back_j = jkv.dequantize_kv(jnp, jnp.transpose(qj, (1, 0, 2)), sj)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
    assert not back_t[:, 2].any()


@pytest.mark.parametrize("kv_dtype", KV_QUANT)
def test_pool_formats_and_bytes_match_jax(kv_dtype):
    kw = dict(slots=2, block_size=8, max_seq_len=48, kv_dtype=kv_dtype)
    t = tkv.PagedKVCache(2, 4, 16, device="cpu", **kw)
    j = jkv.PagedKVCache(2, 4, 16, **kw)
    assert t.quantized and t.qmax == j.qmax
    assert t.cache_k.dtype == tkv.kv_pool_dtype(kv_dtype)
    assert str(t.cache_k.dtype).replace("torch.", "") == str(j.cache_k.dtype)
    assert tuple(t.scale_k.shape) == tuple(j.scale_k.shape) == (2, t.num_blocks, 8)
    assert t.scale_k.dtype == torch.float32 and not t.scale_k.any()
    # 2 pools x L x H x D x 1 byte + 2 scale streams x L x 4 bytes
    assert t.bytes_per_token == j.bytes_per_token == 2 * 2 * 4 * 16 + 2 * 2 * 4
    assert tkv.PagedKVCache(2, 4, 16, device="cpu", slots=2, block_size=8,
                            max_seq_len=48).scale_k is None
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.PagedKVCache(2, 4, 16, device="cpu", **{**kw, "kv_dtype": "int4"})


@pytest.mark.parametrize("kv_dtype", KV_QUANT)
def test_copy_on_write_carries_scale_rows(kv_dtype):
    """A shared block made private is copied with its scale rows, as JAX
    does; the dequantized view of the slot is unchanged by the copy."""
    L, H, D, BS = 2, 2, 16, 4
    kw = dict(slots=2, block_size=BS, num_blocks=8, max_seq_len=16, kv_dtype=kv_dtype)
    j = jkv.PagedKVCache(L, H, D, **kw)
    t = tkv.PagedKVCache(L, H, D, device="cpu", **kw)
    prompt = np.arange(9)
    for kv in (j, t):
        kv.reserve(0, 9, prompt)
        kv.commit_prefix(0, prompt, 9)
        kv.reserve(1, 9, prompt)  # re-attaches slot 0's two full blocks
    rng = np.random.default_rng(1)
    x = rng.standard_normal((L, 8, BS, H, D)).astype(np.float32)
    qt, st = tkv.quantize_kv(torch.from_numpy(x), kv_dtype)
    qt = qt.permute(0, 1, 3, 2, 4).contiguous()  # (L, N, H, BS, D)
    tkv.pool_bits(t.cache_k).copy_(tkv.pool_bits(qt))
    t.scale_k.copy_(st)
    j.cache_k = jnp.asarray(_bits(qt)).view(j.cache_k.dtype)
    j.scale_k = jnp.asarray(st.numpy())
    before = t.gather_dense_dequant(1, 9)[0]
    assert j.ensure_private(1, 0) == t.ensure_private(1, 0)
    np.testing.assert_array_equal(_bits(t.cache_k), _bits(j.cache_k))
    np.testing.assert_array_equal(t.scale_k.numpy(), np.asarray(j.scale_k))
    np.testing.assert_array_equal(t.scale_v.numpy(), np.asarray(j.scale_v))
    got = t.gather_dense_dequant(1, 9)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.gather_dense_dequant(1, 9)[0]))
    torch.testing.assert_close(got, before, atol=0, rtol=0)
    sk_t, _ = t.gather_scales(1, 9)
    np.testing.assert_array_equal(sk_t.numpy(), j.gather_scales(1, 9)[0])
    t.check_invariants()


# -------------------------------------------------- quantized paged attention
def _quant_case(seed, kv_dtype, B, G, H, D, BS, MB, pos=None):
    """Quantized pools as the serve programs write them, with the pages
    past each lane's last visible page poisoned (ints at the format's
    maximum, scale rows 1e4) and the trash block poisoned with zero
    scales.  ``pos`` (B,) overrides the lanes' drawn positions."""
    rng = np.random.default_rng(seed)
    N = B * MB + 1
    q = rng.standard_normal((B, G, H, D)).astype(np.float32)
    pools = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((N, BS, H, D)).astype(np.float32))
        qx, sc = tkv.quantize_kv(x, kv_dtype)
        pools.append([qx.permute(0, 2, 1, 3).contiguous(), sc.contiguous()])
    bt = (rng.permutation(N - 1) + 1)[: B * MB].reshape(B, MB).astype(np.int32)
    hi = MB * BS - G
    drawn = np.maximum(np.array(
        [min(hi, BS * int(rng.integers(0, MB)) + BS // 2 + b) for b in range(B)], np.int32), 0)
    pos = drawn if pos is None else np.asarray(pos, np.int32)
    top = torch.full((H, BS, D), tkv.kv_qmax(kv_dtype)).to(pools[0][0].dtype)
    for pool, sc in pools:
        tkv.pool_bits(pool)[0] = tkv.pool_bits(top)
        sc[0] = 0.0
        for b in range(B):
            for i in range((int(pos[b]) + G - 1) // BS + 1, MB):
                tkv.pool_bits(pool)[bt[b, i]] = tkv.pool_bits(top)
                sc[bt[b, i]] = 1e4
    (pk, sk), (pv, sv) = pools
    return q, pk, pv, sk, sv, pos, bt


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("kv_dtype", KV_QUANT)
def test_plain_quantized_matches_pallas_kernel(monkeypatch, kv_dtype, G):
    monkeypatch.setattr(jpa, "INTERPRET", True)
    B, H, D, BS = 3, 2, 16, 4
    MB = max(3, -(-(G + BS) // BS) + 1)
    q, pk, pv, sk, sv, pos, bt = _quant_case(10 * G, kv_dtype, B, G, H, D, BS, MB)
    jdt = jnp.int8 if kv_dtype == "int8" else jnp.float8_e4m3fn
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(_bits(pk)).view(jdt), jnp.asarray(_bits(pv)).view(jdt),
        jnp.asarray(pos), jnp.asarray(bt),
        scale_k=jnp.asarray(sk.numpy()), scale_v=jnp.asarray(sv.numpy()),
    ))
    fn = tpa.paged_decode_attention if G < 8 else tpa.paged_prefill_attention
    before = tpa.LAUNCHES
    got = fn(torch.from_numpy(q), pk, pv, torch.from_numpy(pos), torch.from_numpy(bt),
             scale_k=sk, scale_v=sv)
    assert tpa.LAUNCHES == before  # CPU tensors: the plain version, not counted
    assert got.dtype == torch.float32 and got.shape == (B, G, H, D)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # a bfloat16 q reads the same pools and comes back in bfloat16
    got_bf = tpa.paged_attention(torch.from_numpy(q).bfloat16(), pk, pv,
                                 torch.from_numpy(pos), torch.from_numpy(bt), None, sk, sv)
    assert got_bf.dtype == torch.bfloat16


# lane 0 at position 0 (its later segments hold nothing it sees), lane 1
# with rows that straddle a segment boundary, lane 2 near the table's end;
# 7 pages in segments of 2 or 3 (neither divides 7)
@pytest.mark.parametrize("G, pages", [(5, 2), (8, 3)])
@pytest.mark.parametrize("kv_dtype", KV_QUANT)
def test_split_plain_matches_unsplit_and_pallas_kernel(monkeypatch, kv_dtype, G, pages):
    monkeypatch.setattr(jpa, "INTERPRET", True)
    B, H, D, BS, MB = 3, 2, 16, 4, 7
    pos = [0, pages * BS - 2, MB * BS - G]
    q, pk, pv, sk, sv, pos, bt = _quant_case(G + pages, kv_dtype, B, G, H, D, BS, MB, pos)
    jdt = jnp.int8 if kv_dtype == "int8" else jnp.float8_e4m3fn
    want = np.asarray(jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(_bits(pk)).view(jdt), jnp.asarray(_bits(pv)).view(jdt),
        jnp.asarray(pos), jnp.asarray(bt),
        scale_k=jnp.asarray(sk.numpy()), scale_v=jnp.asarray(sv.numpy()),
    ))
    args = (torch.from_numpy(q), pk, pv, torch.from_numpy(pos), torch.from_numpy(bt), None,
            sk, sv)
    got = tpa.paged_attention_split_plain(*args, pages_per_split=pages)
    assert got.dtype == torch.float32 and got.shape == (B, G, H, D)
    np.testing.assert_allclose(got.numpy(), tpa.paged_attention_plain(*args).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # one segment of all the pages is the unsplit softmax
    np.testing.assert_allclose(tpa.paged_attention_split_plain(*args, pages_per_split=MB),
                               tpa.paged_attention_plain(*args).numpy(), atol=1e-6, rtol=0)
    bf = (args[0].bfloat16(),) + args[1:]
    got_bf = tpa.paged_attention_split_plain(*bf, pages_per_split=pages)
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf.float().numpy(),
                               tpa.paged_attention_plain(*bf).float().numpy(),
                               atol=1e-2, rtol=2.0 ** -7)


# lane 0 at position 0, lane 1 on the first key of its second split, lane
# 2 with its last page partly visible; the decode path's segments for BS 8
# and 16 at D 64
@pytest.mark.parametrize("BS, MB", [(8, 20), (16, 10)])
@pytest.mark.parametrize("kv_dtype", KV_QUANT)
def test_decode_split_plain_matches_unsplit_and_pallas_kernel(monkeypatch, kv_dtype, BS, MB):
    """The decode path's arithmetic at G 1 over int8 and float8 pools (the
    segments of ``decode_plan``'s pages, merged) against the unsplit plain
    version and the Pallas kernel with ``quantized=True``."""
    monkeypatch.setattr(jpa, "INTERPRET", True)
    B, H, D = 3, 2, 64
    dtype = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
    splits, pages = tpa.decode_plan(1, D, BS, MB, dtype)
    assert splits >= 2 and tpa.route(1, D, BS, MB, dtype) == "decode"
    pos = [0, pages * BS, MB * BS - BS // 2]
    q, pk, pv, sk, sv, pos, bt = _quant_case(BS + MB, kv_dtype, B, 1, H, D, BS, MB, pos)
    jdt = jnp.int8 if kv_dtype == "int8" else jnp.float8_e4m3fn
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(_bits(pk)).view(jdt), jnp.asarray(_bits(pv)).view(jdt),
        jnp.asarray(pos), jnp.asarray(bt),
        scale_k=jnp.asarray(sk.numpy()), scale_v=jnp.asarray(sv.numpy()),
    ))
    args = (torch.from_numpy(q), pk, pv, torch.from_numpy(pos), torch.from_numpy(bt), None,
            sk, sv)
    got = tpa.paged_attention_split_plain(*args, pages_per_split=pages)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), tpa.paged_attention_plain(*args).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    bf = (args[0].bfloat16(),) + args[1:]
    got_bf = tpa.paged_attention_split_plain(*bf, pages_per_split=pages)
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf.float().numpy(),
                               tpa.paged_attention_plain(*bf).float().numpy(),
                               atol=1e-2, rtol=2.0 ** -7)


def test_split_plan_takes_quantized_row_groups_only():
    """Which calls the kernel's row-group path takes, and its segments:
    every pool format (quantized, float32 and bfloat16 alike) at G >= 2,
    D 64 and a BS dividing 64; any other call takes the single pass."""
    i8, f8 = torch.int8, torch.float8_e4m3fn
    rows, tiles, keys = tpa.SPLIT_MIN_ROWS, 2, 64  # csrc: kSplitTiles, kTileKeys
    pages = tiles * keys // 16
    assert tpa.split_plan(rows, 64, 16, 64, i8) == (-(-64 // pages), pages)
    assert tpa.split_plan(32, 64, 16, 5, f8) == (1, pages)
    assert tpa.split_plan(32, 128, 16, 64, i8) is None
    assert tpa.split_plan(32, 64, 4, 100, i8) == (-(-100 // (tiles * keys // 4)),
                                                  tiles * keys // 4)
    assert tpa.split_plan(rows - 1, 64, 16, 64, i8) is None
    assert tpa.split_plan(32, 64, 16, 64, torch.float32) == (-(-64 // pages), pages)
    assert tpa.split_plan(32, 64, 16, 64, torch.bfloat16) == (-(-64 // pages), pages)
    assert tpa.split_plan(32, 128, 16, 64, torch.float32) is None
    assert tpa.split_plan(32, 64, 48, 64, torch.bfloat16) is None
    assert tpa.split_plan(32, 16, 16, 64, i8) is None
    assert tpa.split_plan(32, 64, 48, 64, i8) is None


def test_scale_rows_go_with_quantized_pools_only():
    """The wrapper raises, on the CPU as well, rather than read a quantized
    pool without its scales or scale a full-precision one."""
    q, pk, pv, sk, sv, pos, bt = _quant_case(0, "int8", 2, 1, 2, 16, 4, 3)
    q, pos, bt = map(torch.from_numpy, (q, pos, bt))
    with pytest.raises(ValueError, match="both"):
        tpa.paged_attention(q, pk, pv, pos, bt, None, sk, None)
    with pytest.raises(ValueError, match="needs its scale"):
        tpa.paged_attention(q, pk, pv, pos, bt)
    with pytest.raises(ValueError, match="needs its scale"):
        tpa.paged_attention_plain(q, pk, pv, pos, bt)
    with pytest.raises(ValueError, match="int8 or float8"):
        tpa.paged_attention(q, pk.float(), pv.float(), pos, bt, None, sk, sv)


@pytest.mark.parametrize(
    "change, error, match",
    [
        (lambda a: {**a, "scale_k": a["scale_k"].double()}, ValueError, "float32 of shape"),
        (lambda a: {**a, "scale_v": a["scale_v"][:, :2].contiguous()}, ValueError, "shape"),
        (lambda a: {**a, "scale_k": a["scale_k"].t().contiguous().t()}, ValueError, "contiguous"),
        (lambda a: {**a, "pool_v": a["pool_v"].view(torch.float8_e4m3fn)}, TypeError, "!="),
        (lambda a: {k: (v[..., :8].contiguous() if k in ("q", "pool_k", "pool_v") else v)
                    for k, v in a.items()}, ValueError, "multiple of 16"),
    ],
    ids=["f64-scales", "short-scales", "strided-scales", "mixed-pools", "head-dim-8"],
)
def test_kernel_checks_for_quantized_pools(change, error, match):
    """What the wrapper checks before launching the quantized kernel."""
    names = ("q", "pool_k", "pool_v", "scale_k", "scale_v", "positions", "block_tables")
    q, pk, pv, sk, sv, pos, bt = _quant_case(2, "int8", 2, 4, 2, 16, 4, 3)
    args = dict(zip(names, (torch.from_numpy(q), pk, pv, sk, sv,
                            torch.from_numpy(pos), torch.from_numpy(bt))))

    def check(a):
        tpa._check(a["q"], a["pool_k"], a["pool_v"], a["positions"], a["block_tables"],
                   a["scale_k"], a["scale_v"])

    check(args)  # the case itself is taken, with a float32 and a bfloat16 q
    check({**args, "q": args["q"].bfloat16()})
    check({**args, "pool_k": pk.view(torch.float8_e4m3fn), "pool_v": pv.view(torch.float8_e4m3fn)})
    with pytest.raises(error, match=match):
        check(change(args))


# ------------------------------------------------------------ serve programs
def _programs_agree(jeng, teng):
    """Both engines' prefill (two lanes, one straddling a page) then one
    decode step on identical inputs: next tokens equal, probabilities
    within 1e-5, pool bytes equal outside the trash block, scales within
    1e-6 relative there."""
    MB = teng.kv.max_blocks_per_seq
    P = ENGINE["prefill_chunk"]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, VOCAB, size=(SLOTS, P)).astype(np.int32)
    start = np.array([0, 5, 0, 0], np.int32)
    n_valid = np.array([8, 6, 0, 0], np.int32)
    bt = np.zeros((SLOTS, MB), np.int32)
    bt[0, :2] = [3, 1]
    bt[1, :2] = [2, 4]
    res = jeng._prefill(jeng._params_arg, *jeng._kvs(),
                        *map(jnp.asarray, (toks, start, n_valid, bt)))
    jeng._store_kvs(res[2:])
    t_nxt, t_probs = teng._prefill(*map(torch.from_numpy, (toks, start, n_valid, bt)))
    np.testing.assert_allclose(t_probs.numpy()[:2], np.asarray(res[1])[:2], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_nxt.numpy()[:2], np.asarray(res[0])[:2])
    cur = np.asarray(res[0]).astype(np.int32)
    pos = np.array([8, 11, 0, 0], np.int32)
    res = jeng._decode(jeng._params_arg, *jeng._kvs(), *map(jnp.asarray, (cur, pos, bt)))
    t_nxt, t_probs = teng._decode(*map(torch.from_numpy, (cur, pos, bt)))
    np.testing.assert_allclose(t_probs.numpy()[:2], np.asarray(res[1])[:2], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_nxt.numpy()[:2], np.asarray(res[0])[:2])
    kv = teng.kv
    for name, j_pool in (("cache_k", res[2]), ("cache_v", res[3])):
        np.testing.assert_array_equal(_bits(getattr(kv, name))[:, 1:], _bits(j_pool)[:, 1:])
    for name, j_sc in (("scale_k", res[4]), ("scale_v", res[5])):
        np.testing.assert_allclose(getattr(kv, name).numpy()[:, 1:], np.asarray(j_sc)[:, 1:],
                                   rtol=1e-6, atol=0)
    written = (kv.scale_k[:, 1:] != 0).sum()
    assert int(written) == 2 * (8 + 6 + 2)  # both layers: 14 prefill rows, 2 decode rows


@pytest.mark.parametrize("kv_dtype", KV_QUANT)
def test_programs_match_jax(jax_model, port_model, kv_dtype):
    _programs_agree(
        JaxEngine(jax_model, attn="gather", kv_dtype=kv_dtype, **ENGINE),
        ServeEngine(port_model, device="cpu", kv_dtype=kv_dtype, **ENGINE),
    )


def _copying_engine(jeng):
    """Give the JAX engine the copying ``jnp`` of tests/test_torch_serve.py
    (its window loop otherwise races with its host position buffer)."""
    from test_torch_serve import _CopyingJnp

    jeng._jnp = _CopyingJnp()
    return jeng


def _streams(reqs):
    return {r.id: [int(t) for t in r.tokens] for r in reqs}


@pytest.mark.parametrize("arm", [
    dict(kv_dtype="int8"), dict(kv_dtype="fp8"), dict(kv_dtype="int8", weight_dtype="int8"),
], ids=["int8", "fp8", "int8-weights"])
def test_greedy_streams_match_jax_engine(jax_model, port_model, arm):
    jeng = _copying_engine(JaxEngine(jax_model, attn="gather", **arm, **ENGINE))
    jreqs = jax_requests(JaxSpec(**TRAFFIC))
    jrep = jeng.run(jreqs)
    teng = ServeEngine(port_model, device="cpu", **arm, **ENGINE)
    treqs = synthetic_requests(TrafficSpec(**TRAFFIC))
    trep = teng.run(treqs)
    assert trep.requests_finished == jrep.requests_finished == TRAFFIC["n_requests"]
    assert all(len(r.tokens) == r.max_new_tokens for r in treqs)
    assert _streams(treqs) == _streams(jreqs)
    assert (trep.windows, trep.decode_steps, trep.prefill_chunks, trep.prefill_dispatches) == (
        jrep.windows, jrep.decode_steps, jrep.prefill_chunks, jrep.prefill_dispatches)
    assert trep.host_syncs == trep.windows
    teng.kv.check_invariants()


# ------------------------------------------------------- weight-only int8
def test_quantize_weights_int8_matches_jax(jax_model, port_model):
    jq, js = jax_qweights(jnp, jax_model.executor.params)
    tq, ts = quantize_weights_int8(port_model.param_tree())
    assert set(tq) == set(jq)
    for layer in jq:
        assert set(tq[layer]) == set(jq[layer])
        for leaf in jq[layer]:
            want_q, want_s = np.asarray(jq[layer][leaf]), np.asarray(js[layer][leaf])
            got_q, got_s = tq[layer][leaf], ts[layer][leaf]
            assert str(got_q.dtype).replace("torch.", "") == str(want_q.dtype)
            np.testing.assert_array_equal(got_q.numpy(), want_q)
            np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert tq["lm_head"]["kernel"].dtype == torch.int8
    assert tq["dec0_ln0"]["scale"].dtype == torch.float32  # 1-D leaves pass through
    deq = dequantize_weights_int8(tq, ts)
    w = port_model.param_tree()["dec1_ff0"]["kernel"]
    # one int step of the channel's scale, at most half of it after rounding
    assert float((deq["dec1_ff0"]["kernel"] - w).abs().max()) <= float(ts["dec1_ff0"]["kernel"].max()) / 2


def test_engine_validates_weight_and_kv_dtypes(port_model):
    with pytest.raises(ValueError, match="weight_dtype 'int4': expected fp32 | int8"):
        ServeEngine(port_model, device="cpu", weight_dtype="int4", **ENGINE)
    with pytest.raises(ValueError, match="kv_dtype 'int4': expected one of"):
        ServeEngine(port_model, device="cpu", kv_dtype="int4", **ENGINE)


# ------------------------------------------------------ records and driver
def test_window_records_carry_quantized_fields(port_model, tmp_path):
    path = str(tmp_path / "serve.jsonl")
    eng = ServeEngine(port_model, device="cpu", kv_dtype="fp8", weight_dtype="int8",
                      metrics_out=path, **ENGINE)
    rep = eng.run(synthetic_requests(TrafficSpec(**TRAFFIC)))
    recs = read_metrics(path)
    assert len(recs) == rep.windows
    serve = [r["metrics"]["serve"] for r in recs]
    assert {s["kv_dtype"] for s in serve} == {"fp8"}
    assert {s["weight_dtype"] for s in serve} == {"int8"}
    assert {s["kv_bytes_per_token"] for s in serve} == {eng.kv.bytes_per_token}
    assert all("spec" not in s for s in serve)


def test_driver_quantized_flags(tmp_path, capsys):
    rc = driver_main([
        "--device", "cpu", "--requests", "3", "--hidden", "32", "--heads", "2",
        "--ff-dim", "32", "--vocab", "40", "--seq", "32", "--max-new", "2:5",
        "--serve-block-size", "8", "--serve-kv-dtype", "fp8", "--serve-weight-dtype", "int8",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["kv_dtype"] == "fp8" and out["weight_dtype"] == "int8"
    assert out["kv_bytes_per_token"] == 2 * 2 * 32 + 2 * 2 * 4
    assert out["requests_finished"] == 3 and out["host_syncs"] == out["windows"]
    with pytest.raises(SystemExit):
        driver_main(["--device", "cpu", "--serve-kv-dtype", "int4"])
