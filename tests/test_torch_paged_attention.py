"""The port's paged attention against the JAX Pallas kernel, on the CPU.

``flexflow_tpu_torch.ops.cuda.paged_attention.paged_attention`` on CPU
tensors runs its plain PyTorch version; the JAX side runs the Pallas
kernel in interpret mode.  Both get the same numpy inputs: scrambled
block tables, every page outside a lane's view (and the trash block)
poisoned with 1e4, and starts that straddle a page boundary.  The
tolerance is 1e-5 absolute in float32: the two sum in different orders
(online softmax page by page against one softmax over the gathered
row).  Also covered: the wrapper's device rules, the ``--serve-attn``
resolution, and the build helper's failure messages.
"""

from __future__ import annotations

import os
import stat
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.ops.pallas import paged_attention as jpa  # noqa: E402
from flexflow_tpu_torch.ops import cuda as tcuda  # noqa: E402
from flexflow_tpu_torch.ops.cuda import paged_attention as tpa  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _case(seed, B, G, H, D, BS, MB, pos=None):
    """Inputs as the serve programs give them, with poisoned pages.
    ``pos`` (B,) overrides the lanes' drawn positions."""
    rng = np.random.default_rng(seed)
    N = B * MB + 1  # + trash block 0
    q = rng.standard_normal((B, G, H, D)).astype(np.float32)
    pk = rng.standard_normal((N, H, BS, D)).astype(np.float32)
    pv = rng.standard_normal((N, H, BS, D)).astype(np.float32)
    bt = (rng.permutation(N - 1) + 1)[: B * MB].reshape(B, MB).astype(np.int32)
    # starts that straddle a page: row 0 sits mid-page and the G rows
    # run across at least one page boundary where the window allows
    hi = MB * BS - G
    drawn = np.array(
        [min(hi, BS * int(rng.integers(0, MB)) + BS // 2 + b) for b in range(B)],
        np.int32,
    )
    pos = np.maximum(drawn, 0) if pos is None else np.asarray(pos, np.int32)
    pk[0] = pv[0] = 1e4
    for b in range(B):
        last = (int(pos[b]) + G - 1) // BS
        for i in range(last + 1, MB):
            pk[bt[b, i]] = 1e4
            pv[bt[b, i]] = 1e4
    return q, pk, pv, pos, bt


@pytest.mark.parametrize("BS", [4, 8])
@pytest.mark.parametrize("G", [1, 3, 16])
def test_plain_matches_pallas_kernel(monkeypatch, G, BS):
    monkeypatch.setattr(jpa, "INTERPRET", True)
    B, H, D = 3, 2, 8
    MB = max(3, -(-(G + BS) // BS) + 1)
    q, pk, pv, pos, bt = _case(100 * G + BS, B, G, H, D, BS, MB)
    jax_fn = jpa.paged_decode_attention if G < 16 else jpa.paged_prefill_attention
    want = np.asarray(jax_fn(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pos), jnp.asarray(bt),
    ))
    torch_fn = tpa.paged_decode_attention if G < 16 else tpa.paged_prefill_attention
    got = torch_fn(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(pos), torch.from_numpy(bt),
    )
    assert got.dtype == torch.float32 and got.shape == (B, G, H, D)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_bf16_pool_matches_float32_on_rounded_values():
    """A bfloat16 pool is read as float32: the result equals the float32
    computation on the bf16-rounded pool, and comes back in q's dtype."""
    q, pk, pv, pos, bt = _case(7, 2, 3, 2, 8, 4, 4)
    qt, pkt, pvt = map(torch.from_numpy, (q, pk, pv))
    post, btt = torch.from_numpy(pos), torch.from_numpy(bt)
    got = tpa.paged_attention(qt, pkt.bfloat16(), pvt.bfloat16(), post, btt)
    want = tpa.paged_attention(qt, pkt.bfloat16().float(), pvt.bfloat16().float(), post, btt)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    got_bf = tpa.paged_attention(qt.bfloat16(), pkt.bfloat16(), pvt.bfloat16(), post, btt)
    assert got_bf.dtype == torch.bfloat16


# lane 0 at position 0 (its later segments hold nothing it sees), lane 1
# with rows that straddle a segment boundary, lane 2 near the table's end;
# 7 pages in segments of 2 or 3 (neither divides 7)
@pytest.mark.parametrize("G, pages", [(5, 2), (8, 3)])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_split_plain_matches_unsplit_and_pallas_kernel_over_float_pools(
        monkeypatch, pool, G, pages):
    """The row-group path's arithmetic (softmax over segments of pages,
    then merged), which the kernel runs over float32 and bfloat16 pools at
    G >= 2, against the unsplit plain version and the Pallas kernel."""
    monkeypatch.setattr(jpa, "INTERPRET", True)
    B, H, D, BS, MB = 3, 2, 16, 4, 7
    q, pk, pv, pos, bt = _case(G + pages, B, G, H, D, BS, MB,
                               pos=[0, pages * BS - 2, MB * BS - G])
    dtype = getattr(torch, pool)
    pk, pv = torch.from_numpy(pk).to(dtype), torch.from_numpy(pv).to(dtype)
    jdt = jnp.bfloat16 if pool == "bfloat16" else jnp.float32
    want = np.asarray(jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pk.float().numpy()).astype(jdt),
        jnp.asarray(pv.float().numpy()).astype(jdt), jnp.asarray(pos), jnp.asarray(bt),
    ))
    args = (torch.from_numpy(q), pk, pv, torch.from_numpy(pos), torch.from_numpy(bt))
    got = tpa.paged_attention_split_plain(*args, pages_per_split=pages)
    assert got.dtype == torch.float32 and got.shape == (B, G, H, D)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), tpa.paged_attention_plain(*args).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # one segment of all the pages is the unsplit softmax
    np.testing.assert_allclose(tpa.paged_attention_split_plain(*args, pages_per_split=MB),
                               tpa.paged_attention_plain(*args).numpy(), atol=1e-6, rtol=0)
    if pool == "bfloat16":  # a bfloat16 q over a bfloat16 pool
        bf = (args[0].bfloat16(),) + args[1:]
        got_bf = tpa.paged_attention_split_plain(*bf, pages_per_split=pages)
        assert got_bf.dtype == torch.bfloat16
        np.testing.assert_allclose(got_bf.float().numpy(),
                                   tpa.paged_attention_plain(*bf).float().numpy(),
                                   atol=1e-2, rtol=2.0 ** -7)


def test_cpu_tensors_take_plain_version_and_never_count():
    q, pk, pv, pos, bt = map(torch.from_numpy, _case(3, 2, 1, 2, 8, 4, 3))
    before = tpa.LAUNCHES
    out = tpa.paged_attention(q, pk, pv, pos, bt)
    assert tpa.LAUNCHES == before
    torch.testing.assert_close(out, tpa.paged_attention_plain(q, pk, pv, pos, bt))


def test_cpu_calls_leave_the_route_counts_alone():
    """On CPU tensors a call on any route's shapes (G 1 at D 64: the decode
    path; G 8 at D 64, BS 16: the row-group path; G 1 at D 32: the single
    pass) takes the plain version and counts nothing, by pool or by route."""
    before = (tpa.LAUNCHES, dict(tpa.LAUNCHES_BY_POOL), dict(tpa.LAUNCHES_BY_ROUTE))
    assert set(tpa.LAUNCHES_BY_ROUTE) == {"single", "split", "decode"}
    for G, D, path in ((1, 64, "decode"), (8, 64, "split"), (1, 32, "single")):
        q, pk, pv, pos, bt = map(torch.from_numpy, _case(G, 2, G, 2, D, 16, 3))
        assert (tpa.split_plan(G, D, 16, 3, pk.dtype) is None) == (G == 1)
        assert tpa.route(G, D, 16, 3, pk.dtype) == path
        out = tpa.paged_attention(q, pk, pv, pos, bt)
        torch.testing.assert_close(out, tpa.paged_attention_plain(q, pk, pv, pos, bt))
    assert (tpa.LAUNCHES, tpa.LAUNCHES_BY_POOL, tpa.LAUNCHES_BY_ROUTE) == before


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "float8_e4m3fn"])
def test_route_gives_one_row_the_decode_path(monkeypatch, pool):
    """One row per lane (decode) takes the decode path at D 64 and 128 over
    every pool format and any BS, in splits of 64 keys' worth of whole
    pages (csrc kDecodeKeys; one page at least); more rows or another head
    dim take another path, and ``DECODE_PATH`` off sends G 1 back to the
    single pass (or, with ``SPLIT_MIN_ROWS`` 1, to the row-group path)."""
    dtype = getattr(torch, pool)
    for D in (64, 128):
        for BS, MB, pages in ((16, 64, 4), (8, 10, 8), (48, 5, 1), (128, 3, 1), (4, 33, 16)):
            assert tpa.route(1, D, BS, MB, dtype) == "decode"
            assert tpa.decode_plan(1, D, BS, MB, dtype) == (-(-MB // pages), pages)
            assert tpa.split_plan(1, D, BS, MB, dtype) is None
    assert tpa.route(4, 64, 16, 64, dtype) == "split"
    assert tpa.decode_plan(4, 64, 16, 64, dtype) is None
    assert tpa.route(4, 128, 16, 64, dtype) == "single"
    for D in (32, 96, 256):
        assert tpa.decode_plan(1, D, 16, 64, dtype) is None
        assert tpa.route(1, D, 16, 64, dtype) == "single"
    monkeypatch.setattr(tpa, "DECODE_PATH", False)
    assert tpa.route(1, 64, 16, 64, dtype) == "single"
    monkeypatch.setattr(tpa, "SPLIT_MIN_ROWS", 1)
    assert tpa.route(1, 64, 16, 64, dtype) == "split"


# lane 0 at position 0 (only its first split holds anything it sees), lane
# 1 on the first key of its second split, lane 2 with its last page partly
# visible; the decode path's segments for BS 8 and 16 at D 64
@pytest.mark.parametrize("BS, MB", [(8, 20), (16, 10)])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_decode_split_plain_matches_unsplit_and_pallas_kernel_over_float_pools(
        monkeypatch, pool, BS, MB):
    """The decode path's arithmetic at G 1 (softmax over the segments of
    ``decode_plan``'s pages, then merged), which the kernel runs over
    float32 and bfloat16 pools, against the unsplit plain version and the
    Pallas kernel."""
    monkeypatch.setattr(jpa, "INTERPRET", True)
    B, H, D = 3, 2, 64
    dtype = getattr(torch, pool)
    splits, pages = tpa.decode_plan(1, D, BS, MB, dtype)
    assert splits >= 2
    q, pk, pv, pos, bt = _case(BS + MB, B, 1, H, D, BS, MB,
                               pos=[0, pages * BS, MB * BS - BS // 2])
    pk, pv = torch.from_numpy(pk).to(dtype), torch.from_numpy(pv).to(dtype)
    jdt = jnp.bfloat16 if pool == "bfloat16" else jnp.float32
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk.float().numpy()).astype(jdt),
        jnp.asarray(pv.float().numpy()).astype(jdt), jnp.asarray(pos), jnp.asarray(bt),
    ))
    args = (torch.from_numpy(q), pk, pv, torch.from_numpy(pos), torch.from_numpy(bt))
    got = tpa.paged_attention_split_plain(*args, pages_per_split=pages)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), tpa.paged_attention_plain(*args).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if pool == "bfloat16":  # a bfloat16 q over a bfloat16 pool
        bf = (args[0].bfloat16(),) + args[1:]
        got_bf = tpa.paged_attention_split_plain(*bf, pages_per_split=pages)
        assert got_bf.dtype == torch.bfloat16
        np.testing.assert_allclose(got_bf.float().numpy(),
                                   tpa.paged_attention_plain(*bf).float().numpy(),
                                   atol=1e-2, rtol=2.0 ** -7)


def test_non_cpu_non_cuda_tensors_raise():
    """Only CPU tensors reach the plain version; anything else launches the
    kernel or raises."""
    q, pk, pv, pos, bt = (t.to("meta") for t in map(torch.from_numpy, _case(3, 2, 1, 2, 8, 4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(q, pk, pv, pos, bt)


def test_resolve_serve_attn():
    cpu = torch.device("cpu")
    assert tpa.resolve_serve_attn("auto", cpu) == "gather"
    assert tpa.resolve_serve_attn("gather", cpu) == "gather"
    assert tpa.resolve_serve_attn("auto", torch.device("cuda", 0)) == "paged"
    with pytest.raises(ValueError, match="CUDA"):
        tpa.resolve_serve_attn("paged", cpu)
    with pytest.raises(ValueError, match="expected"):
        tpa.resolve_serve_attn("dense", cpu)


@pytest.mark.parametrize(
    "change, error, match",
    [
        (lambda a: {**a, "q": a["q"].to(torch.bfloat16)}, TypeError, "bfloat16 q over a float32"),
        (lambda a: {**a, "block_tables": a["block_tables"].long()}, TypeError, "int32"),
        (lambda a: {**a, "pool_v": a["pool_v"].to(torch.bfloat16)}, TypeError, "!="),
        (lambda a: {**a, "positions": a["positions"][:1]}, ValueError, "lane count"),
        (lambda a: {**a, "q": a["q"].transpose(0, 1).contiguous().transpose(0, 1)},
         ValueError, "contiguous"),
    ],
    ids=["bf16-q-f32-pool", "int64-tables", "mixed-pools", "lanes", "strided-q"],
)
def test_kernel_wrapper_checks_refuse_what_the_kernel_does_not_take(change, error, match):
    """The checks the wrapper makes before a launch on CUDA tensors."""
    names = ("q", "pool_k", "pool_v", "positions", "block_tables")
    args = dict(zip(names, map(torch.from_numpy, _case(3, 2, 2, 2, 8, 4, 3))))
    tpa._check(*args.values())  # the case itself is taken
    with pytest.raises(error, match=match):
        tpa._check(*change(args).values())
    big = {**args, "q": torch.zeros(2, 2, 2, 512), "pool_k": torch.zeros(7, 2, 4, 512),
           "pool_v": torch.zeros(7, 2, 4, 512)}
    with pytest.raises(ValueError, match="head_dim 512"):
        tpa._check(*big.values())


def test_build_reports_missing_nvcc(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run"):
        tcuda.build(["paged_attention"], build_dir=tmp_path, nvcc=str(tmp_path / "no-nvcc"))
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())


def test_build_raises_with_nvcc_stderr(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refuses' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        tcuda.build(["paged_attention"], build_dir=tmp_path / "out", nvcc=str(fake))
    assert list((tmp_path / "out").iterdir()) == []


def test_library_name_follows_source_hash(tmp_path):
    a = tcuda.library_path("paged_attention", tmp_path)
    assert a == tcuda.library_path("paged_attention", tmp_path)
    assert a.parent == tmp_path and a.name.startswith("libpaged_attention-")
    assert list(tcuda.sources()) == ["flash_attention", "paged_attention"]
