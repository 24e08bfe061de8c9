"""The port's flash attention against the JAX Pallas kernels, on the CPU.

``flexflow_tpu_torch.ops.cuda.flash_attention.flash_attention`` on CPU
tensors runs the plain PyTorch versions of the three CUDA kernels
through the ``FlashAttention`` autograd function; the JAX side runs
``flash_attention`` with its Pallas kernels in interpret mode, and
``jax.grad`` through its custom VJP.  Both get the same numpy inputs and
the same upstream gradient.  The cases mirror
``tests/test_flash_attention.py``: head dims 64 and 128, causal and not,
Sq != Sk (end-aligned diagonal), rows with no visible key, bfloat16,
hash dropout with a fixed seed, and the JAX tiled kernels (one-pass
threshold forced to 0, 128-row blocks).

Tolerances, relative to max |JAX value|: float32 2e-5 for the output and
lse, 1e-4 for the gradients (the two sum in different orders); bfloat16
2e-2 (both round float32 results to bfloat16, at different places).
The dropout hash must equal the JAX ``_uniform01`` bit for bit.  The
CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` and ``tools/torch_flash_probe.py``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import flexflow_tpu.ops.pallas.flash_attention as jfa  # noqa: E402
from flexflow_tpu_torch.ops import attention as tattn  # noqa: E402
from flexflow_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, g


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


CASES = {
    # name: (b, h, sq, sk, d, causal, dropout, seed, dtype, jax tiled)
    "d64": (1, 2, 256, 256, 64, False, 0.0, 0, "float32", False),
    "d64_causal": (1, 2, 256, 256, 64, True, 0.0, 0, "float32", False),
    "d128": (1, 2, 256, 256, 128, False, 0.0, 0, "float32", False),
    "d128_causal": (1, 2, 256, 256, 128, True, 0.0, 0, "float32", False),
    "cross_lengths_causal": (2, 2, 128, 256, 64, True, 0.0, 0, "float32", False),
    "no_visible_key_rows": (1, 1, 384, 256, 64, True, 0.0, 0, "float32", False),
    "bf16": (1, 2, 256, 256, 64, False, 0.0, 0, "bfloat16", False),
    "bf16_causal_d128": (1, 2, 256, 256, 128, True, 0.0, 0, "bfloat16", False),
    # the bfloat16 backward's masked paths: diagonal tiles off the main
    # diagonal, rows that see no key, dropout under the causal mask
    "bf16_cross_lengths_causal": (2, 2, 128, 256, 64, True, 0.0, 0, "bfloat16", False),
    "bf16_no_visible_key_rows": (1, 1, 384, 256, 64, True, 0.0, 0, "bfloat16", False),
    "bf16_dropout_causal_d128": (1, 2, 256, 256, 128, True, 0.1, -7, "bfloat16", False),
    "dropout": (1, 2, 128, 128, 64, False, 0.3, 1234, "float32", False),
    "dropout_causal_negative_seed": (1, 2, 256, 256, 128, True, 0.1, -7, "float32", False),
    "tiled": (1, 2, 256, 256, 64, False, 0.0, 0, "float32", True),
    "tiled_no_visible_key_rows": (1, 1, 384, 256, 64, True, 0.0, 0, "float32", True),
    "tiled_dropout_causal": (1, 2, 256, 256, 64, True, 0.2, 99, "float32", True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_grads_match_jax(name, monkeypatch):
    b, h, sq, sk, d, causal, rate, seed, dtype, tiled = CASES[name]
    q, k, v, g = _inputs(b, h, sq, sk, d, seed=len(name))
    blocks = {}
    if tiled:
        monkeypatch.setattr(jfa, "ONEPASS_MAX_SK", 0)
        monkeypatch.setattr(jfa, "ONEPASS_MAX_SK_CAUSAL", 0)
        blocks = dict(block_q=128, block_k=128)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))

    def jloss(a, b_, c):
        o = jfa.flash_attention(a, b_, c, causal=causal, dropout_rate=rate, seed=seed,
                                **blocks)
        return jnp.sum(o.astype(jnp.float32) * g)

    j_out = jfa.flash_attention(jq, jk, jv, causal=causal, dropout_rate=rate, seed=seed,
                                **blocks)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    launches = dict(tfa.LAUNCHES)
    t_out = tfa.flash_attention(tq, tk, tv, causal, rate, seed, **blocks)
    (t_out.float() * torch.from_numpy(g)).sum().backward()
    assert tfa.LAUNCHES == launches  # the CPU runs the plain versions
    assert t_out.dtype == td

    fwd_tol, bwd_tol = (2e-2, 2e-2) if dtype == "bfloat16" else (2e-5, 1e-4)
    assert _rel(t_out.detach().float(), j_out) <= fwd_tol
    for jg, tg in zip(j_grads, (tq.grad, tk.grad, tv.grad)):
        assert tg.dtype == td
        assert _rel(tg.float(), jg) <= bwd_tol
    if causal and sq > sk:  # rows that see no key output exactly 0
        assert (t_out.detach()[:, :, : sq - sk] == 0).all()
        assert np.all(np.asarray(j_out)[:, :, : sq - sk] == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax_forward(causal):
    """The saved lse (B * H, Sq) equals the JAX forward's, masked rows
    included (about -1e30 there: the backward depends on that value)."""
    q, k, v, _ = _inputs(2, 2, 384, 256, 64, seed=5)
    j_out, j_lse = jfa._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), 0, causal, 0.0,
                                  128, 256)
    t_out, t_lse = tfa.flash_attention_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal)
    assert t_lse.shape == (4, 384) and t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=2e-6, atol=2e-5)
    assert _rel(t_out, j_out) <= 2e-5


def test_dropout_hash_bit_exact_against_jax():
    rng = np.random.default_rng(0)
    n = 4096
    q_pos = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    k_pos = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    q_pos[:8] = [0, 1, 127, 128, 2**31 - 1, 511, 512, 2047]
    for seed, bh in ((0, 0), (1234, 5), (-7, 191), (2**31 - 1, 65535)):
        want = np.asarray(jfa._uniform01(jnp.asarray(seed, jnp.int32).astype(jnp.uint32),
                                         jnp.uint32(bh), jnp.asarray(q_pos),
                                         jnp.asarray(k_pos)))
        got = tfa.uniform01(seed, bh, torch.from_numpy(q_pos.astype(np.int64)),
                            torch.from_numpy(k_pos.astype(np.int64)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_mask_shows_the_same_zeros_as_jax():
    """With V the identity the output is the dropped, normalised
    probabilities: its zeros are the dropout mask, and must be the JAX
    kernel's zeros exactly."""
    b, h, sq, sk = 1, 2, 256, 128
    q, k, _, _ = _inputs(b, h, sq, sk, 128, seed=3)
    v = np.broadcast_to(np.eye(sk, dtype=np.float32), (b, h, sk, sk)).copy()
    j_out = np.asarray(jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                           dropout_rate=0.25, seed=42))
    t_out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                dropout_rate=0.25, seed=42).numpy()
    np.testing.assert_array_equal(t_out == 0, j_out == 0)
    assert 0.2 < (t_out == 0).mean() < 0.3
    np.testing.assert_allclose(t_out, j_out, rtol=2e-5, atol=2e-6)


def test_dropout_is_deterministic_per_seed():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 128, 128, 64, seed=1))
    o1 = tfa.flash_attention(q, k, v, dropout_rate=0.5, seed=7)
    o2 = tfa.flash_attention(q, k, v, dropout_rate=0.5, seed=7)
    o3 = tfa.flash_attention(q, k, v, dropout_rate=0.5, seed=8)
    assert torch.equal(o1, o2)
    assert (o1 - o3).abs().max() > 1e-3


def _refused(**over):
    shapes = dict(q=(1, 2, 128, 64), k=(1, 2, 128, 64), v=(1, 2, 128, 64))
    dtypes = dict(q=torch.float32, k=torch.float32, v=torch.float32)
    kw = {}
    for key, val in over.items():
        if key in shapes:
            shapes[key] = val
        elif key.endswith("_dtype"):
            dtypes[key[0]] = val
        else:
            kw[key] = val
    q, k, v = (torch.zeros(shapes[n], dtype=dtypes[n]) for n in "qkv")
    return q, k, v, kw


@pytest.mark.parametrize("over,err", [
    (dict(q=(1, 2, 128, 32), k=(1, 2, 128, 32), v=(1, 2, 128, 32)), "head dim 32"),
    (dict(q=(1, 2, 128, 96), k=(1, 2, 128, 96), v=(1, 2, 128, 96)), "head dim 96"),
    (dict(q=(1, 2, 192, 64)), "Sq = 192"),
    (dict(k=(1, 2, 64, 64), v=(1, 2, 64, 64)), "Sk = 64"),
    (dict(q=(2, 128, 64), k=(2, 128, 64), v=(2, 128, 64)), "shape"),
    (dict(v=(1, 2, 256, 64)), "do not match"),
    (dict(q_dtype=torch.float16, k_dtype=torch.float16, v_dtype=torch.float16), "float16"),
    (dict(k_dtype=torch.bfloat16), "one dtype"),
    (dict(block_q=96), "not divisible by block 96"),
    (dict(block_k=256), "not divisible by block 256"),
    (dict(dropout_rate=1.0), "dropout_rate"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(over, err):
    q, k, v, kw = _refused(**over)
    with pytest.raises((ValueError, TypeError), match=err):
        tfa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("sq,sk,d,dtype,use_flash,want", [
    (128, 128, 64, torch.float32, True, "flash"),
    (256, 128, 128, torch.bfloat16, True, "flash"),
    (64, 64, 64, torch.float32, True, "sdpa"),  # sequence below the 128 tile
    (128, 128, 32, torch.float32, True, "sdpa"),  # head dim outside the kernel's set
    (128, 128, 64, torch.float32, False, "sdpa"),
])
def test_attention_op_takes_the_kernel_whenever_its_contract_holds(
        sq, sk, d, dtype, use_flash, want, monkeypatch):
    """The port drops the JAX op's TPU memory threshold: use_flash=True
    takes the flash kernels whenever their contract holds."""
    taken = []
    real_flash, real_sdpa = tattn.flash_attention, tattn.sdpa
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: taken.append("flash") or real_flash(*a, **k))
    monkeypatch.setattr(tattn, "sdpa", lambda *a, **k: taken.append("sdpa") or real_sdpa(*a, **k))
    from flexflow_tpu_torch.fftype import DataType, OperatorType
    from flexflow_tpu_torch.ops.base import OpContext
    from flexflow_tpu_torch.tensor import Layer, Tensor

    h = 2
    dt = {torch.float32: DataType.FLOAT, torch.bfloat16: DataType.BFLOAT16}[dtype]
    xq, xk = Tensor((1, sq, h * d), dt), Tensor((1, sk, h * d), dt)
    layer = Layer(OperatorType.MULTIHEAD_ATTENTION, "attn", [xq, xk, xk],
                  dict(embed_dim=h * d, num_heads=h, use_flash=use_flash))
    gen = torch.Generator().manual_seed(0)
    params = {w.name: w.initializer(gen, w.shape, dtype)
              for w in tattn.MultiHeadAttention().weights(layer)}
    xq_t = torch.randn(1, sq, h * d, generator=gen).to(dtype)
    xk_t = torch.randn(1, sk, h * d, generator=gen).to(dtype)
    out = tattn.MultiHeadAttention().forward(layer, params, [xq_t, xk_t, xk_t],
                                             OpContext(True, torch.device("cpu"), gen))[0]
    assert out.shape == (1, sq, h * d) and out.dtype == dtype
    assert taken == [want]



@pytest.mark.parametrize("kernel", ["dq", "dkv", "fwd"])
def test_first_design_on_cpu_tensors_returns_the_plain_version(kernel):
    """``first_design=True`` picks a CUDA kernel's first design; on CPU
    float32 tensors the wrapper runs the plain version whatever it says."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 256, 256, 64, seed=11))
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, True)
    args = (q, k, v, g, lse, tfa.flash_delta(out, g), True, 0.1, 5)
    if kernel == "fwd":
        args = (q, k, v, True, 0.1, 5)
    wrapper, plain = {"fwd": (tfa.flash_fwd, tfa.flash_attention_fwd_plain),
                      "dq": (tfa.flash_bwd_dq, tfa.flash_attention_bwd_dq_plain),
                      "dkv": (tfa.flash_bwd_dkv, tfa.flash_attention_bwd_dkv_plain)}[kernel]
    launches = dict(tfa.LAUNCHES)
    got = wrapper(*args, first_design=True)
    assert tfa.LAUNCHES == launches
    want = plain(*args)
    pair = kernel != "dq"  # (out, lse) or (dk, dv)
    for a, b in zip(got if pair else (got,), want if pair else (want,)):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


# --- the float32 backward's 3xTF32 products, emulated in numpy -------------
# The CUDA kernels (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel) take
# every product of float32 operands as three TF32 products on
# mma.sync.m16n8k8: x = hi + lo with hi = x rounded to TF32 (half a TF32 step
# added, the low 13 bits cleared) and lo = x - hi, which the tensor core
# reads cut to TF32; per k-step of 8, lo_a . hi_b, then hi_a . lo_b, then
# hi_a . hi_b, each summed exactly and added to the float32 accumulator.
# The emulation rounds each sum to nearest; a tensor core rounds it mostly
# toward zero (tools/torch_tf32_probe.py), so the kernels land farther off.

def _tf32_split(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = (x - hi).astype(np.float32)
    return hi, (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_tf32(a, b, terms):
    """a (M, K) . b (K, N) float32 as the kernels take it: ``terms`` 3 is
    3xTF32, 1 a single TF32 product (hi . hi)."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            part = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _bwd_tf32(q, k, v, do, lse, delta, terms):
    """dq, dk, dv of one head through the kernels' float32 steps."""
    scale = np.float32(1.0 / np.sqrt(q.shape[-1]))
    s = _mm_tf32(q, k.T, terms)
    p = np.exp(s * scale - lse[:, None]).astype(np.float32)
    ds = (p * (_mm_tf32(do, v.T, terms) - delta[:, None])).astype(np.float32)
    return (_mm_tf32(ds, k, terms) * scale, _mm_tf32(ds.T, q, terms) * scale,
            _mm_tf32(p.T, do, terms))


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_products_hold_float32_error_level(d):
    """Through the dQ, dK and dV products, the kernels' 3xTF32 split stays
    within 1e-4 (FLASH_TOL's float32 backward gate) of a float64
    computation, relative to max |reference|; a single TF32 product is at
    least 100x farther off."""
    q, k, v, g = _inputs(1, 2, 256, 256, d, seed=d)
    for h in range(2):
        qh, kh, vh, gh = (x[0, h] for x in (q, k, v, g))
        q64, k64, v64, g64 = (x.astype(np.float64) for x in (qh, kh, vh, gh))
        s = q64 @ k64.T / np.sqrt(d)
        lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
        p = np.exp(s - lse[:, None])
        delta = ((p @ v64) * g64).sum(-1)
        ds = p * (g64 @ v64.T - delta[:, None])
        want = (ds @ k64 / np.sqrt(d), ds.T @ q64 / np.sqrt(d), p.T @ g64)
        lse32, delta32 = lse.astype(np.float32), delta.astype(np.float32)
        three = _bwd_tf32(qh, kh, vh, gh, lse32, delta32, terms=3)
        one = _bwd_tf32(qh, kh, vh, gh, lse32, delta32, terms=1)
        for name, w, a, b in zip(("dq", "dk", "dv"), want, three, one):
            err3, err1 = _rel(a, w), _rel(b, w)
            assert err3 <= 1e-4, (name, err3)
            assert err1 >= 100 * err3, (name, err1, err3)


# --- the float32 forward's 3xTF32 tiles, emulated in numpy ------------------
# flash_fwd_tf32_kernel takes S = Q.K^T and each 64-key tile's P.V as 3xTF32
# mma.sync products.  The emulation below rounds every mma's sum toward zero,
# as an H100's tensor core mostly does (tools/torch_tf32_probe.py), and merges
# the tiles by the kernel's float32 online softmax.  The kernel sums each
# tile's P.V into a zeroed accumulator and folds it into the running output
# as o * alpha + pv in float32; the alternative, one running accumulator kept
# in the tensor core across all tiles, is emulated beside it.

def _rz32(x):
    """float64 -> float32, rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def _mm_tf32_rz(a, b, acc):
    """acc + a (M, K) . b (K, N) as 3xTF32 mma.sync m16n8k8 steps: per k-step
    of 8, lo_a . hi_b, hi_a . lo_b, hi_a . hi_b, each one mma whose exact sum
    with the accumulator is rounded toward zero to float32."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    for k0 in range(0, a.shape[1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
            acc = _rz32(acc.astype(np.float64) + part)
    return acc


def _fwd_tf32_tiles(q, k, v, per_tile, tile=64):
    """(o, lse) of one causal head through the kernel's float32 steps over
    tiles of ``tile`` keys: ``per_tile`` sums each tile's P.V apart and adds
    it as o * alpha + pv (one float32 rounding), else P.V goes on into one
    running accumulator after o *= alpha."""
    sq, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    m = np.full((sq, 1), -1e30, np.float32)
    l = np.zeros((sq, 1), np.float32)
    o = np.zeros((sq, d), np.float32)
    rows = np.arange(sq)[:, None]
    for k0 in range(0, k.shape[0], tile):
        s = _mm_tf32_rz(q, k[k0:k0 + tile].T, np.zeros((sq, tile), np.float32))
        vis = rows + (k.shape[0] - sq) >= k0 + np.arange(tile)[None, :]
        s = np.where(vis, s * scale, np.float32(-1e30)).astype(np.float32)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp(m - m_new).astype(np.float32)
        p = np.where(vis, np.exp(s - m_new), 0).astype(np.float32)
        l = (l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
        m = m_new
        if per_tile:
            pv = _mm_tf32_rz(p, v[k0:k0 + tile], np.zeros((sq, d), np.float32))
            o = (o.astype(np.float64) * alpha + pv).astype(np.float32)
        else:
            o = _mm_tf32_rz(p, v[k0:k0 + tile], (o * alpha).astype(np.float32))
    l_safe = np.maximum(l, np.float32(1e-30))
    return (o / l_safe).astype(np.float32), (m + np.log(l_safe)).astype(np.float32)[:, 0]


def test_fwd_3xtf32_tiles_hold_the_float32_forward_gate():
    """At a causal Sk 2048 head (chip_smoke.py's causal_tiled_2048) the
    forward's 3xTF32 tiles, with each tile's P.V summed apart, stay within
    2e-5 (FLASH_TOL's float32 forward gate) of a float64 computation in o
    and lse, relative to max |reference|.  One running accumulator in the
    tensor core lands at least 3x farther off in o."""
    q, k, v, _ = _inputs(1, 1, 2048, 2048, 64, seed=2048)
    q, k, v = q[0, 0], k[0, 0], v[0, 0]
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = q64 @ k64.T / 8.0
    s = np.where(np.tril(np.ones((2048, 2048), bool)), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    e = np.exp(s - mx)
    want_o = (e @ v64) / e.sum(-1, keepdims=True)
    want_lse = mx[:, 0] + np.log(e.sum(-1))
    o_t, lse_t = _fwd_tf32_tiles(q, k, v, per_tile=True)
    o_r, lse_r = _fwd_tf32_tiles(q, k, v, per_tile=False)
    err_tile, err_run = _rel(o_t, want_o), _rel(o_r, want_o)
    assert err_tile <= 2e-5, err_tile
    assert _rel(lse_t, want_lse) <= 2e-5
    assert err_run >= 3 * err_tile, (err_run, err_tile)
