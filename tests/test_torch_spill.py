"""KV spill and restore, the ``ffkv/1`` codec and ``ffdrain/1`` files: the
port against the JAX package, on the CPU.

Pools at smoke shape (2 layers, 2 heads, head dim 4) in every pool
format (float32, bfloat16, int8, float8 e4m3) are filled with the same
seeded numpy contents in both packages.  Spill payloads must agree byte
for byte, with the port holding bfloat16 pages as ``|V2`` and float8
pages as ``uint8`` where the JAX package holds ``ml_dtypes`` arrays; a
payload of either package restores into a pool of the other to the same
bits, across block sizes and with re-attached prefix blocks; frames and
drain files written by either package verify and load in the other.
One exception is pinned as found: the JAX package hashes a bfloat16
page under the dtype string ``bfloat16`` but reads it back as ``|V2``,
so its own bfloat16 frames and drain files fail their digest check in
both packages (the port's bfloat16 files verify in both).
"""

from __future__ import annotations

import os
import sys

import ml_dtypes
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.model import CheckpointError as JaxCheckpointError  # noqa: E402
from flexflow_tpu.model import _checkpoint_digest as jax_digest  # noqa: E402
from flexflow_tpu.serve import wire as jwire  # noqa: E402
from flexflow_tpu.serve.engine import load_drain as jax_load_drain  # noqa: E402
from flexflow_tpu.serve.engine import save_drain as jax_save_drain  # noqa: E402
from flexflow_tpu.serve.kvcache import PagedKVCache as JaxKV  # noqa: E402
from flexflow_tpu_torch.model import CheckpointError, _checkpoint_digest  # noqa: E402
from flexflow_tpu_torch.serve import wire  # noqa: E402
from flexflow_tpu_torch.serve.engine import load_drain, save_drain  # noqa: E402
from flexflow_tpu_torch.serve.kvcache import PagedKVCache, pool_bits  # noqa: E402

FORMATS = ("fp32", "bf16", "int8", "fp8")
L, H, D = 2, 2, 4
# the JAX pools' numpy element types, and the port payload's for the same bits
JAX_NP = {"fp32": np.float32, "bf16": ml_dtypes.bfloat16, "int8": np.int8,
          "fp8": ml_dtypes.float8_e4m3fn}
PORT_NP = {"fp32": np.dtype(np.float32), "bf16": np.dtype("V2"), "int8": np.dtype(np.int8),
           "fp8": np.dtype(np.uint8)}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pools(kv_dtype, block_size=4, slots=2, **kw):
    kw = dict(slots=slots, block_size=block_size, max_seq_len=32, kv_dtype=kv_dtype, **kw)
    return JaxKV(L, H, D, **kw), PagedKVCache(L, H, D, device="cpu", **kw)


def _contents(kv_dtype, shape, seed):
    """Seeded finite values in the pool's element type, as a numpy array."""
    rng = np.random.default_rng(seed)
    if kv_dtype == "int8":
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    return (4 * rng.standard_normal(shape)).astype(np.float32).astype(JAX_NP[kv_dtype])


def _torch_bits(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a``'s bits as a tensor of ``like``'s dtype (float8 as its uint8 view)."""
    bits = {1: np.int8 if like.dtype == torch.int8 else np.uint8, 2: np.int16, 4: np.int32}
    t = torch.from_numpy(np.ascontiguousarray(a).view(bits[a.dtype.itemsize]))
    return t.view(like.dtype)


def _fill(jkv, tkv, seed=1):
    """The same seeded contents (pages and scales) in both pools."""
    shape = tuple(jkv.cache_k.shape)
    for i, name in enumerate(("cache_k", "cache_v")):
        a = _contents(jkv.kv_dtype, shape, seed + i)
        setattr(jkv, name, jnp.asarray(a))
        pool_bits(getattr(tkv, name)).copy_(_torch_bits(a, pool_bits(getattr(tkv, name))))
    if jkv.quantized:
        rng = np.random.default_rng(seed + 7)
        for name in ("scale_k", "scale_v"):
            s = rng.uniform(0.01, 1.0, size=tuple(jkv.scale_k.shape)).astype(np.float32)
            setattr(jkv, name, jnp.asarray(s))
            getattr(tkv, name).copy_(torch.from_numpy(s))


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = pool_bits(a).contiguous()
        return a.view(torch.uint8).numpy().tobytes() if a.numel() else b""
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _to_jax(payload):
    """A port payload as the JAX package holds it: bit views taken back
    as ``ml_dtypes`` arrays (the dtype mapping, nothing converted)."""
    kvd = payload.get("kv_dtype", "fp32")
    out = dict(payload, layers={})
    for name, d in payload["layers"].items():
        nd = dict(d)
        for kk in ("k", "v"):
            a = d[kk]
            if a.dtype == np.dtype("V2"):
                nd[kk] = a.view(ml_dtypes.bfloat16)
            elif kvd == "fp8":
                nd[kk] = a.view(ml_dtypes.float8_e4m3fn)
        out["layers"][name] = nd
    return out


def _same_payload(a, b):
    assert a["length"] == b["length"] and a.get("kv_dtype") == b.get("kv_dtype")
    assert sorted(a["layers"]) == sorted(b["layers"])
    for name in a["layers"]:
        assert sorted(a["layers"][name]) == sorted(b["layers"][name])
        for kk, x in a["layers"][name].items():
            y = b["layers"][name][kk]
            assert x.shape == y.shape and x.dtype.itemsize == y.dtype.itemsize
            assert _bits(x) == _bits(y), (name, kk)


def _dense(kv, slot, n):
    """Pages and scales of a slot's first ``n`` positions as bytes."""
    out = [_bits(t) for t in kv.gather_dense(slot, n)]
    if kv.quantized:
        out += [_bits(t) for t in kv.gather_scales(slot, n)]
    return out


# ------------------------------------------------------------------ spill
@pytest.mark.parametrize("kv_dtype", FORMATS)
def test_spill_payloads_match_jax_bytes_and_dtypes(kv_dtype):
    jkv, tkv = _pools(kv_dtype)
    for kv in (jkv, tkv):
        kv.reserve(0, 12)
    _fill(jkv, tkv)
    jp, tp = jkv.spill(0, 11), tkv.spill(0, 11)
    _same_payload(jp, tp)
    k_j, k_t = jp["layers"]["layer1"]["k"], tp["layers"]["layer1"]["k"]
    assert k_t.shape == (H, 11, D)
    assert k_j.dtype == np.dtype(JAX_NP[kv_dtype]) and k_t.dtype == PORT_NP[kv_dtype]
    if jkv.quantized:
        assert tp["layers"]["layer0"]["sk"].dtype == np.float32
    assert wire.kv_payload_nbytes(tp) == jwire.kv_payload_nbytes(jp)
    # one copy each way per spill, with the payload's bytes
    assert tkv.spill_copies == 1 and tkv.spill_bytes == wire.kv_payload_nbytes(tp)
    assert tkv.owned(0) == () and jkv.owned(0) == ()
    tkv.check_invariants()


@pytest.mark.parametrize("kv_dtype", FORMATS)
def test_spill_restore_reattaches_prefix_blocks_bit_exact(kv_dtype):
    """The JAX package's round trip (tests/test_serve_multitenant.py): two
    prompt blocks registered, spilled, restored to another slot; the
    prefix re-attaches and only the private span is written."""
    jkv, tkv = _pools(kv_dtype)
    p = np.arange(9, dtype=np.int32)
    for kv in (jkv, tkv):
        kv.reserve(0, 12, prompt=p)
    _fill(jkv, tkv)
    for kv in (jkv, tkv):
        kv.commit_prefix(0, p, 9)
    before = _dense(tkv, 0, 11)
    assert before == _dense(jkv, 0, 11)
    tp, jp = tkv.spill(0, 11), jkv.spill(0, 11)
    restore_bytes0 = tkv.restore_bytes
    assert tkv.restore(1, tp, 12, prompt=p) == jkv.restore(1, jp, 12, prompt=p) == 8
    assert _dense(tkv, 1, 11) == before == _dense(jkv, 1, 11)
    assert tkv.owned(1) == jkv.owned(1)
    assert tkv.shared_len(1) == jkv.shared_len(1) == 8
    # the write covered the private block only (positions 8..11, one block)
    per_pos = 2 * L * H * D * tkv.cache_k.element_size() + (2 * L * 4 if tkv.quantized else 0)
    assert tkv.restore_copies == 1 and tkv.restore_bytes - restore_bytes0 == 4 * per_pos
    assert tkv.shared_write_hazards() == jkv.shared_write_hazards() == []
    tkv.check_invariants()


@pytest.mark.parametrize("src_bs,dst_bs", [(4, 8), (8, 4)])
@pytest.mark.parametrize("kv_dtype", FORMATS)
def test_round_trip_across_block_sizes(kv_dtype, src_bs, dst_bs):
    """Spill from one block geometry, restore into another (and a smaller
    pool): the gathered pages, scales included, equal the spilled bits,
    and a second spill gives the same payload."""
    jkv, tkv = _pools(kv_dtype, block_size=src_bs)
    for kv in (jkv, tkv):
        kv.reserve(1, 21)
    _fill(jkv, tkv, seed=5)
    before = _dense(tkv, 1, 19)
    tp, jp = tkv.spill(1, 19), jkv.spill(1, 19)
    _same_payload(jp, tp)
    jdst, tdst = _pools(kv_dtype, block_size=dst_bs, num_blocks=8)
    assert tdst.restore(0, tp, 21) == jdst.restore(0, jp, 21) == 0
    assert _dense(tdst, 0, 19) == before == _dense(jdst, 0, 19)
    _same_payload(tp, tdst.spill(0, 19))
    tdst.check_invariants()


@pytest.mark.parametrize("kv_dtype", FORMATS)
def test_payloads_restore_across_packages(kv_dtype):
    """A JAX payload restores into a port pool, and a port payload into a
    JAX pool, to the same bits."""
    jkv, tkv = _pools(kv_dtype)
    for kv in (jkv, tkv):
        kv.reserve(0, 14)
    _fill(jkv, tkv, seed=9)
    before = _dense(tkv, 0, 13)
    jp, tp = jkv.spill(0, 13), tkv.spill(0, 13)
    jdst, tdst = _pools(kv_dtype, block_size=8)
    tdst.restore(1, jp, 14)  # the JAX payload, ml_dtypes arrays and all
    jdst.restore(1, _to_jax(tp), 14)
    assert _dense(tdst, 1, 13) == before == _dense(jdst, 1, 13)
    tdst.check_invariants()


def _refusal_cases():
    # (payload pool kv_dtype, destination kv_dtype, destination heads, layers)
    return {
        "int8_into_fp8": ("int8", "fp8", H, L),
        "int8_into_fp32": ("int8", "fp32", H, L),
        "fp32_into_int8": ("fp32", "int8", H, L),
        "heads_differ": ("fp32", "fp32", H + 1, L),
        "layers_differ": ("bf16", "bf16", H, L + 1),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_restore_refusals_release_the_reservation(case):
    src, dst, heads, layers = _refusal_cases()[case]
    jkv, tkv = _pools(src)
    for kv in (jkv, tkv):
        kv.reserve(0, 12)
    _fill(jkv, tkv)
    tp = tkv.spill(0, 10)
    kw = dict(slots=2, block_size=4, max_seq_len=32, kv_dtype=dst)
    tdst = PagedKVCache(layers, heads, D, device="cpu", **kw)
    free = len(tdst._free)
    with pytest.raises(ValueError, match="kv_dtype|model shape"):
        tdst.restore(0, tp, 12)
    assert tdst.owned(0) == () and len(tdst._free) == free
    assert tdst.restore_copies == 0
    tdst.check_invariants()
    if case != "layers_differ":  # the JAX package raises a KeyError there
        jdst = JaxKV(layers, heads, D, **kw)
        with pytest.raises(ValueError, match="kv_dtype|model shape"):
            jdst.restore(0, _to_jax(tp), 12)
        assert jdst.owned(0) == ()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_restore_refuses_scales_of_another_length(kv_dtype):
    _, tkv = _pools(kv_dtype)
    tkv.reserve(0, 12)
    tp = tkv.spill(0, 10)
    tp["layers"]["layer1"]["sv"] = tp["layers"]["layer1"]["sv"][:-1]
    with pytest.raises(ValueError, match="model shape"):
        tkv.restore(1, tp, 12)
    assert tkv.owned(1) == () and tkv.restore_copies == 0
    tkv.check_invariants()


def test_capacity_queries_match_jax():
    jkv, tkv = _pools("int8", num_blocks=6)
    for n in (1, 20, 21, 32, 33):
        assert tkv.fits_ever(n) == jkv.fits_ever(n)
    assert tkv.hbm_bytes() == jkv.hbm_bytes()
    jkv2, tkv2 = _pools("fp32")
    assert tkv2.hbm_bytes() == jkv2.hbm_bytes()
    p = np.arange(9, dtype=np.int32)
    for kv in (jkv2, tkv2):
        kv.reserve(0, 12, prompt=p)
        kv.commit_prefix(0, p, 9)
        kv.reserve(1, 12, prompt=p)
    assert tkv2.shared_write_hazards() == jkv2.shared_write_hazards() == []
    # a registered block in a slot's write range is a hazard in both
    for kv in (jkv2, tkv2):
        kv._protected[1] = 0
    assert tkv2.shared_write_hazards() == jkv2.shared_write_hazards() != []


# ------------------------------------------------------------------ frames
def _request(payload, rid=3):
    return {"id": rid, "prompt": np.arange(7, dtype=np.int32), "max_new_tokens": 9,
            "tokens": [4, 5], "tenant": "acme", "tier": "batch", "preemptions": 1,
            "kv_spill": payload}


def _payloads(kv_dtype, seed=2):
    jkv, tkv = _pools(kv_dtype)
    for kv in (jkv, tkv):
        kv.reserve(0, 12)
    _fill(jkv, tkv, seed=seed)
    return jkv.spill(0, 10), tkv.spill(0, 10)


@pytest.mark.parametrize("kv_dtype", FORMATS)
def test_flatten_matches_jax(kv_dtype):
    jp, tp = _payloads(kv_dtype)
    tflat, tmetas = wire.flatten_requests([_request(tp)])
    jflat, jmetas = jwire.flatten_requests([_request(jp)])
    assert tmetas == jmetas
    assert sorted(tflat) == sorted(jflat)
    for key in tflat:
        assert _bits(tflat[key]) == _bits(jflat[key]), key
    # the JAX flattening of the port's payload is the port's, digest and all
    jflat_t, _ = jwire.flatten_requests([_request(tp)])
    assert _checkpoint_digest(tflat) == jax_digest(jflat_t) == _checkpoint_digest(jflat_t)
    if kv_dtype == "bf16":
        # the JAX package's own bfloat16 pages hash under "bfloat16"
        assert str(jflat["r0/kv/layer0/k"].dtype) == "bfloat16"
        assert str(tflat["r0/kv/layer0/k"].dtype) == "|V2"
    else:
        assert _checkpoint_digest(tflat) == jax_digest(jflat)


@pytest.mark.parametrize("kv_dtype", FORMATS)
def test_drain_files_load_in_both_packages(kv_dtype, tmp_path):
    jp, tp = _payloads(kv_dtype)
    port_file = save_drain(str(tmp_path / "port"), {"requests": [_request(tp)]})
    for loader in (jax_load_drain, load_drain):
        back = loader(port_file)
        assert back["schema"] == "ffdrain/1" and len(back["requests"]) == 1
        r = back["requests"][0]
        assert (r["id"], r["tokens"], r["tenant"], r["preemptions"]) == (3, [4, 5], "acme", 1)
        _same_payload(tp, r["kv_spill"])
    jax_file = jax_save_drain(str(tmp_path / "jax"), {"requests": [_request(jp)]})
    if kv_dtype == "bf16":
        for loader, err in ((jax_load_drain, JaxCheckpointError), (load_drain, CheckpointError)):
            with pytest.raises(err, match="content-digest"):
                loader(jax_file)
        # the JAX writer on the bit-view payload writes a file both read
        jax_file = jax_save_drain(str(tmp_path / "jax_bits"), {"requests": [_request(tp)]})
    back = load_drain(jax_file)
    _same_payload(tp, back["requests"][0]["kv_spill"])
    # and it restores into a port pool to the spilled bits
    tkv = PagedKVCache(L, H, D, slots=2, block_size=8, max_seq_len=32, kv_dtype=kv_dtype,
                       device="cpu")
    tkv.restore(0, back["requests"][0]["kv_spill"], 12)
    assert _dense(tkv, 0, 10)[:2] == [_bits(np.stack([tp["layers"][f"layer{i}"][k]
                                                       for i in range(L)])) for k in ("k", "v")]


@pytest.mark.parametrize("kv_dtype", FORMATS)
def test_handoff_frames_decode_in_both_packages(kv_dtype):
    jp, tp = _payloads(kv_dtype, seed=4)
    frame = wire.encode_handoff(_request(tp))
    assert frame == jwire.encode_handoff(_request(tp))  # the same bytes
    for decode in (wire.decode_handoff, jwire.decode_handoff):
        r = decode(frame)
        assert r["id"] == 3 and r["tokens"] == [4, 5]
        _same_payload(tp, r["kv_spill"])
    jframe = jwire.encode_handoff(_request(jp))
    if kv_dtype == "bf16":
        for decode, err in ((wire.decode_handoff, wire.HandoffError),
                            (jwire.decode_handoff, jwire.HandoffError)):
            with pytest.raises(err, match="content-digest"):
                decode(jframe)
    else:
        _same_payload(tp, wire.decode_handoff(jframe)["kv_spill"])


def test_torn_drain_file_and_frame_refused(tmp_path):
    _, tp = _payloads("int8")
    path = save_drain(str(tmp_path / "d.npz"), {"requests": [_request(tp)]})
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    for loader, err in ((load_drain, CheckpointError), (jax_load_drain, JaxCheckpointError)):
        with pytest.raises(err, match="torn or truncated"):
            loader(path)
    frame = wire.encode_handoff(_request(tp))
    with pytest.raises(wire.HandoffError, match="torn or truncated"):
        wire.decode_handoff(frame[: len(frame) // 3])


@pytest.mark.parametrize("key", ["r0/kv/layer1/v", "r0/kv/layer0/sk", "r0/tokens"])
def test_tampered_array_fails_its_digest(key, tmp_path):
    import zipfile

    _, tp = _payloads("int8")
    path = save_drain(str(tmp_path / "d.npz"), {"requests": [_request(tp)]})
    with np.load(path) as z:
        flat = {k: np.array(z[k]) for k in z.files}
    flat[key].reshape(-1).view(np.uint8)[0] ^= 1
    bad = str(tmp_path / "bad.npz")
    with open(bad, "wb") as f:
        np.savez(f, **flat)
    assert zipfile.is_zipfile(bad)
    for loader, err in ((load_drain, CheckpointError), (jax_load_drain, JaxCheckpointError)):
        with pytest.raises(err, match="content-digest"):
            loader(bad)
    with pytest.raises(wire.HandoffError, match="no manifest"):
        wire.verify_flat({k: v for k, v in flat.items() if k != "meta/manifest"}, "frame")
