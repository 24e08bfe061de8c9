#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. ``build``: compile every kernel source under
   ``flexflow_tpu_torch/ops/cuda/csrc`` (one ``nvcc`` per source, all at
   once) and report the seconds each took.
2. ``paged_attention``: the CUDA kernel against its plain PyTorch
   version on the card, float32 and bfloat16 (and a float32 query over
   a bfloat16 pool), G=1 (decode) and G=32
   (prefill chunk), BS 16, D 64, H 12, scrambled block tables, pages
   outside each lane's view poisoned with 1e4, starts that straddle a
   page.  Tolerances, by output dtype: float32 2e-5 absolute (the two
   sum in different orders: online softmax page by page against one
   softmax over the gathered row); bfloat16 2e-2 + 2^-7 x |reference|
   (both round a float32 result to bfloat16, which can land one bfloat16
   step apart).  A page too large for shared memory must raise, and
   the next launch must still succeed.
   Then the kernel, the plain version and ``scaled_dot_product_attention``
   on pre-gathered K/V are timed at the serve phase's shapes.
   ``paged_attention_quant``: the same kernel over int8 and float8 e4m3
   pools with their per-position scale rows, q float32 and bfloat16,
   G = 1, 4 and 32, with the same tolerances; pages past each lane's view
   hold ints at the format's maximum with scale rows 1e4, the trash block
   the same ints with zero scales.  ``paged_attention_quant_timing`` times
   it at the serve shapes beside its bound (1-byte K/V plus two float32
   scales per visible position), its plain version and
   ``scaled_dot_product_attention`` on pre-gathered dequantized K/V.
   Three more cases hold the row-group path (split over pages, then
   combined) at its edges, int8 and fp8, q float32 and bfloat16: a
   ragged G of 20 (``ragged``), lanes at position 0 whose later splits
   hold nothing they see (``position_0``), and rows that straddle a
   split boundary (``straddle``).  The prefill timing also times the
   single-pass design it replaced (``was_ms``).
3. ``serve``: the port's main path, ``ServeEngine.run`` at GPT-2-small
   width and depth (hidden 768, 12 heads, ff 3072, 12 layers, vocab
   50257, seq 1024), float32, random weights from a seed, 8 slots,
   block 16, prefill chunk 32, sync_every 4, ``attn="auto"``; 16
   requests with prompts of 128-512 tokens and 32-64 new tokens.  The
   kernel's launch count is set to 0 just before the run and must equal
   12 x (decode steps + prefill dispatches) after it.  The same requests
   are served again with ``attn="gather"`` and the greedy streams
   compared; both programs are then run on identical inputs and their
   next-token probabilities compared.
   ``profile`` then traces a separate serve run: device time by kernel
   and the device's idle share.
   ``serve_quant`` serves the same requests with ``kv_dtype`` "int8" and
   "fp8": every request must finish with its full budget, the quantized
   kernel's launches must equal 12 x (decode steps + prefill dispatches),
   one host sync per window; the gather path's streams are compared and
   its programs' probabilities must agree within ``QUANT_PROB_TOL``.
   ``serve_spec`` adds speculative decoding (k = 3, a 6-layer draft) over
   int8 pools: launches 12 x (prefill dispatches + macros) + 6 x 3 x
   macros, and every stream equal to the plain int8 greedy stream up to
   the first token whose relative top-2 margin in the plain run is under
   1e-4.  ``profile_quant`` traces the profile run with int8 pools.
   ``serve_w8`` serves with int8 weights and int8 pools.
4. ``flash_attention``: the three flash kernels (forward, dQ, dK/dV)
   against their plain versions at the training slice's shape (B 16,
   H 12, S 512, D 64, float32 and bfloat16), causal with Sq 128 / Sk 256,
   causal at S 2048, dropout 0.1 with a fixed seed (and a case whose V is
   the identity, so the output shows the dropped probabilities: the
   zeros must fall on the same places), and rows with no visible key
   (output exactly 0); ``causal_cross``, ``causal_tiled_2048`` and
   ``no_visible_key`` run in bfloat16 as well, and bfloat16 adds
   ``slice_d128`` (B 2, H 12, S 512, D 128) and ``dropout_d64`` (B 2,
   H 12, S 512, D 64, dropout 0.1); float32 adds ``slice_d128`` and
   ``dropout_causal`` (B 2, H 4, S 512, D 128, causal, dropout 0.1), the
   float32 backward's D 128 kernels with the mask and dropout together.
   Tolerances, relative to max |reference|: float32 2e-5 forward, 1e-4
   backward (the kernels sum tile by tile, the plain versions over whole
   rows; the float32 backward's products are 3xTF32); bfloat16 2e-2 (both
   round the same float32 values to bfloat16, at different places for
   the probabilities).
   ``flash_attention_timing`` times each kernel at the slice's shape
   beside its bound, the plain version and
   ``scaled_dot_product_attention`` (forward, and its autograd backward
   for dQ + dK + dV); each redesigned kernel (the bfloat16 three, the
   float32 dQ and dK/dV) also times its first design (``was_ms``).
5. ``train``: the training slice's main path, BERT-Base (hidden 768,
   12 heads, ff 3072, 12 layers) on (16, 512, 768) inputs with a 64-class
   pooled head, Adam(1e-4), sparse CCE, 5 steps on one seeded batch, in
   float32 and in bfloat16 compute.  The flash launch counts are set to 0
   just before each run and must equal 12 x 5 per kernel after it.  The
   same model from the same weights then trains with ``use_flash=False``
   (the plain ``sdpa`` core): the loss curves must agree within 1e-4
   relative (float32) or 2e-2 (bfloat16).  ``train_profile`` traces 3
   more steps of the float32 model, and of the bfloat16 model with flash
   and with the plain core: device time by kernel and the idle share.
6. ``kernels``: one line ``{"kernels": [...]}`` with each kernel's
   route, source, the TPU kernel it replaces, launches on its path
   (``paged_attention_quant``: the int8 ``serve_quant`` run, fp8 beside
   it), error against the plain version, times and bound, and
   ``was_ms`` beside a redesigned kernel's time.  Every time is device
   time: the card spins while the host queues the timed call.

The line before the last is the card's name and power limit from
``nvidia-smi``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 0
DEVICE = "cuda:0"
B, H, D, BS = 8, 12, 64, 16  # serve slots, heads, head dim, block size
SEQ, VOCAB = 1024, 50257
MB = SEQ // BS
CHUNK = 32
TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}  # (abs, rel)
# training slice: BERT-Base at seq 512, batch 16, 64 classes, 5 steps
TRAIN_B, TRAIN_S, TRAIN_CLASSES, TRAIN_STEPS, TRAIN_LR = 16, 512, 64, 5, 1e-4
# flash kernel tolerances, relative to max |reference|
FLASH_TOL = {("float32", "fwd"): 2e-5, ("float32", "bwd"): 1e-4,
             ("bfloat16", "fwd"): 2e-2, ("bfloat16", "bwd"): 2e-2}
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # flash vs sdpa, relative
# paged against gather programs over quantized pools, relative to the largest
# probability: a float32 difference between the two paths can flip one
# stored int8 step or e4m3 step (up to 1/8 of an element) of the K/V the
# later layers write, ten times the float32 pools' 1e-3
QUANT_PROB_TOL = 1e-2
# speculative arm: draft 3 tokens with the first 6 of 12 layers; its streams
# must equal the plain int8 greedy streams up to the first token whose
# relative top-2 margin (p1 - p2) / p1 is under SPEC_MARGIN
SPEC_K, SPEC_DRAFT, SPEC_MARGIN = 3, 6, 1e-4
SPLIT_KEYS = 64  # the straddle case's boundary where no page split is planned
# cycles the card spins before each timed call (about 1 ms at 1.98 GHz)
SPIN_CYCLES = 2_000_000
# published peaks of the cards the port runs on (NVIDIA data sheet,
# dense): HBM bytes/s, TF32 and bfloat16 tensor-core flop/s.  A bound
# prices bfloat16 products at the bfloat16 rate and float32-accurate
# products at the fastest rate that holds them for their inputs: 3xTF32
# for two float32 operands (three TF32 products each: a third of the TF32
# rate, above the CUDA cores' 67e12), three bfloat16 products (a third of
# the bfloat16 rate) where one operand is an int8 or e4m3 value
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "tf32_flop_per_s": 494.7e12,
                              "bf16_flop_per_s": 989e12},  # H100 SXM5
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(bytes/s, float32-accurate flop/s, bfloat16 flop/s) of the card."""
    if name not in PEAKS:
        raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}; add them to PEAKS")
    p = PEAKS[name]
    return p["bytes_per_s"], p["tf32_flop_per_s"] / 3, p["bf16_flop_per_s"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from flexflow_tpu_torch.models.transformer import BERT_BASE, GPT2_SMALL, GPTDecoder
    from flexflow_tpu_torch.ops import cuda as ffcuda
    from flexflow_tpu_torch.ops.cuda import flash_attention as fa
    from flexflow_tpu_torch.ops.cuda import paged_attention as pa
    from flexflow_tpu_torch.runtime.driver import build_model, make_batch, run
    from flexflow_tpu_torch.serve import ServeEngine, TrafficSpec, synthetic_requests
    from flexflow_tpu_torch.serve.kvcache import kv_qmax, pool_bits, quantize_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    peak_bw, peak_3xtf32, peak_bf16 = peaks(torch.cuda.get_device_name(0))
    peak_3xbf16 = peak_bf16 / 3

    # --- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = ffcuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_by_source": dict(ffcuda.BUILD_SECONDS),
          "libraries": sorted(p.name for p in libs.values()), "card": card})
    if sorted(libs) != ["flash_attention", "paged_attention"]:
        raise SystemExit(f"build: expected both kernel sources, got {sorted(libs)}")

    # --- 2. paged_attention: kernel against plain, then timing ---------------
    def case(rng, G, dtype, pos, q_dtype=None):
        N = B * MB + 1  # + trash block 0
        q = torch.from_numpy(rng.standard_normal((B, G, H, D)).astype(np.float32))
        pk = torch.from_numpy(rng.standard_normal((N, H, BS, D)).astype(np.float32))
        pv = torch.from_numpy(rng.standard_normal((N, H, BS, D)).astype(np.float32))
        bt = (rng.permutation(N - 1) + 1)[: B * MB].reshape(B, MB).astype(np.int32)
        pk[0] = pv[0] = 1e4
        for b in range(B):
            last = (int(pos[b]) + G - 1) // BS
            for i in range(last + 1, MB):
                pk[bt[b, i]] = 1e4
                pv[bt[b, i]] = 1e4
        return (q.to(dev, q_dtype or dtype), pk.to(dev, dtype), pv.to(dev, dtype),
                torch.from_numpy(pos.astype(np.int32)).to(dev),
                torch.from_numpy(bt).to(dev))

    def quant_case(rng, G, kv_dtype, pos, q_dtype):
        """Pools quantized from normal K/V by the pools' own rule; pages past
        each lane's last visible page poisoned (ints at the format's
        maximum, scale rows 1e4), the trash block poisoned with zero
        scales."""
        N = B * MB + 1
        q = torch.from_numpy(rng.standard_normal((B, G, H, D)).astype(np.float32))
        pools = []
        for _ in range(2):
            x = torch.from_numpy(rng.standard_normal((N, BS, H, D)).astype(np.float32)).to(dev)
            qx, sc = quantize_kv(x, kv_dtype)
            qx = pool_bits(qx).permute(0, 2, 1, 3).contiguous().view(qx.dtype)
            pools.append((qx, sc.contiguous()))
        bt = (rng.permutation(N - 1) + 1)[: B * MB].reshape(B, MB).astype(np.int32)
        top = torch.full((H, BS, D), kv_qmax(kv_dtype), device=dev).to(pools[0][0].dtype)
        past = [int(bt[b, i]) for b in range(B)
                for i in range((int(pos[b]) + G - 1) // BS + 1, MB)]
        idx = torch.tensor([0] + past, dtype=torch.long, device=dev)
        for pool, sc in pools:
            pool_bits(pool)[idx] = pool_bits(top)
            sc[idx] = 1e4
            sc[0] = 0.0
        (pk, sk), (pv, sv) = pools
        return (q.to(dev, q_dtype), pk, pv, sk, sv,
                torch.from_numpy(pos.astype(np.int32)).to(dev), torch.from_numpy(bt).to(dev))

    rng = np.random.default_rng(SEED)
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    # (q dtype, pool dtype): the engine's float32 and bfloat16 pools, and
    # a float32 engine over a bfloat16 pool (kv_dtype="bf16")
    for q_dtype, dtype in ((f32, f32), (bf16, bf16), (f32, bf16)):
        for G in (1, CHUNK):
            # row 0 mid-page, so the G rows run across a page boundary
            pos = np.minimum(
                BS * rng.integers(0, MB, size=B) + BS // 2 + np.arange(B), MB * BS - G)
            args = case(rng, G, dtype, pos, q_dtype)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            want = pa.paged_attention_plain(*args)
            err = (got.float() - want.float()).abs()
            name = str(q_dtype).replace("torch.", "")  # the output's dtype
            atol, rtol = TOL[name]
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= atol + rtol * want.float().abs()).all())
            max_err = float(err.max())
            if q_dtype == f32:
                worst = max(worst, max_err)
            emit({"phase": "paged_attention", "q_dtype": name,
                  "pool_dtype": str(dtype).replace("torch.", ""), "G": G, "B": B, "H": H,
                  "D": D, "BS": BS, "MB": MB, "positions": pos.tolist(),
                  "max_abs_err": max_err, "atol": atol, "rtol": rtol, "ok": ok})
            if not ok:
                raise SystemExit(f"paged_attention q {q_dtype} pool {dtype} G={G}: kernel "
                                 f"disagrees with the plain version (max abs err {max_err})")

    # a page too large for shared memory is refused by the launcher, and
    # the refusal leaves no error behind for the next launch
    one = case(np.random.default_rng(SEED), 1, f32, np.zeros(B, np.int64))
    wide = torch.zeros(2, H, 1024, D, device=dev)
    try:
        pa.paged_attention(one[0], wide, wide, one[3],
                           torch.ones((B, 1), dtype=torch.int32, device=dev))
    except RuntimeError as e:
        refused = str(e)
    else:
        raise SystemExit("paged_attention took a 1024-position page")
    got = pa.paged_attention(*one)
    torch.cuda.synchronize()
    after = float((got - pa.paged_attention_plain(*one)).abs().max())
    emit({"phase": "paged_attention_refusal", "block_size": 1024, "error": refused,
          "next_launch_max_abs_err": after, "ok": after <= TOL["float32"][0]})
    if not after <= TOL["float32"][0]:
        raise SystemExit(f"the launch after a refusal disagrees (max abs err {after})")

    flush_buf = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)

    def time_ms(fn, iters=30):
        """Median device time of one call, L2 flushed before each (the
        50 MB L2 would otherwise hold the pages between launches).  The
        card first spins for about a millisecond, so the host has queued
        the flush, both events and the call before the card reaches them:
        the events then bracket the call's device work, not the host's
        enqueue of it."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            torch.cuda._sleep(SPIN_CYCLES)
            flush_buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    def timing(G, ctx, kv_dtype=None):
        """The kernel at the serve phase's shapes: 8 lanes whose row 0 sits
        at ``ctx``; a float32 pool, or an int8/fp8 one with its scales."""
        pos = np.full(B, ctx, np.int64)
        rng_t = np.random.default_rng(SEED + G)
        if kv_dtype is None:
            q, pk, pv, p_d, bt = case(rng_t, G, torch.float32, pos)
            sk = sv = None
        else:
            q, pk, pv, sk, sv, p_d, bt = quant_case(rng_t, G, kv_dtype, pos, torch.float32)
        scale = 1.0 / math.sqrt(D)

        def dense(pool, sc):  # (B, H, SV, D) float32, dequantized
            pages = pool_bits(pool)[bt.long()].view(pool.dtype).float()
            if sc is not None:
                pages = pages * sc[bt.long()][:, :, None, :, None]
            return pages.permute(0, 2, 1, 3, 4).reshape(B, H, MB * BS, D)

        keys, vals = dense(pk, sk), dense(pv, sv)
        k_pos = torch.arange(MB * BS, device=dev)
        rows = p_d.long()[:, None] + torch.arange(G, device=dev)
        mask = (k_pos[None, None, :] <= rows[:, :, None])[:, None]  # (B, 1, G, SV)
        qh = q.permute(0, 2, 1, 3).contiguous()
        ms = time_ms(lambda: pa.paged_attention(q, pk, pv, p_d, bt, scale, sk, sv))
        was = {}
        if pa.split_plan(G, D, BS, MB, pk.dtype) is not None:
            # the single-pass design this path replaced, on the same inputs
            keep, pa.SPLIT_MIN_ROWS = pa.SPLIT_MIN_ROWS, G + 1
            try:
                was["was_ms"] = time_ms(
                    lambda: pa.paged_attention(q, pk, pv, p_d, bt, scale, sk, sv))
            finally:
                pa.SPLIT_MIN_ROWS = keep
        plain_ms = time_ms(lambda: pa.paged_attention_plain(q, pk, pv, p_d, bt, scale, sk, sv))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, keys, vals, attn_mask=mask, scale=scale))
        # least work: the K and V of each position some row of the lane
        # sees, read once (all heads), with its two float32 scales when
        # quantized; q read and out written once; the positions and the
        # live table entries read once; 4*D flops per visible (row, key)
        # pair (scores and weighted sum)
        seen = np.minimum(pos + G, MB * BS)
        last = np.minimum((pos + G - 1) // BS, MB - 1)
        per_pos = 2 * H * D * pk.element_size() + (2 * 4 if sk is not None else 0)
        nbytes = (per_pos * int(seen.sum()) + 2 * B * G * H * D * 4 + 4 * B
                  + 4 * int((last + 1).sum()))
        visible = sum(int(pos[b]) + g + 1 for b in range(B) for g in range(G))
        flops = 4 * D * H * visible
        # q is float32 here, so the products are float32-accurate: 3xTF32
        # over float32 pools; an int8 or e4m3 page is a bfloat16 value, so
        # over those pools three bfloat16 products (q and the weights split
        # in three parts) hold float32's products exactly
        peak_ops = peak_3xtf32 if sk is None else peak_3xbf16
        t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_ops * 1e3
        return {
            "G": G, "context": ctx, "ms": ms, **was, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }

    t_dec = timing(1, 512)
    t_pre = timing(CHUNK, 480)
    emit({"phase": "paged_attention_timing", "decode": t_dec, "prefill": t_pre,
          "peaks": {"bytes_per_s": peak_bw, "f32_3xtf32_flop_per_s": peak_3xtf32},
          "library_call": "scaled_dot_product_attention on K/V pre-gathered at the full "
                          "virtual length (the gather itself not timed)",
          "card": card})

    # --- 2q. paged_attention_quant: int8/fp8 pools against plain, timing ------
    quant_worst = {}  # kv dtype -> max abs err over the float32-q cases
    for kv_dtype in ("int8", "fp8"):
        for q_dtype in (f32, bf16):
            for G in (1, 4, CHUNK):
                pos = np.minimum(
                    BS * rng.integers(0, MB, size=B) + BS // 2 + np.arange(B), MB * BS - G)
                args = quant_case(rng, G, kv_dtype, pos, q_dtype)
                q, pk, pv, sk, sv, p_d, bt = args
                got = pa.paged_attention(q, pk, pv, p_d, bt, None, sk, sv)
                torch.cuda.synchronize()
                want = pa.paged_attention_plain(q, pk, pv, p_d, bt, None, sk, sv)
                err = (got.float() - want.float()).abs()
                name = str(q_dtype).replace("torch.", "")
                atol, rtol = TOL[name]
                ok = bool(torch.isfinite(got.float()).all()) and bool(
                    (err <= atol + rtol * want.float().abs()).all())
                max_err = float(err.max())
                if q_dtype == f32:
                    quant_worst[kv_dtype] = max(quant_worst.get(kv_dtype, 0.0), max_err)
                emit({"phase": "paged_attention_quant", "kv_dtype": kv_dtype, "q_dtype": name,
                      "pool_dtype": str(pk.dtype).replace("torch.", ""), "G": G, "B": B,
                      "H": H, "D": D, "BS": BS, "MB": MB, "positions": pos.tolist(),
                      "max_abs_err": max_err,
                      "rel_err": max_err / float(want.float().abs().max()),
                      "atol": atol, "rtol": rtol, "ok": ok})
                if not ok:
                    raise SystemExit(f"paged_attention_quant {kv_dtype} q {q_dtype} G={G}: "
                                     f"kernel disagrees with the plain version "
                                     f"(max abs err {max_err})")
    # the row-group path's edges: a ragged G, a lane at position 0 (its
    # later splits hold nothing it sees), rows that straddle a split
    # boundary (pages_per_split x BS keys)
    for kv_dtype in ("int8", "fp8"):
        for q_dtype in (f32, bf16):
            for label, G in (("ragged", 20), ("position_0", 20), ("straddle", 20)):
                pos = np.minimum(
                    BS * rng.integers(0, MB, size=B) + BS // 2 + np.arange(B), MB * BS - G)
                plan = pa.split_plan(G, D, BS, MB, torch.int8)
                if label == "position_0":
                    pos[: B // 2] = 0
                if label == "straddle":
                    bound = plan[1] * BS if plan else SPLIT_KEYS
                    pos = np.minimum(bound * (1 + np.arange(B)) - G // 2, MB * BS - G)
                q, pk, pv, sk, sv, p_d, bt = quant_case(rng, G, kv_dtype, pos, q_dtype)
                got = pa.paged_attention(q, pk, pv, p_d, bt, None, sk, sv)
                torch.cuda.synchronize()
                want = pa.paged_attention_plain(q, pk, pv, p_d, bt, None, sk, sv)
                err = (got.float() - want.float()).abs()
                name = str(q_dtype).replace("torch.", "")
                atol, rtol = TOL[name]
                ok = bool(torch.isfinite(got.float()).all()) and bool(
                    (err <= atol + rtol * want.float().abs()).all())
                max_err = float(err.max())
                if q_dtype == f32:
                    quant_worst[kv_dtype] = max(quant_worst[kv_dtype], max_err)
                emit({"phase": "paged_attention_quant", "case": label, "kv_dtype": kv_dtype,
                      "q_dtype": name, "G": G, "plan": plan, "positions": pos.tolist(),
                      "max_abs_err": max_err,
                      "rel_err": max_err / float(want.float().abs().max()),
                      "atol": atol, "rtol": rtol, "ok": ok})
                if not ok:
                    raise SystemExit(f"paged_attention_quant {label} {kv_dtype} q {q_dtype}: "
                                     f"kernel disagrees with the plain version "
                                     f"(max abs err {max_err})")
    t_quant = {kv: {"decode": timing(1, 512, kv), "prefill": timing(CHUNK, 480, kv)}
               for kv in ("int8", "fp8")}
    emit({"phase": "paged_attention_quant_timing", **t_quant,
          "peaks": {"bytes_per_s": peak_bw, "f32_3xbf16_flop_per_s": peak_3xbf16},
          "library_call": "scaled_dot_product_attention on K/V pre-gathered and dequantized "
                          "at the full virtual length (neither timed)",
          "card": card})

    # --- 3. serve: the port's main path --------------------------------------
    def zero_counts():
        pa.LAUNCHES = 0
        pa.LAUNCHES_BY_POOL.clear()
        for kind in fa.LAUNCHES:
            fa.LAUNCHES[kind] = 0

    model = GPTDecoder(seq=SEQ, vocab=VOCAB, seed=SEED, device=dev, **GPT2_SMALL)
    engine_kw = dict(slots=B, block_size=BS, prefill_chunk=CHUNK, sync_every=4, device=dev)
    spec = TrafficSpec(n_requests=16, seed=SEED, prompt_len=(128, 512),
                       max_new=(32, 64), vocab=VOCAB)
    eng = ServeEngine(model, attn="auto", **engine_kw)
    if eng.attn_kernel != "paged":
        raise SystemExit(f"attn='auto' resolved to {eng.attn_kernel!r} on CUDA")
    reqs = synthetic_requests(spec)
    zero_counts()  # every kernel count to 0 just before the main path
    torch.cuda.synchronize()
    rep = eng.run(reqs)
    launches_serve = launches = pa.LAUNCHES
    layers = GPT2_SMALL["num_layers"]
    expect = layers * (rep.decode_steps + rep.prefill_dispatches)
    tokens_ok = all(
        len(r.tokens) == r.max_new_tokens and all(0 <= t < VOCAB for t in r.tokens)
        for r in reqs)
    serve = {
        "phase": "serve", "model": "GPT2_SMALL", "layers": layers, "vocab": VOCAB,
        "seq": SEQ, "dtype": "float32", "traffic": spec.identity,
        "tok_s": rep.tok_s, "wall_s": rep.wall_s, "new_tokens": rep.new_tokens,
        "ttft_p50_ms": rep.ttft_p50_ms, "ttft_p99_ms": rep.ttft_p99_ms,
        "tpot_p50_ms": rep.tpot_p50_ms, "tpot_p99_ms": rep.tpot_p99_ms,
        "host_syncs": rep.host_syncs, "windows": rep.windows,
        "decode_steps": rep.decode_steps, "prefill_dispatches": rep.prefill_dispatches,
        "prefill_chunks": rep.prefill_chunks, "requests_finished": rep.requests_finished,
        "paged_attention_launches": launches, "expected_launches": expect,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }
    emit(serve)
    if not (launches > 0 and launches == expect):
        raise SystemExit(f"paged_attention launches {launches} != {expect}")
    if rep.host_syncs != rep.windows:
        raise SystemExit(f"host_syncs {rep.host_syncs} != windows {rep.windows}")
    if rep.requests_finished != spec.n_requests or not tokens_ok:
        raise SystemExit("serve: not every request finished with in-vocab tokens")

    # the same requests on the plain gather path
    eng_g = ServeEngine(model, attn="gather", **engine_kw)
    reqs_g = synthetic_requests(spec)
    launches0 = pa.LAUNCHES
    rep_g = eng_g.run(reqs_g)
    if pa.LAUNCHES != launches0:
        raise SystemExit("attn='gather' launched the kernel")
    def compare_streams(reqs_a, reqs_b):
        """(streams equal, the first divergence {request, token, a, b})."""
        same, first_div = 0, None
        for a, g in zip(reqs_a, reqs_b):
            if a.tokens == g.tokens:
                same += 1
            elif first_div is None:
                k = next(i for i, (x, y) in enumerate(zip(a.tokens, g.tokens)) if x != y)
                first_div = {"request": a.id, "token": k, "a": a.tokens[k], "b": g.tokens[k]}
        return same, first_div

    same, first_div = compare_streams(reqs, reqs_g)

    def programs_agree(engines):
        """Both engines' programs on identical inputs: a prefill chunk of
        every lane, then one decode step; next-token distributions
        compared."""
        toks = np.stack([r.prompt[:CHUNK] for r in synthetic_requests(spec)[:B]])
        toks = toks.astype(np.int32)
        bt = (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB)
        start = np.zeros(B, np.int32)
        n_valid = np.full(B, CHUNK, np.int32)
        probs, nxts = [], []
        for e in engines:
            nxt, p = e._prefill(*e._to_device("prefill", toks, start, n_valid, bt))
            nxt2, p2 = e._decode(*e._to_device("decode", nxt.cpu().numpy(), n_valid, bt))
            probs.append(torch.cat([p, p2]))
            nxts.append(torch.cat([nxt, nxt2]))
        torch.cuda.synchronize()
        prob_err = float((probs[0] - probs[1]).abs().max())
        return {"program_probs_max_abs_err": prob_err,
                "program_probs_rel_err": prob_err / float(probs[1].abs().max()),
                "program_argmax_agree": bool(torch.equal(nxts[0], nxts[1]))}

    agree = programs_agree((eng, eng_g))
    emit({"phase": "serve_gather", "tok_s": rep_g.tok_s, "wall_s": rep_g.wall_s,
          "host_syncs": rep_g.host_syncs, "windows": rep_g.windows,
          "streams_identical": same, "requests": len(reqs), "first_divergence": first_div,
          **agree, "card": card})
    if not agree["program_probs_rel_err"] <= 1e-3:
        raise SystemExit(f"paged and gather programs disagree: {agree}")

    # --- profile: where a serve run's time goes (a separate run) -------------
    prof_spec = TrafficSpec(n_requests=8, seed=SEED + 1, prompt_len=(128, 512),
                            max_new=(32, 64), vocab=VOCAB)
    prof_reqs = synthetic_requests(prof_spec)
    prof = device_profile(lambda: eng.run(prof_reqs))
    prof_rep = prof.pop("result")
    emit({"phase": "profile", "traffic": prof_spec.identity, **prof,
          "windows": prof_rep.windows, "decode_steps": prof_rep.decode_steps,
          "prefill_dispatches": prof_rep.prefill_dispatches, "card": card})
    del eng, eng_g
    torch.cuda.empty_cache()

    # --- 3q. serve_quant / serve_spec / serve_w8: the quantized arms ---------
    def serve_arm(phase, record_margins=False, **arm):
        """Serve ``spec``'s requests on a fresh engine with ``arm``; every
        kernel count set to 0 just before the run and read just after.
        Fails unless every request finished with its full budget and the
        window held one host sync."""
        e = ServeEngine(model, **engine_kw, **arm)
        rs = synthetic_requests(spec)
        margins = record_margins and margin_recorder(e)
        zero_counts()
        torch.cuda.synchronize()
        r = e.run(rs)
        launches, by_pool = pa.LAUNCHES, dict(pa.LAUNCHES_BY_POOL)
        full = all(len(q.tokens) == q.max_new_tokens and all(0 <= t < VOCAB for t in q.tokens)
                   for q in rs)
        line = {"phase": phase, "model": "GPT2_SMALL", "layers": layers, "dtype": "float32",
                "traffic": spec.identity, "attn_kernel": e.attn_kernel,
                "kv_dtype": e.kv_dtype, "weight_dtype": e.weight_dtype,
                "kv_bytes_per_token": e.kv.bytes_per_token,
                "tok_s": r.tok_s, "wall_s": r.wall_s, "new_tokens": r.new_tokens,
                "ttft_p50_ms": r.ttft_p50_ms, "tpot_p50_ms": r.tpot_p50_ms,
                "tpot_p99_ms": r.tpot_p99_ms, "host_syncs": r.host_syncs, "windows": r.windows,
                "decode_steps": r.decode_steps, "prefill_dispatches": r.prefill_dispatches,
                "requests_finished": r.requests_finished, "full_budgets": full,
                "paged_attention_launches": launches, "launches_by_pool": by_pool}
        if not (full and r.requests_finished == spec.n_requests):
            raise SystemExit(f"{phase}: not every request finished with its full budget")
        if r.host_syncs != r.windows:
            raise SystemExit(f"{phase}: host_syncs {r.host_syncs} != windows {r.windows}")
        return e, rs, r, line, (margins or None)

    def margin_recorder(e):
        """Keep, for each decode and prefill call of ``e``, the relative
        top-2 margin (p1 - p2) / p1 of every lane's next-token
        distribution (on the device, read after the run) with the lane's
        request and the index of the token it yields."""
        calls = []
        decode, prefill = e._decode, e._prefill

        def top2(probs):
            t = probs.topk(2, dim=-1).values
            return (t[:, 0] - t[:, 1]) / t[:, 0]

        def lanes():
            return {s: (r.id, r.prompt_len) for s, r in e.sched.active.items()}

        def rec_decode(tok, pos, bt):
            nxt, probs = decode(tok, pos, bt)
            calls.append((lanes(), pos + 1, top2(probs)))  # the token at pos + 1
            return nxt, probs

        def rec_prefill(toks, start, n_valid, bt):
            nxt, probs = prefill(toks, start, n_valid, bt)
            calls.append((lanes(), start + n_valid, top2(probs)))
            return nxt, probs

        e._decode, e._prefill = rec_decode, rec_prefill
        return calls

    def margins_by_request(calls):
        """{request id: {token index: relative top-2 margin}}."""
        out = {}
        for lane_req, at, m in calls:
            at, m = at.cpu().numpy(), m.cpu().numpy()
            for s, (rid, plen) in lane_req.items():
                out.setdefault(rid, {})[int(at[s]) - plen] = float(m[s])
        return out

    quant_lines, quant_launches, quant_reqs = {}, {}, {}
    for kv_dtype in ("int8", "fp8"):
        e_q, rs_q, r_q, line, _ = serve_arm("serve_quant", kv_dtype=kv_dtype)
        expect = layers * (r_q.decode_steps + r_q.prefill_dispatches)
        pool_name = str(e_q.kv.dtype).replace("torch.", "")
        line["expected_launches"] = expect
        if not (line["paged_attention_launches"] == expect > 0
                and line["launches_by_pool"] == {pool_name: expect}):
            raise SystemExit(f"serve_quant {kv_dtype}: launches {line['launches_by_pool']} "
                             f"!= {{{pool_name!r}: {expect}}}")
        e_g, rs_g, r_g, _, _ = serve_arm("serve_quant_gather", attn="gather", kv_dtype=kv_dtype)
        if pa.LAUNCHES:
            raise SystemExit(f"serve_quant {kv_dtype}: attn='gather' launched the kernel")
        same_q, div_q = compare_streams(rs_q, rs_g)
        agree_q = programs_agree((e_q, e_g))
        line.update({"gather_tok_s": r_g.tok_s, "streams_identical_to_gather": same_q,
                     "first_divergence_from_gather": div_q, **agree_q,
                     "program_probs_rel_tol": QUANT_PROB_TOL, "card": card})
        emit(line)
        if not agree_q["program_probs_rel_err"] <= QUANT_PROB_TOL:
            raise SystemExit(f"serve_quant {kv_dtype}: paged and gather programs disagree: "
                             f"{agree_q}")
        quant_lines[kv_dtype], quant_launches[kv_dtype] = line, expect
        quant_reqs[kv_dtype] = rs_q
        del e_q, e_g
        torch.cuda.empty_cache()

    # speculative decoding over int8 pools, against the plain int8 greedy
    # streams (a second plain run, its margins recorded)
    e_p, rs_p, _, _, calls = serve_arm("serve_spec_reference", record_margins=True,
                                       kv_dtype="int8")
    margins = margins_by_request(calls)
    del e_p
    e_s, rs_s, r_s, line, _ = serve_arm("serve_spec", kv_dtype="int8", spec_k=SPEC_K,
                                        spec_draft_layers=SPEC_DRAFT)
    W = SPEC_K + 1
    macros = r_s.decode_steps // W
    expect = layers * (r_s.prefill_dispatches + macros) + SPEC_DRAFT * SPEC_K * macros
    diverged = []
    for a, p_ in zip(rs_s, rs_p):
        k = next((i for i, (x, y) in enumerate(zip(a.tokens, p_.tokens)) if x != y), None)
        if k is None:
            continue
        m = margins.get(p_.id, {})
        small = min((i for i in range(k + 1) if m.get(i, 1.0) < SPEC_MARGIN), default=None)
        diverged.append({"request": a.id, "token": k, "margin_there": m.get(k),
                         "first_small_margin_token": small,
                         "min_margin_up_to_there": min(m.get(i, 1.0) for i in range(k + 1))})
    ok_streams = all(d["first_small_margin_token"] is not None for d in diverged)
    line.update({"spec_k": r_s.spec_k, "spec_draft_layers": r_s.spec_draft_layers,
                 "spec_accept_rate": r_s.spec_accept_rate, "spec_drafted": r_s.spec_drafted,
                 "spec_accepted": r_s.spec_accepted, "macros": macros,
                 "expected_launches": expect,
                 "streams_identical_to_plain_int8": len(rs_s) - len(diverged),
                 "diverged": diverged, "margin_threshold_rel": SPEC_MARGIN,
                 "reference_streams_equal_to_serve_quant_int8": compare_streams(
                     rs_p, quant_reqs["int8"])[0],
                 "card": card})
    emit(line)
    if not (line["paged_attention_launches"] == expect > 0
            and line["launches_by_pool"] == {"int8": expect}):
        raise SystemExit(f"serve_spec: launches {line['launches_by_pool']} != {expect}")
    if not ok_streams:
        raise SystemExit(f"serve_spec: streams left the plain int8 greedy stream before a "
                         f"token whose top-2 margin is under {SPEC_MARGIN}: {diverged}")
    spec_launches = expect
    del e_s
    torch.cuda.empty_cache()

    # where an int8 serve run's time goes: the profile phase's traffic
    e_pq = ServeEngine(model, kv_dtype="int8", **engine_kw)
    profq = device_profile(lambda: e_pq.run(synthetic_requests(prof_spec)))
    profq_rep = profq.pop("result")
    emit({"phase": "profile_quant", "kv_dtype": "int8", "traffic": prof_spec.identity, **profq,
          "windows": profq_rep.windows, "decode_steps": profq_rep.decode_steps,
          "prefill_dispatches": profq_rep.prefill_dispatches, "card": card})
    del e_pq

    e_w, rs_w, r_w, line, _ = serve_arm("serve_w8", kv_dtype="int8", weight_dtype="int8")
    expect = layers * (r_w.decode_steps + r_w.prefill_dispatches)
    same_w, _ = compare_streams(rs_w, rs_p)
    line.update({"expected_launches": expect, "fp32_tok_s": serve["tok_s"],
                 "int8_kv_tok_s": quant_lines["int8"]["tok_s"],
                 "streams_identical_to_int8_kv": same_w, "card": card})
    emit(line)
    if line["paged_attention_launches"] != expect:
        raise SystemExit(f"serve_w8: launches {line['paged_attention_launches']} != {expect}")
    del e_w
    torch.cuda.empty_cache()

    # --- 4. flash_attention: kernels against plain, then timing --------------
    def qkv(shape_q, shape_k, dtype, seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        q, k, v, do = (torch.randn(s, generator=g).to(dev, dtype)
                       for s in (shape_q, shape_k, shape_k, shape_q))
        return q, k, v, do

    def rel(a, b, mask=None):
        a, b = a.float(), b.float()
        if mask is not None:
            a, b = a[mask], b[mask]
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    flash_worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}  # float32 max abs errors

    def flash_case(name, B_, H_, sq, sk, D_, dtype, causal, rate=0.0, seed=0, v_eye=False):
        q, k, v, do = qkv((B_, H_, sq, D_), (B_, H_, sk, D_), dtype, SEED + sq + sk + D_)
        if v_eye:  # the output is the dropped probabilities themselves
            v = torch.eye(sk, device=dev, dtype=dtype).expand(B_, H_, sk, sk).contiguous()
        args = (causal, rate, seed)
        out, lse = fa.flash_fwd(q, k, v, *args)
        delta = fa.flash_delta(out, do)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()
        p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, *args)
        p_delta = fa.flash_delta(p_out, do)
        p_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, p_lse, p_delta, *args)
        p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, p_lse, p_delta, *args)
        # rows that see a key (all but the first sq - sk when causal, sq > sk)
        live = torch.ones(B_ * H_, sq, dtype=torch.bool, device=dev)
        if causal and sq > sk:
            live[:, : sq - sk] = False
        dname = str(dtype).replace("torch.", "")
        errs = {"o": rel(out, p_out), "lse": rel(lse, p_lse, live), "dq": rel(dq, p_dq),
                "dk": rel(dk, p_dk), "dv": rel(dv, p_dv)}
        tol_f, tol_b = FLASH_TOL[(dname, "fwd")], FLASH_TOL[(dname, "bwd")]
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, dq, dk, dv))
        ok = finite and errs["o"] <= tol_f and errs["lse"] <= tol_f and all(
            errs[n] <= tol_b for n in ("dq", "dk", "dv"))
        line = {"phase": "flash_attention", "case": name, "B": B_, "H": H_, "Sq": sq, "Sk": sk,
                "D": D_, "dtype": dname, "causal": causal, "dropout": rate, "seed": seed,
                "rel_err": errs, "tol_fwd": tol_f, "tol_bwd": tol_b,
                "max_abs_err_o": float((out.float() - p_out.float()).abs().max())}
        if causal and sq > sk:
            dead = out.reshape(B_ * H_, sq, D_)[:, : sq - sk]
            line["masked_rows_zero"] = bool((dead == 0).all())
            line["masked_rows_lse_max"] = float(lse[~live].max())
            ok = ok and line["masked_rows_zero"] and line["masked_rows_lse_max"] <= -1e29
        if v_eye:
            line["same_zeros"] = bool(torch.equal(out == 0, p_out == 0))
            line["dropped_share"] = float((out == 0).float().mean())
            ok = ok and line["same_zeros"]
        line["ok"] = ok
        emit(line)
        if not ok:
            raise SystemExit(f"flash_attention case {name}: kernels disagree with the plain "
                             f"versions: {line}")
        if dtype == torch.float32:
            for kind, pairs in (("fwd", ((out, p_out),)), ("dq", ((dq, p_dq),)),
                                ("dkv", ((dk, p_dk), (dv, p_dv)))):
                for a, b in pairs:
                    flash_worst[kind] = max(flash_worst[kind], float((a - b).abs().max()))

    f32, bf16 = torch.float32, torch.bfloat16
    TH, TD = BERT_BASE["heads"], BERT_BASE["hidden"] // BERT_BASE["heads"]
    flash_case("slice", TRAIN_B, TH, TRAIN_S, TRAIN_S, TD, f32, False)
    flash_case("slice", TRAIN_B, TH, TRAIN_S, TRAIN_S, TD, bf16, False)
    flash_case("causal_cross", 2, TH, 128, 256, TD, f32, True)
    flash_case("causal_tiled_2048", 2, TH, 2048, 2048, TD, f32, True)
    flash_case("dropout", TRAIN_B, TH, TRAIN_S, TRAIN_S, TD, f32, False, 0.1, 1234)
    flash_case("dropout_mask", 2, TH, 512, 128, 128, f32, False, 0.1, 1234, v_eye=True)
    flash_case("dropout_causal_bf16", 2, 4, 512, 512, 128, bf16, True, 0.1, -7)
    flash_case("no_visible_key", 2, 4, 384, 256, TD, f32, True)
    # the bfloat16 forward's masked and tiled paths
    flash_case("causal_cross", 2, TH, 128, 256, TD, bf16, True)
    flash_case("causal_tiled_2048", 2, TH, 2048, 2048, TD, bf16, True)
    flash_case("no_visible_key", 2, 4, 384, 256, TD, bf16, True)
    # the bfloat16 backward at D 128, and its dropout path at D 64
    flash_case("slice_d128", 2, TH, 512, 512, 128, bf16, False)
    flash_case("dropout_d64", 2, TH, 512, 512, TD, bf16, False, 0.1, 1234)
    # the float32 backward's D 128 kernels, and their mask and dropout together
    flash_case("slice_d128", 2, TH, 512, 512, 128, f32, False)
    flash_case("dropout_causal", 2, 4, 512, 512, 128, f32, True, 0.1, -7)

    def flash_bound(kind, dtype):
        """Least time for one kernel's work at the slice's shape: each
        input read once and each output written once, or its matmul flops
        (4 / 6 / 8 x D per (row, key) pair) at the card's peak for the
        input type (float32: 3xTF32), whichever is larger."""
        esize = 4 if dtype == f32 else 2
        bh, s_, d_ = TRAIN_B * TH, TRAIN_S, TD
        mat = bh * s_ * d_ * esize  # one (B, H, S, D) tensor
        rows = bh * s_ * 4  # one float32 (B * H, S) row vector
        nbytes = {"fwd": 4 * mat + rows, "dq": 5 * mat + 2 * rows,
                  "dkv": 6 * mat + 2 * rows}[kind]
        flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d_ * bh * s_ * s_
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = flops / (peak_3xtf32 if dtype == f32 else peak_bf16) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}

    def flash_timing(dtype):
        q, k, v, do = qkv((TRAIN_B, TH, TRAIN_S, TD), (TRAIN_B, TH, TRAIN_S, TD), dtype, SEED)
        out, lse = fa.flash_fwd(q, k, v)
        delta = fa.flash_delta(out, do)
        bwd_args = (q, k, v, do, lse, delta)
        res = {
            "fwd": {"ms": time_ms(lambda: fa.flash_fwd(q, k, v)),
                    "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v))},
        }
        res.update({
            "dq": {"ms": time_ms(lambda: fa.flash_bwd_dq(*bwd_args)),
                   "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dq_plain(*bwd_args))},
            "dkv": {"ms": time_ms(lambda: fa.flash_bwd_dkv(*bwd_args)),
                    "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_plain(*bwd_args))},
        })
        # the first designs, which the redesigns replaced (the float32
        # forward has one design)
        if dtype == bf16:
            res["fwd"]["was_ms"] = time_ms(lambda: fa.flash_fwd(q, k, v, first_design=True))
        res["dq"]["was_ms"] = time_ms(lambda: fa.flash_bwd_dq(*bwd_args, first_design=True))
        res["dkv"]["was_ms"] = time_ms(lambda: fa.flash_bwd_dkv(*bwd_args, first_design=True))
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(lq.detach(), lk.detach(),
                                                                 lv.detach()))
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                                      retain_graph=True))
        for kind in res:
            res[kind].update(flash_bound(kind, dtype))
            res[kind]["library_ms"] = lib_fwd if kind == "fwd" else lib_bwd
            res[kind]["launches_per_train_step"] = BERT_BASE["num_layers"]
        return res

    flash_t = {"float32": flash_timing(f32), "bfloat16": flash_timing(bf16)}
    emit({"phase": "flash_attention_timing", "B": TRAIN_B, "H": TH, "S": TRAIN_S, "D": TD,
          "causal": False, "dropout": 0.0, **flash_t,
          "peaks": {"bytes_per_s": peak_bw, "f32_3xtf32_flop_per_s": peak_3xtf32,
                    "bf16_flop_per_s": peak_bf16},
          "library_call": "scaled_dot_product_attention forward; the dq and dkv rows carry "
                          "its autograd backward (dQ, dK and dV together)",
          "card": card})

    # --- 5. train: the training slice's main path ----------------------------
    layers = BERT_BASE["num_layers"]
    train_cfg = dict(batch=TRAIN_B, seq=TRAIN_S, num_classes=TRAIN_CLASSES, lr=TRAIN_LR,
                     seed=SEED, device=dev, **BERT_BASE)
    x, y = make_batch(TRAIN_B, TRAIN_S, BERT_BASE["hidden"], TRAIN_CLASSES, SEED)
    train_launches = {}
    traced = {}  # (compute dtype, core): the model whose steps train_profile traces
    for cdt in ("float32", "bfloat16"):
        model = build_model(compute_dtype=cdt, use_flash=True, **train_cfg)
        plain = build_model(compute_dtype=cdt, use_flash=False, **train_cfg)
        plain.set_weights(model.get_weights())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()  # every kernel count to 0 just before the main path
        res = run(model, x, y, TRAIN_STEPS)
        launches = dict(fa.LAUNCHES)
        paged_during = pa.LAUNCHES
        peak_mem = torch.cuda.max_memory_allocated()
        res_plain = run(plain, x, y, TRAIN_STEPS)
        if dict(fa.LAUNCHES) != launches:
            raise SystemExit("train: use_flash=False launched a flash kernel")
        wa, wb = model.get_weights(), plain.get_weights()
        w_diff = max(float(np.abs(wa[ln][wn] - wb[ln][wn]).max()) for ln in wa for wn in wa[ln])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], res_plain["losses"]))
        expect = layers * TRAIN_STEPS
        finite = all(math.isfinite(v) for v in res["losses"] + res_plain["losses"])
        ok = (finite and all(n == expect for n in launches.values()) and paged_during == 0
              and loss_rel <= TRAIN_LOSS_TOL[cdt])
        emit({"phase": "train", "model": "BERT_BASE", **BERT_BASE, "batch": TRAIN_B,
              "seq": TRAIN_S, "classes": TRAIN_CLASSES, "compute_dtype": cdt,
              "optimizer": f"Adam({TRAIN_LR})", "steps": TRAIN_STEPS, "losses": res["losses"],
              "samples_per_s": res["samples_per_s"], "step_ms_median": res["step_ms_median"],
              "step_ms": res["step_ms"], "peak_mem_bytes": peak_mem,
              "parameters": model.num_parameters(), "flash_launches": launches,
              "expected_launches_each": expect, "paged_launches": paged_during,
              "sdpa_losses": res_plain["losses"],
              "sdpa_samples_per_s": res_plain["samples_per_s"],
              "sdpa_step_ms_median": res_plain["step_ms_median"],
              "loss_rel_err_vs_sdpa": loss_rel, "loss_tol": TRAIN_LOSS_TOL[cdt],
              "max_weight_diff_vs_sdpa": w_diff, "ok": ok, "card": card})
        if not ok:
            raise SystemExit(f"train {cdt}: launches {launches} (expected {expect} each), "
                             f"loss rel err vs sdpa {loss_rel}, finite {finite}")
        train_launches[cdt] = launches
        traced[(cdt, "flash")] = model
        if cdt == "bfloat16":
            traced[(cdt, "sdpa")] = plain
        del model, plain
        torch.cuda.empty_cache()

    # --- train_profile: 3 more steps of each traced model ----------------------
    for (cdt, core), model in traced.items():
        ex = model.executor
        xs, ys = ex.place(x), ex.place(y)
        tprof = device_profile(lambda: [ex.train_step([xs], ys) for _ in range(3)])
        tprof.pop("result")
        emit({"phase": "train_profile", "compute_dtype": cdt, "core": core, "steps": 3,
              **tprof, "card": card})
    del traced

    # --- 6. kernels -----------------------------------------------------------
    src = "flexflow_tpu_torch/ops/cuda/csrc/"
    tpu = "flexflow_tpu/ops/pallas/"
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": src + "paged_attention.cu",
        "replaces": tpu + "paged_attention.py:122",
        "launches": launches_serve,
        "max_abs_err": worst,
        "ms": t_dec["ms"],
        "plain_ms": t_dec["plain_ms"],
        "bound_ms": t_dec["bound_ms"],
        "bound_by": t_dec["bound_by"],
        "library_ms": t_dec["library_ms"],
        "prefill": {k: t_pre[k] for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }]
    for kind, name, replaces in (
            ("fwd", "flash_fwd", tpu + "flash_attention.py:177"),
            ("dq", "flash_bwd_dq", tpu + "flash_attention.py:407"),
            ("dkv", "flash_bwd_dkv", tpu + "flash_attention.py:460")):
        t32, t16 = flash_t["float32"][kind], flash_t["bfloat16"][kind]
        entry = {"name": name, "route": "cuda", "source": src + "flash_attention.cu",
                 "replaces": replaces, "launches": train_launches["float32"][kind],
                 "max_abs_err": flash_worst[kind],
                 **{k: t32[k] for k in ("ms", "was_ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms") if k in t32},
                 "bfloat16": {**{k: t16[k] for k in ("ms", "was_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms") if k in t16},
                              "launches": train_launches["bfloat16"][kind]}}
        if kind == "fwd":
            entry["also_replaces"] = tpu + "flash_attention.py:98"
        kernels.append(entry)
    def timed(t):
        return {k: t[k] for k in ("ms", "was_ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms") if k in t}

    kernels.append({
        "name": "paged_attention_quant",
        "route": "cuda",
        "source": src + "paged_attention.cu",
        "replaces": tpu + "paged_attention.py:158",
        "also_replaces": tpu + "paged_attention.py:215",
        "launches": quant_launches["int8"],
        "max_abs_err": quant_worst["int8"],
        **timed(t_quant["int8"]["decode"]),
        "prefill": timed(t_quant["int8"]["prefill"]),
        "fp8": {"launches": quant_launches["fp8"], "max_abs_err": quant_worst["fp8"],
                **timed(t_quant["fp8"]["decode"]), "prefill": timed(t_quant["fp8"]["prefill"])},
        "spec_launches": spec_launches,
    })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def device_profile(fn, top=10, host_top=0) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall time, the union of device
    intervals (busy time), the idle share, and the ``top`` kernels with the
    most device time (all of them for None); with ``host_top``, that many
    host operations with the most self time on the host as well.
    ``result`` is what ``fn`` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t_p) * 1e6
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t_a, t_b = evt.time_range.start, evt.time_range.end
            spans.append((t_a, t_b))
            tot, cnt = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (tot + (t_b - t_a), cnt + 1)
    busy, end = 0.0, float("-inf")
    for t_a, t_b in sorted(spans):  # union of device intervals
        if t_b > end:
            busy += t_b - max(t_a, end)
            end = t_b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    host = {}
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_top]
        host["top_host_ops_us"] = [{"name": a.key[:80], "self_us": a.self_cpu_time_total,
                                    "count": a.count} for a in ops]
    return {**host,"wall_us": wall_us, "device_busy_us": busy if spans else None,
            "device_idle_share": 1.0 - busy / wall_us if spans else None,
            "device_events": len(spans),
            "top_kernels_us": [{"name": n[:80], "total_us": t, "count": c}
                               for n, (t, c) in top],
            "result": result}


if __name__ == "__main__":
    sys.exit(main())
