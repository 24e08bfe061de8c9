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
4. ``flash_attention``: the three flash kernels (forward, dQ, dK/dV)
   against their plain versions at the training slice's shape (B 16,
   H 12, S 512, D 64, float32 and bfloat16), causal with Sq 128 / Sk 256,
   causal at S 2048, dropout 0.1 with a fixed seed (and a case whose V is
   the identity, so the output shows the dropped probabilities: the
   zeros must fall on the same places), and rows with no visible key
   (output exactly 0).  Tolerances, relative to max |reference|: float32
   2e-5 forward, 1e-4 backward (the kernels sum tile by tile, the plain
   versions over whole rows); bfloat16 2e-2 (both round the same float32
   values to bfloat16, at different places for the probabilities).
   ``flash_attention_timing`` times each kernel at the slice's shape
   beside its bound, the plain version and
   ``scaled_dot_product_attention`` (forward, and its autograd backward
   for dQ + dK + dV).
5. ``train``: the training slice's main path, BERT-Base (hidden 768,
   12 heads, ff 3072, 12 layers) on (16, 512, 768) inputs with a 64-class
   pooled head, Adam(1e-4), sparse CCE, 5 steps on one seeded batch, in
   float32 and in bfloat16 compute.  The flash launch counts are set to 0
   just before each run and must equal 12 x 5 per kernel after it.  The
   same model from the same weights then trains with ``use_flash=False``
   (the plain ``sdpa`` core): the loss curves must agree within 1e-4
   relative (float32) or 2e-2 (bfloat16).  ``train_profile`` traces 3
   more float32 steps: device time by kernel and the idle share.
6. ``kernels``: one line ``{"kernels": [...]}`` with each kernel's
   route, source, the TPU kernel it replaces, launches on the main path,
   error against the plain version, times and bound.

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
# published peaks of the cards the port runs on (NVIDIA data sheet,
# dense): HBM bytes/s, float32 non-tensor flop/s (the float32 kernels do
# their arithmetic on CUDA cores) and bfloat16 tensor-core flop/s (the
# bound of work done on bfloat16 inputs)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12, 989e12),  # H100 SXM5
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
    if name not in PEAKS:
        raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}; add them to PEAKS")
    return PEAKS[name]


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    peak_bw, peak_f32, peak_bf16 = peaks(torch.cuda.get_device_name(0))

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
        50 MB L2 would otherwise hold the pages between launches)."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush_buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    def timing(G, ctx):
        """The kernel at the serve phase's shapes: 8 lanes whose row 0 sits
        at ``ctx`` (float32 pool)."""
        pos = np.full(B, ctx, np.int64)
        q, pk, pv, p_d, bt = case(np.random.default_rng(SEED + G), G, torch.float32, pos)
        scale = 1.0 / math.sqrt(D)
        keys = pk[bt.long()].permute(0, 2, 1, 3, 4).reshape(B, H, MB * BS, D)
        vals = pv[bt.long()].permute(0, 2, 1, 3, 4).reshape(B, H, MB * BS, D)
        k_pos = torch.arange(MB * BS, device=dev)
        rows = p_d.long()[:, None] + torch.arange(G, device=dev)
        mask = (k_pos[None, None, :] <= rows[:, :, None])[:, None]  # (B, 1, G, SV)
        qh = q.permute(0, 2, 1, 3).contiguous()
        ms = time_ms(lambda: pa.paged_attention(q, pk, pv, p_d, bt, scale))
        plain_ms = time_ms(lambda: pa.paged_attention_plain(q, pk, pv, p_d, bt, scale))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, keys, vals, attn_mask=mask, scale=scale))
        # least work: the K and V of each position some row of the lane
        # sees, read once (all heads); q read and out written once; the
        # positions and the live table entries read once; 4*D flops per
        # visible (row, key) pair (scores and weighted sum)
        seen = np.minimum(pos + G, MB * BS)
        last = np.minimum((pos + G - 1) // BS, MB - 1)
        nbytes = (2 * H * D * 4 * int(seen.sum()) + 2 * B * G * H * D * 4 + 4 * B
                  + 4 * int((last + 1).sum()))
        visible = sum(int(pos[b]) + g + 1 for b in range(B) for g in range(G))
        flops = 4 * D * H * visible
        t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_f32 * 1e3
        return {
            "G": G, "context": ctx, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }

    t_dec = timing(1, 512)
    t_pre = timing(CHUNK, 480)
    emit({"phase": "paged_attention_timing", "decode": t_dec, "prefill": t_pre,
          "peaks": {"bytes_per_s": peak_bw, "f32_flop_per_s": peak_f32},
          "library_call": "scaled_dot_product_attention on K/V pre-gathered at the full "
                          "virtual length (the gather itself not timed)",
          "card": card})

    # --- 3. serve: the port's main path --------------------------------------
    model = GPTDecoder(seq=SEQ, vocab=VOCAB, seed=SEED, device=dev, **GPT2_SMALL)
    engine_kw = dict(slots=B, block_size=BS, prefill_chunk=CHUNK, sync_every=4, device=dev)
    spec = TrafficSpec(n_requests=16, seed=SEED, prompt_len=(128, 512),
                       max_new=(32, 64), vocab=VOCAB)
    eng = ServeEngine(model, attn="auto", **engine_kw)
    if eng.attn_kernel != "paged":
        raise SystemExit(f"attn='auto' resolved to {eng.attn_kernel!r} on CUDA")
    reqs = synthetic_requests(spec)
    pa.LAUNCHES = 0  # every kernel count to 0 just before the main path
    for kind in fa.LAUNCHES:
        fa.LAUNCHES[kind] = 0
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
    same, first_div = 0, None
    for a, g in zip(reqs, reqs_g):
        if a.tokens == g.tokens:
            same += 1
        elif first_div is None:
            k = next(i for i, (x, y) in enumerate(zip(a.tokens, g.tokens)) if x != y)
            first_div = {"request": a.id, "token": k, "paged": a.tokens[k],
                         "gather": g.tokens[k]}

    # both programs on identical inputs: a prefill chunk of every lane,
    # then one decode step; next-token distributions compared
    toks = np.stack([r.prompt[:CHUNK] for r in reqs[:B]]).astype(np.int32)
    bt = (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB)
    start = np.zeros(B, np.int32)
    n_valid = np.full(B, CHUNK, np.int32)
    probs, nxts = [], []
    for e in (eng, eng_g):
        nxt, p = e._prefill(*e._to_device("prefill", toks, start, n_valid, bt))
        nxt2, p2 = e._decode(*e._to_device("decode", nxt.cpu().numpy(), n_valid, bt))
        probs.append(torch.cat([p, p2]))
        nxts.append(torch.cat([nxt, nxt2]))
    torch.cuda.synchronize()
    prob_err = float((probs[0] - probs[1]).abs().max())
    prob_rel = prob_err / float(probs[1].abs().max())
    emit({"phase": "serve_gather", "tok_s": rep_g.tok_s, "wall_s": rep_g.wall_s,
          "host_syncs": rep_g.host_syncs, "windows": rep_g.windows,
          "streams_identical": same, "requests": len(reqs), "first_divergence": first_div,
          "program_probs_max_abs_err": prob_err, "program_probs_rel_err": prob_rel,
          "program_argmax_agree": bool(torch.equal(nxts[0], nxts[1])), "card": card})
    if not prob_rel <= 1e-3:
        raise SystemExit(f"paged and gather programs disagree: rel err {prob_rel}")

    # --- profile: where a serve run's time goes (a separate run) -------------
    prof_spec = TrafficSpec(n_requests=8, seed=SEED + 1, prompt_len=(128, 512),
                            max_new=(32, 64), vocab=VOCAB)
    prof_reqs = synthetic_requests(prof_spec)
    prof = device_profile(lambda: eng.run(prof_reqs))
    prof_rep = prof.pop("result")
    emit({"phase": "profile", "traffic": prof_spec.identity, **prof,
          "windows": prof_rep.windows, "decode_steps": prof_rep.decode_steps,
          "prefill_dispatches": prof_rep.prefill_dispatches, "card": card})

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

    def flash_bound(kind, dtype):
        """Least time for one kernel's work at the slice's shape: each
        input read once and each output written once, or its matmul flops
        (4 / 6 / 8 x D per (row, key) pair) at the card's peak for the
        input type, whichever is larger."""
        esize = 4 if dtype == f32 else 2
        bh, s_, d_ = TRAIN_B * TH, TRAIN_S, TD
        mat = bh * s_ * d_ * esize  # one (B, H, S, D) tensor
        rows = bh * s_ * 4  # one float32 (B * H, S) row vector
        nbytes = {"fwd": 4 * mat + rows, "dq": 5 * mat + 2 * rows,
                  "dkv": 6 * mat + 2 * rows}[kind]
        flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d_ * bh * s_ * s_
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = flops / (peak_f32 if dtype == f32 else peak_bf16) * 1e3
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
            "dq": {"ms": time_ms(lambda: fa.flash_bwd_dq(*bwd_args)),
                   "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dq_plain(*bwd_args))},
            "dkv": {"ms": time_ms(lambda: fa.flash_bwd_dkv(*bwd_args)),
                    "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_plain(*bwd_args))},
        }
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
          "peaks": {"bytes_per_s": peak_bw, "f32_flop_per_s": peak_f32,
                    "bf16_flop_per_s": peak_bf16},
          "library_call": "scaled_dot_product_attention forward; the dq and dkv rows carry "
                          "its autograd backward (dQ, dK and dV together)",
          "card": card})

    # --- 5. train: the training slice's main path ----------------------------
    def zero_counts():
        pa.LAUNCHES = 0
        for kind in fa.LAUNCHES:
            fa.LAUNCHES[kind] = 0

    layers = BERT_BASE["num_layers"]
    train_cfg = dict(batch=TRAIN_B, seq=TRAIN_S, num_classes=TRAIN_CLASSES, lr=TRAIN_LR,
                     seed=SEED, device=dev, **BERT_BASE)
    x, y = make_batch(TRAIN_B, TRAIN_S, BERT_BASE["hidden"], TRAIN_CLASSES, SEED)
    train_launches = {}
    main_model = None
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
        del plain
        if cdt == "float32":
            main_model = model
        else:
            del model
        torch.cuda.empty_cache()

    # --- train_profile: 3 more float32 steps, traced --------------------------
    ex = main_model.executor
    xs, ys = ex.place(x), ex.place(y)
    tprof = device_profile(lambda: [ex.train_step([xs], ys) for _ in range(3)])
    tprof.pop("result")
    emit({"phase": "train_profile", "compute_dtype": "float32", "steps": 3, **tprof,
          "card": card})

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
                 **{k: t32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                 "bfloat16": {**{k: t16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")},
                              "launches": train_launches["bfloat16"][kind]}}
        if kind == "fwd":
            entry["also_replaces"] = tpu + "flash_attention.py:98"
        kernels.append(entry)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall time, the union of device
    intervals (busy time), the idle share, and the ten kernels with the
    most device time.  ``result`` is what ``fn`` returned."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_us": wall_us, "device_busy_us": busy if spans else None,
            "device_idle_share": 1.0 - busy / wall_us if spans else None,
            "device_events": len(spans),
            "top_kernels_us": [{"name": n[:80], "total_us": t, "count": c}
                               for n, (t, c) in top],
            "result": result}


if __name__ == "__main__":
    sys.exit(main())
