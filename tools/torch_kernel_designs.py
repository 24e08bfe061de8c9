#!/usr/bin/env python3
"""Hold both designs of the redesigned CUDA kernels (the first one and its
redesign) against their plain versions on a CUDA card, and time the two
side by side.

    python3 tools/torch_kernel_designs.py [--skip-ptxas] [--flash-only | --paged-only]

Prints, one JSON line each:

* ``ptxas``: registers, shared memory and spills of every kernel of both
  sources (``nvcc -Xptxas -v``);
* ``flash_fwd_check``: the forward's first design (``first``) and its
  redesign (bfloat16 ``wgmma``, float32 ``tf32``: 3xTF32 on the tensor
  cores) in each dtype against the plain version on the cases
  ``chip_smoke.py`` runs (relative error of O and lse, rows that see no
  key exactly 0);
* ``flash_fwd_time``: each design's median ms over 30 launches with the
  L2 flushed before each (three rounds of 10, the designs and
  ``scaled_dot_product_attention`` in turns), and the mean of 50
  launches back to back (``_b2b``), at the training slice's shape (B 16,
  H 12, S 512, D 64, and D 128).  Every timing first spins the card
  (``torch.cuda._sleep``) while the host queues the calls, so it is
  device time, not the host's enqueue;
* ``flash_bwd_check``: the backward's two kernels, dQ and dK/dV, in
  bfloat16 and in float32, in their first design and their redesign
  (bfloat16 ``wgmma``, float32 ``tf32``: 3xTF32 on the tensor cores),
  against the plain versions on the same cases, both from the plain
  forward's lse and delta (relative errors of dQ, dK and dV, within 2e-2
  for bfloat16 and 1e-4 for float32; dQ rows that see no key exactly 0;
  ``equal_first``: whether the redesign's dQ, dK and dV equal the first
  design's bit for bit);
* ``flash_bwd_time``: dQ and dK/dV in each design and dtype, timed as the
  forward is, beside SDPA's autograd backward (dQ, dK and dV together;
  ``sdpa_bwd_kernels`` names the kernels it launched, which shows the
  backend PyTorch picked);
* ``paged_check`` / ``paged_time``: the paged kernel's row-group path
  over float32, bfloat16, int8 and float8 pools (q float32 and bfloat16,
  a float32 q only over float32 pools; ragged G, a lane at position 0,
  rows across a split, G 80 in two row groups of a block each) and its
  decode path (G 1, ``decode``) against the plain version, then the
  single-pass path, the row-group path (forced at G 1) and, at G 1, the
  decode path at the serve shapes (8 lanes, 12 heads, D 64, BS 16, 64
  pages: prefill G 32 at 480, verify G 4 at 512, decode G 1 at 512; q
  float32), beside SDPA on pre-gathered (dequantized) K/V.

The card's name and power limit come last.  Tolerances are
``chip_smoke.py``'s.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from flexflow_tpu_torch.ops import cuda as ffcuda  # noqa: E402
from flexflow_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from flexflow_tpu_torch.ops.cuda import paged_attention as pa  # noqa: E402
from flexflow_tpu_torch.serve.kvcache import kv_qmax, pool_bits, quantize_kv  # noqa: E402

DEV = "cuda:0"
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # forward, relative to max |plain|
# the redesign of each forward dtype, beside its first design
FWD_DESIGNS = {torch.bfloat16: ["first", "wgmma"], torch.float32: ["first", "tf32"]}
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # backward, as chip_smoke.py's
# the redesign of each backward dtype, beside its first design
BWD_DESIGNS = {torch.bfloat16: ["first", "wgmma"], torch.float32: ["first", "tf32"]}
PAGED_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
# (name, B, H, Sq, Sk, D, causal, dropout rate, seed)
FLASH_CASES = [
    ("slice", 16, 12, 512, 512, 64, False, 0.0, 0),
    ("slice_d128", 16, 12, 512, 512, 128, False, 0.0, 0),
    ("causal_cross", 2, 12, 128, 256, 64, True, 0.0, 0),
    ("causal_tiled_2048", 2, 12, 2048, 2048, 64, True, 0.0, 0),
    ("no_visible_key", 2, 4, 384, 256, 64, True, 0.0, 0),
    ("dropout_causal", 2, 4, 512, 512, 128, True, 0.1, -7),
    ("dropout_d64", 2, 12, 512, 512, 64, False, 0.1, 1234),
]
B, H, D, BS, MB = 8, 12, 64, 16, 64
SPIN_CYCLES = 2_000_000  # about 1 ms: longer than the host takes to queue a timed call


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report() -> None:
    for name in ffcuda.sources():
        with tempfile.TemporaryDirectory() as tmp:
            r = subprocess.run([ffcuda.find_nvcc(), *ffcuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                os.path.join(tmp, "probe.so"),
                                str(ffcuda.CSRC_DIR / f"{name}.cu")],
                               capture_output=True, text=True, check=True)
        kernel = None
        for line in r.stderr.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "Performance Loss" in line:
                emit({"ptxas": name, "warning": line.split(":", 1)[-1].strip()})
            elif kernel and ("registers" in line or "spill" in line):
                emit({"ptxas": name, "kernel": kernel, "report": line.split(":", 1)[-1].strip()})


flush_buf = None


def time_samples(fn, iters=30):
    """Device ms of ``iters`` single calls, the L2 flushed before each."""
    global flush_buf
    if flush_buf is None:
        flush_buf = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        # the card spins while the host queues the flush, the events and
        # the call, so the events bracket device work only
        torch.cuda._sleep(SPIN_CYCLES)
        flush_buf.zero_()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def time_ms(fn, iters=30):
    """Median device ms of one call, the L2 flushed before each."""
    return float(np.median(time_samples(fn, iters)))


def back_to_back_ms(fn, n=50):
    """Mean device ms per call over ``n`` calls launched back to back."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES * n // 20)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def flash_inputs(Bq, Hq, sq, sk, d, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device="cpu").manual_seed(seed + sq + sk + d)
    return tuple(torch.randn(s, generator=g).to(DEV, dtype)
                 for s in ((Bq, Hq, sq, d), (Bq, Hq, sk, d), (Bq, Hq, sk, d)))


def flash_checks(dtype):
    tol = FLASH_TOL[dtype]
    for name, Bq, Hq, sq, sk, d, causal, rate, seed in FLASH_CASES:
        q, k, v = flash_inputs(Bq, Hq, sq, sk, d, dtype=dtype)
        p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal, rate, seed)
        live = p_lse > -1e29
        for design in FWD_DESIGNS[dtype]:
            line = {"phase": "flash_fwd_check", "case": name, "design": design,
                    "dtype": str(dtype).replace("torch.", "")}
            try:
                out, lse = fa.flash_fwd(q, k, v, causal, rate, seed,
                                        first_design=design == "first")
                torch.cuda.synchronize()
                line.update(rel_o=rel(out, p_out), rel_lse=rel(lse[live], p_lse[live]),
                            finite=bool(torch.isfinite(out.float()).all()))
                if not bool(live.all()):
                    dead = out.reshape(Bq * Hq, sq, d)[~live]
                    line["masked_rows_zero"] = bool((dead == 0).all())
                    line["masked_lse_max"] = float(lse[~live].max())
                line["ok"] = (line["finite"] and line["rel_o"] <= tol
                              and line["rel_lse"] <= tol
                              and line.get("masked_rows_zero", True))
            except RuntimeError as e:
                line.update(ok=False, error=str(e)[:300])
            emit(line)


def flash_times(dtype):
    """Each design and SDPA in turns, three rounds of 10 flushed calls (the
    median of the 30 is reported) and a back-to-back mean per round."""
    for d in (64, 128):
        q, k, v = flash_inputs(16, 12, 512, 512, d, dtype=dtype)

        def design_fn(design):
            return lambda: fa.flash_fwd(q, k, v, first_design=design == "first")

        fns = {design: design_fn(design) for design in FWD_DESIGNS[dtype]}
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v)
        flushed = {name: [] for name in fns}
        b2b = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                try:
                    flushed[name] += time_samples(fn, 10)
                    b2b[name].append(back_to_back_ms(fn))
                except RuntimeError as e:
                    flushed[name] = str(e)[:200]
        line = {"phase": "flash_fwd_time", "dtype": str(dtype).replace("torch.", ""), "B": 16,
                "H": 12, "S": 512, "D": d}
        for name in fns:
            ok = isinstance(flushed[name], list)
            line[name] = float(np.median(flushed[name])) if ok else flushed[name]
            line[name + "_b2b"] = float(np.median(b2b[name])) if b2b[name] else None
        emit(line)


def flash_bwd_checks(dtype):
    designs, tol = BWD_DESIGNS[dtype], BWD_TOL[dtype]
    for name, Bq, Hq, sq, sk, d, causal, rate, seed in FLASH_CASES:
        q, k, v = flash_inputs(Bq, Hq, sq, sk, d, dtype=dtype)
        do = flash_inputs(Bq, Hq, sq, sk, d, seed=1, dtype=dtype)[0]
        out, lse = fa.flash_attention_fwd_plain(q, k, v, causal, rate, seed)
        args = (q, k, v, do, lse, fa.flash_delta(out, do), causal, rate, seed)
        p_dq = fa.flash_attention_bwd_dq_plain(*args)
        p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(*args)
        live = lse > -1e29
        outs = {}
        for design in designs:
            line = {"phase": "flash_bwd_check", "case": name, "design": design,
                    "dtype": str(dtype).replace("torch.", ""), "tol": tol}
            try:
                first = design == "first"
                dq = fa.flash_bwd_dq(*args, first_design=first)
                dk, dv = fa.flash_bwd_dkv(*args, first_design=first)
                torch.cuda.synchronize()
                outs[design] = (dq, dk, dv)
                line.update(rel_dq=rel(dq, p_dq), rel_dk=rel(dk, p_dk), rel_dv=rel(dv, p_dv),
                            finite=all(bool(torch.isfinite(t.float()).all())
                                       for t in (dq, dk, dv)))
                if not first and "first" in outs:  # dQ, dK, dV bit for bit
                    line["equal_first"] = [torch.equal(a, b)
                                           for a, b in zip(outs[design], outs["first"])]
                if not bool(live.all()):
                    line["masked_rows_zero"] = bool(
                        (dq.reshape(Bq * Hq, sq, d)[~live] == 0).all())
                line["ok"] = (line["finite"] and max(line["rel_dq"], line["rel_dk"],
                                                     line["rel_dv"]) <= tol
                              and line.get("masked_rows_zero", True))
            except RuntimeError as e:
                line.update(ok=False, error=str(e)[:300])
            emit(line)


def sdpa_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({evt.name[:120] for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA})


def flash_bwd_times(dtype):
    """dQ and dK/dV in each design and SDPA's autograd backward in turns,
    as :func:`flash_times` does."""
    designs = BWD_DESIGNS[dtype]
    for d in (64, 128):
        q, k, v = flash_inputs(16, 12, 512, 512, d, dtype=dtype)
        do = flash_inputs(16, 12, 512, 512, d, seed=1, dtype=dtype)[0]
        out, lse = fa.flash_fwd(q, k, v)
        args = (q, k, v, do, lse, fa.flash_delta(out, do))
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv)
        fns = {}
        for design in designs:
            first = design == "first"
            fns[f"dq_{design}"] = lambda first=first: fa.flash_bwd_dq(*args, first_design=first)
            fns[f"dkv_{design}"] = lambda first=first: fa.flash_bwd_dkv(*args,
                                                                        first_design=first)
        fns["sdpa_bwd"] = lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                                      retain_graph=True)
        flushed = {name: [] for name in fns}
        b2b = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                try:
                    flushed[name] += time_samples(fn, 10)
                    b2b[name].append(back_to_back_ms(fn))
                except RuntimeError as e:
                    flushed[name] = str(e)[:200]
        line = {"phase": "flash_bwd_time", "dtype": str(dtype).replace("torch.", ""),
                "B": 16, "H": 12, "S": 512, "D": d,
                "sdpa_bwd_kernels": sdpa_kernels(fns["sdpa_bwd"])}
        for name in fns:
            ok = isinstance(flushed[name], list)
            line[name] = float(np.median(flushed[name])) if ok else flushed[name]
            line[name + "_b2b"] = float(np.median(b2b[name])) if b2b[name] else None
        emit(line)


def pool_case(rng, G, pool, pos, q_dtype):
    """chip_smoke.py's cases: over a float32 or bfloat16 pool, pages past
    each lane's view and the trash block hold 1e4; over an int8 or fp8
    pool, pages past each lane's view hold ints at the maximum with scales
    1e4, the trash block the same ints with zero scales."""
    N = B * MB + 1
    q = torch.from_numpy(rng.standard_normal((B, G, H, D)).astype(np.float32))
    p_d = torch.from_numpy(pos.astype(np.int32)).to(DEV)
    if pool in ("float32", "bfloat16"):
        kv = torch.from_numpy(rng.standard_normal((2, N, H, BS, D)).astype(np.float32))
        bt = (rng.permutation(N - 1) + 1)[: B * MB].reshape(B, MB).astype(np.int32)
        past = [int(bt[b, i]) for b in range(B)
                for i in range((int(pos[b]) + G - 1) // BS + 1, MB)]
        kv[:, [0] + past] = 1e4
        pk, pv = kv.to(DEV, getattr(torch, pool))
        return (q.to(DEV, q_dtype), pk.contiguous(), pv.contiguous(), p_d,
                torch.from_numpy(bt).to(DEV), None, None, None)
    kv_dtype = pool
    pools = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((N, BS, H, D)).astype(np.float32)).to(DEV)
        qx, sc = quantize_kv(x, kv_dtype)
        qx = pool_bits(qx).permute(0, 2, 1, 3).contiguous().view(qx.dtype)
        pools.append((qx, sc.contiguous()))
    bt = (rng.permutation(N - 1) + 1)[: B * MB].reshape(B, MB).astype(np.int32)
    top = torch.full((H, BS, D), kv_qmax(kv_dtype), device=DEV).to(pools[0][0].dtype)
    past = [int(bt[b, i]) for b in range(B) for i in range((int(pos[b]) + G - 1) // BS + 1, MB)]
    idx = torch.tensor([0] + past, dtype=torch.long, device=DEV)
    for qpool, sc in pools:
        pool_bits(qpool)[idx] = pool_bits(top)
        sc[idx] = 1e4
        sc[0] = 0.0
    (pk, sk), (pv, sv) = pools
    return (q.to(DEV, q_dtype), pk, pv, p_d, torch.from_numpy(bt).to(DEV), None, sk, sv)


POOLS = ("float32", "bfloat16", "int8", "fp8")


def paged_checks():
    rng = np.random.default_rng(1)
    for kv_dtype in POOLS:
        for q_dtype in (torch.float32, torch.bfloat16):
            if kv_dtype == "float32" and q_dtype == torch.bfloat16:
                continue  # the kernel takes no bfloat16 q over a float32 pool
            for G, label in ((1, "decode"), (4, "verify"), (20, "ragged"), (32, "prefill"),
                             (20, "position_0"), (20, "straddle"), (80, "two_row_groups")):
                pos = np.minimum(BS * rng.integers(0, MB, size=B) + BS // 2 + np.arange(B),
                                 MB * BS - G)
                if label == "position_0":
                    pos[0] = 0
                if label == "straddle":  # rows 54 .. 73 cross the 64-key tile
                    pos[:] = 54 + 64 * np.arange(B) % (MB * BS - 64 - G)
                args = pool_case(rng, G, kv_dtype, pos, q_dtype)
                want = pa.paged_attention_plain(*args)
                name = str(q_dtype).replace("torch.", "")
                atol, rtol = PAGED_TOL[name]
                line = {"phase": "paged_check", "case": label, "kv_dtype": kv_dtype,
                        "q_dtype": name, "G": G, "route": pa.route(G, D, BS, MB, args[1].dtype)}
                try:
                    got = pa.paged_attention(*args)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs()
                    line.update(max_abs_err=float(err.max()), ok=bool(
                        torch.isfinite(got.float()).all()
                        and (err <= atol + rtol * want.float().abs()).all()))
                except RuntimeError as e:
                    line.update(ok=False, error=str(e)[:300])
                emit(line)


def paged_times():
    scale = 1.0 / math.sqrt(D)
    for G, ctx in ((32, 480), (4, 512), (1, 512)):
        for kv_dtype in POOLS:
            pos = np.full(B, ctx, np.int64)
            args = pool_case(np.random.default_rng(G), G, kv_dtype, pos, torch.float32)
            q, pk, pv, p_d, bt, _, sk, sv = args

            def dense(pool, sc):
                pages = pool_bits(pool)[bt.long()].view(pool.dtype).float()
                if sc is not None:
                    pages = pages * sc[bt.long()][:, :, None, :, None]
                return pages.permute(0, 2, 1, 3, 4).reshape(B, H, MB * BS, D)

            keys, vals = dense(pk, sk), dense(pv, sv)
            k_pos = torch.arange(MB * BS, device=DEV)
            rows = p_d.long()[:, None] + torch.arange(G, device=DEV)
            mask = (k_pos[None, None, :] <= rows[:, :, None])[:, None]
            qh = q.permute(0, 2, 1, 3).contiguous()
            line = {"phase": "paged_time", "kv_dtype": kv_dtype, "G": G, "context": ctx}
            keep = pa.DECODE_PATH, pa.SPLIT_MIN_ROWS
            try:
                if G == 1:
                    line["decode"] = time_ms(lambda: pa.paged_attention(*args))
                pa.DECODE_PATH, pa.SPLIT_MIN_ROWS = False, 10 ** 9
                line["single_pass"] = time_ms(lambda: pa.paged_attention(*args))
                pa.SPLIT_MIN_ROWS = 1
                line["split"] = time_ms(lambda: pa.paged_attention(*args))
            except RuntimeError as e:
                line["error"] = str(e)[:200]
            finally:
                pa.DECODE_PATH, pa.SPLIT_MIN_ROWS = keep
            line["sdpa"] = time_ms(lambda: F.scaled_dot_product_attention(
                qh, keys, vals, attn_mask=mask, scale=scale))
            emit(line)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_designs: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    ffcuda.build()
    if "--skip-ptxas" not in sys.argv:
        ptxas_report()
    if "--flash-only" not in sys.argv:
        paged_checks()
        paged_times()
    if "--paged-only" not in sys.argv:
        for dtype in (torch.bfloat16, torch.float32):
            flash_checks(dtype)
            flash_bwd_checks(dtype)
        for dtype in (torch.bfloat16, torch.float32):
            flash_times(dtype)
            flash_bwd_times(dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": card.stdout.strip(), "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
