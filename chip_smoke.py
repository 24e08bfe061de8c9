#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. ``build``: compile every kernel source under
   ``flexflow_tpu_torch/ops/cuda/csrc`` (one ``nvcc`` per source, all at
   once) and report the seconds each took.
2. ``paged_attention``: the CUDA kernel against its plain PyTorch
   version on the card, float32 and bfloat16 (and a float32 query over
   a bfloat16 pool), G=1 (decode: the decode path, split over pages),
   G=4 (the verify width) and G=32 (prefill chunk; both on the row-group
   path, split over pages), BS 16, D 64, H 12, scrambled block tables,
   pages outside each lane's view poisoned with 1e4, starts that
   straddle a page; then the row-group path's edges: a ragged G of 20
   (``ragged``), lanes at position 0 whose later splits hold nothing
   they see (``position_0``), and rows that straddle a split boundary
   (``straddle``); then the decode path's edges (``decode_edges``: a
   lane at position 0, one whose last page is partly visible, one on
   the first key of a split, one at the table's last position), at BS
   16 and 8 and at D 128.  Each case must take the route ``route``
   gives it, as ``LAUNCHES_BY_ROUTE`` shows.  Tolerances, by output dtype:
   float32 2e-5 absolute (the two sum in different orders: online
   softmax page by page, or tile by tile and split by split, against
   one softmax over the gathered row; the row-group path's products are
   3xTF32 over float32 pools); bfloat16 2e-2 + 2^-7 x |reference|
   (both round a float32 result to bfloat16, which can land one bfloat16
   step apart).  A page too large for shared memory must raise, and
   the next launch must still succeed.
   Then the kernel, the plain version and ``scaled_dot_product_attention``
   on pre-gathered K/V are timed at the serve phase's shapes, over
   float32 pools and over bfloat16 pools (float32 q); at G 32 the timing
   also times the single pass that the row-group path replaced
   (``was_ms``), at G 1 the single pass that the decode path replaced
   (``was_ms``) and the row-group path forced to G 1
   (``row_group_g1_ms``).
   ``paged_attention_quant``: the same kernel over int8 and float8 e4m3
   pools with their per-position scale rows, q float32 and bfloat16,
   G = 1, 4 and 32 and the three edge cases, with the same tolerances;
   pages past each lane's view hold ints at the format's maximum with
   scale rows 1e4, the trash block the same ints with zero scales.
   ``paged_attention_single_pass``: the single pass at G 32 and at G 1,
   which the engine takes at a D the other paths do not take or a BS that
   does not divide 64, forced (``SPLIT_MIN_ROWS`` above G,
   ``DECODE_PATH`` off) over all four pool formats;
   ``paged_attention_row_group_g1``: the row-group path forced to G 1
   (``DECODE_PATH`` off, ``SPLIT_MIN_ROWS`` 1), which the timing times
   beside the decode path.
   ``paged_attention_quant_timing`` times the quantized kernel at the
   serve shapes beside its bound (1-byte K/V plus two float32 scales per
   visible position), its plain version and
   ``scaled_dot_product_attention`` on pre-gathered dequantized K/V.
3. ``serve``: the port's main path, ``ServeEngine.run`` at GPT-2-small
   width and depth (hidden 768, 12 heads, ff 3072, 12 layers, vocab
   50257, seq 1024), float32, random weights from a seed, 8 slots,
   block 16, prefill chunk 32, sync_every 4, ``attn="auto"``; 16
   requests with prompts of 128-512 tokens and 32-64 new tokens.  The
   kernel's launch counts are set to 0 just before the run; after it the
   launches must equal 12 x (decode steps + prefill dispatches), by route
   12 x decode steps on the decode path and 12 x prefill dispatches on
   the row-group path.  The same requests
   are served again with ``attn="gather"`` and the greedy streams
   compared; both programs are then run on identical inputs and their
   next-token probabilities compared.
   ``profile`` then traces a separate serve run: device time by kernel,
   the paged kernel's device time by route, and the device's idle share.
   ``serve_quant`` serves the same requests with ``kv_dtype`` "int8" and
   "fp8": every request must finish with its full budget, the quantized
   kernel's launches must equal 12 x (decode steps + prefill dispatches),
   by route as the float32 arm's, one host sync per window; the gather
   path's streams are compared and
   its programs' probabilities must agree within ``QUANT_PROB_TOL``.
   ``serve_spec`` adds speculative decoding (k = 3, a 6-layer draft) over
   int8 pools: launches 12 x (prefill dispatches + macros) on the
   row-group path + 6 x 3 x macros (the drafts) on the decode path, and
   every stream equal to the plain int8 greedy stream up to
   the first token whose relative top-2 margin in the plain run is under
   1e-4.  ``profile_quant`` traces the profile run with int8 pools.
   ``serve_w8`` serves with int8 weights and int8 pools.
   ``kv_spill_roundtrip`` (:func:`spill_roundtrip`): pools at GPT-2-small
   model shape in all four formats; a 500-position slot of seeded bits
   spilled and restored into BS 8 and BS 32 pools bit for bit, through
   ``ffkv/1`` bytes and back, and a wrong-format restore refused; spill
   and restore ms and MB/s.  ``serve_preempt`` (float32 and int8 pools)
   and ``serve_drain`` (:func:`resilience_phases`): interactive arrivals
   preempt decoding batch requests, which spill and resume; a SIGTERM
   from the fault plan drains the run to an ``ffdrain/1`` file that a
   fresh engine resumes; streams held against undisturbed reference runs
   by the speculative arm's margin rule, launches by route gated.
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
   float32 backward's D 128 kernels with the mask and dropout together;
   ``gpt_causal`` (B 4, H 12, S 1024, D 64, causal, float32 and
   bfloat16) is the shape that phase ``gpt_train`` gives them;
   ``bh_65544`` (B 5462, H 12, S 128, D 64, float32 and bfloat16: 2.1 GB
   a float32 tensor) runs past the grid's y limit of 65535 rows, so each
   call launches its kernel over two chunks of rows;
   ``grid_chunks_dropout`` (B 2, H 6, S 256, D 64, causal, dropout 0.1)
   runs with ``GRID_Y_MAX`` set to 5, so the dropout hash and the mask
   are checked across chunk boundaries.  ``flash_attention_bh_65544_timing``
   times the three kernels at ``bh_65544``'s shape beside their bound.
   Tolerances, relative to max |reference|: float32 2e-5 forward, 1e-4
   backward (the kernels sum tile by tile, the plain versions over whole
   rows; the float32 kernels' products are 3xTF32); bfloat16 2e-2 (both
   round the same float32 values to bfloat16, at different places for
   the probabilities).
   ``flash_attention_timing`` times each kernel at the slice's shape
   beside its bound, the plain version and
   ``scaled_dot_product_attention`` (forward, and its autograd backward
   for dQ + dK + dV); each redesigned kernel (all three in both dtypes)
   also times its first design (``was_ms``).
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
   ``train_fit`` (:func:`train_fit_phase`): BERT-Base on tokens (vocab
   30522, the sinusoidal ``pos_embed`` input) through ``FFModel.fit``, 160
   samples for 2 epochs with shuffle: 12 launches of each flash kernel a
   step, one host sync an epoch, the losses within 1e-4 of the same fit on
   the plain core; a run checkpointing every 6 steps is killed by the
   fault plan at step 14 and a fresh model resumes from step 12 to the
   reference's weights, moments and step bit for bit; ``eval`` over 40
   samples (a padded tail) equals its rows recomputed on the host; the
   checkpoint's bytes and save, snapshot and load times.
   ``gpt_train`` (:func:`gpt_train_phase`): ``GPT2_SMALL`` through
   ``FFModel`` (``gpt_decoder``, batch 4, seq 1024), 3 steps in float32
   and bfloat16 on the causal flash kernels (12 of each a step), losses
   within 1e-4 / 2e-2 of the plain core, a traced step for the flash
   kernels' device time; ``gpt_train_serve``: the trained float32 weights
   in the paged engine, greedy streams against ``gpt_generate``'s by the
   speculative arm's margin rule, launches by route gated.
   ``zoo`` (:func:`zoo_phase`): every model of the zoo (MLP
   784-512-512-10; AlexNet and ResNet-50 at 229x229; ResNeXt-50 32x4d at
   224x224 and InceptionV3 at 299x299, 1000 classes; DLRM and XDL with 4
   tables of 1,000,000 x 64; CANDLE-Uno; the MoE classifier, unfused and
   fused, and the MoE encoder at ``moe.cc``'s constants) through
   ``FFModel.fit``, 3 SGD steps of batch 64 in float32, the losses within
   ``ZOO_LOSS_TOL`` (1e-3 relative; the aim is 1e-4) of a float64 run of
   the same model from the same weights and batches; step times, samples/s and peak
   memory beside the card; no flash or paged launch.
   ``zoo_batch_norm``: a conv -> batch_norm model the same way, its
   running stats moved and within 1e-4 of the float64 run's.
6. ``kernels``: one line ``{"kernels": [...]}`` with each kernel's
   route, source, the TPU kernel it replaces, launches by path
   (``launches_by_path``: each path's count, ``launches`` their sum;
   the flash kernels over ``train``, ``train_fit`` and its resume and
   eval, ``gpt_train`` and ``zoo``; the paged kernel over ``serve``,
   ``gpt_train_serve`` and ``zoo``), launches on its path
   (``paged_attention_quant``: the int8 ``serve_quant`` run, fp8 beside
   it; ``paged_attention``: by route as well), error against the plain
   version, times and bound, and ``was_ms`` beside a redesigned kernel's
   time (the paged kernel's decode also ``row_group_g1_ms``);
   ``paged_attention`` carries its bfloat16-pool times under
   ``bfloat16``.  Every time is device
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
# train_fit: BERT-Base on tokens through FFModel.fit, 160 samples (10 batches
# of 16) for 2 epochs with shuffle; checkpoints every 6 steps; the fault plan
# kills the run at the top of step 14; a fresh model resumes from step 12
FIT_VOCAB, FIT_SAMPLES, FIT_EVAL, FIT_EPOCHS = 30522, 160, 40, 2
FIT_CKPT_EVERY, FIT_KILL = 6, 14
EVAL_TOL = 1e-5  # eval's device sums against the rows recomputed on the host
# gpt_train: GPT2_SMALL through FFModel at batch 4, seq 1024, 3 train steps,
# then 8 greedy tokens from 64-token prompts, against the paged engine
GPT_B, GPT_STEPS, GPT_PROMPT, GPT_NEW = 4, 3, 64, 8
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
# zoo: every zoo model through FFModel.fit, float32, 3 SGD steps of batch 64
# at its published widths, held against a float64 run of the same model:
# (label, driver model name, build_zoo arguments beyond the app's defaults)
# (ResNet-50, without BatchNorm in the reference's graph, diverges at the
# example's SGD rate: loss 3.65 -> 14.5 in 3 steps, and its float32 run sat
# 5.4e-5 from float64 on an H100; the aim is 1e-4, the gate 1e-3)
ZOO_BATCH, ZOO_STEPS, ZOO_LOSS_TOL = 64, 3, 1e-3
ZOO_CASES = (
    ("MLP 784-512-512-10", "mlp", {}),
    ("AlexNet", "alexnet", dict(size=229)),
    ("ResNet-50", "resnet", dict(size=229)),
    ("ResNeXt-50 32x4d", "resnext50", dict(size=224, classes=1000)),
    ("InceptionV3", "inception", dict(size=299, classes=1000)),
    ("DLRM", "dlrm", dict(embedding_size=1000000)),
    ("XDL", "xdl", dict(embedding_size=1000000)),
    ("CANDLE-Uno", "candle_uno", {}),
    ("MoE classifier", "moe", {}),
    ("MoE classifier, fused", "moe", dict(fused=True)),
    ("MoE encoder", "moe_encoder", {}),
)
# the flash kernels past the grid's y limit: B * H = 65544 rows at S 128, D 64
BIG_BH = (5462, 12)
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
    def case(rng, G, dtype, pos, q_dtype=None, bs=BS, d=D):
        mb = SEQ // bs
        N = B * mb + 1  # + trash block 0
        q = torch.from_numpy(rng.standard_normal((B, G, H, d)).astype(np.float32))
        pk = torch.from_numpy(rng.standard_normal((N, H, bs, d)).astype(np.float32))
        pv = torch.from_numpy(rng.standard_normal((N, H, bs, d)).astype(np.float32))
        bt = (rng.permutation(N - 1) + 1)[: B * mb].reshape(B, mb).astype(np.int32)
        pk[0] = pv[0] = 1e4
        for b in range(B):
            last = (int(pos[b]) + G - 1) // bs
            for i in range(last + 1, mb):
                pk[bt[b, i]] = 1e4
                pv[bt[b, i]] = 1e4
        return (q.to(dev, q_dtype or dtype), pk.to(dev, dtype), pv.to(dev, dtype),
                torch.from_numpy(pos.astype(np.int32)).to(dev),
                torch.from_numpy(bt).to(dev))

    def quant_case(rng, G, kv_dtype, pos, q_dtype, bs=BS, d=D):
        """Pools quantized from normal K/V by the pools' own rule; pages past
        each lane's last visible page poisoned (ints at the format's
        maximum, scale rows 1e4), the trash block poisoned with zero
        scales."""
        mb = SEQ // bs
        N = B * mb + 1
        q = torch.from_numpy(rng.standard_normal((B, G, H, d)).astype(np.float32))
        pools = []
        for _ in range(2):
            x = torch.from_numpy(rng.standard_normal((N, bs, H, d)).astype(np.float32)).to(dev)
            qx, sc = quantize_kv(x, kv_dtype)
            qx = pool_bits(qx).permute(0, 2, 1, 3).contiguous().view(qx.dtype)
            pools.append((qx, sc.contiguous()))
        bt = (rng.permutation(N - 1) + 1)[: B * mb].reshape(B, mb).astype(np.int32)
        top = torch.full((H, bs, d), kv_qmax(kv_dtype), device=dev).to(pools[0][0].dtype)
        past = [int(bt[b, i]) for b in range(B)
                for i in range((int(pos[b]) + G - 1) // bs + 1, mb)]
        idx = torch.tensor([0] + past, dtype=torch.long, device=dev)
        for pool, sc in pools:
            pool_bits(pool)[idx] = pool_bits(top)
            sc[idx] = 1e4
            sc[0] = 0.0
        (pk, sk), (pv, sv) = pools
        return (q.to(dev, q_dtype), pk, pv, sk, sv,
                torch.from_numpy(pos.astype(np.int32)).to(dev), torch.from_numpy(bt).to(dev))

    def hold(phase, args, scales=(None, None), **info):
        """One call of the kernel on ``args`` (q, pools, positions, block
        tables) against the plain version under ``TOL``, on the route
        ``route`` gives it, which ``LAUNCHES_BY_ROUTE`` must show.  Emits
        the case's line; fails unless it holds.  Returns the max abs
        error."""
        q, pk, pv, p_d, bt = args
        G, d, bs, mb = q.shape[1], q.shape[3], pk.shape[2], bt.shape[1]
        route = pa.route(G, d, bs, mb, pk.dtype)
        plan = (pa.decode_plan if route == "decode" else pa.split_plan)(G, d, bs, mb, pk.dtype)
        before = dict(pa.LAUNCHES_BY_ROUTE)
        got = pa.paged_attention(q, pk, pv, p_d, bt, None, *scales)
        torch.cuda.synchronize()
        routes = [r for r in before if pa.LAUNCHES_BY_ROUTE[r] != before[r]]
        want = pa.paged_attention_plain(q, pk, pv, p_d, bt, None, *scales)
        err = (got.float() - want.float()).abs()
        name = str(q.dtype).replace("torch.", "")  # the output's dtype
        atol, rtol = TOL[name]
        ok = (routes == [route] and bool(torch.isfinite(got.float()).all())
              and bool((err <= atol + rtol * want.float().abs()).all()))
        max_err = float(err.max())
        emit({"phase": phase, **info, "q_dtype": name,
              "pool_dtype": str(pk.dtype).replace("torch.", ""), "G": G, "B": B, "H": H,
              "D": d, "BS": bs, "MB": mb, "route": routes, "plan": plan,
              "positions": p_d.tolist(), "max_abs_err": max_err,
              "rel_err": max_err / float(want.float().abs().max()),
              "atol": atol, "rtol": rtol, "ok": ok})
        if not ok:
            raise SystemExit(f"{phase} {info} q {q.dtype} pool {pk.dtype} G={G}: the kernel "
                             f"took route {routes} (expected {route}) or disagrees with the "
                             f"plain version (max abs err {max_err})")
        return max_err

    def spread(G):
        """Row 0 mid-page in a random page, so the G rows run across a page
        boundary."""
        return np.minimum(BS * rng.integers(0, MB, size=B) + BS // 2 + np.arange(B),
                          MB * BS - G)

    def edge(label, G, pool_dtype):
        """Positions of the row-group path's edge cases: a ragged G
        (``ragged``), lanes at position 0 whose later splits hold nothing
        they see (``position_0``), rows that straddle a split boundary
        (pages_per_split x BS keys; ``straddle``)."""
        pos = spread(G)
        if label == "position_0":
            pos[: B // 2] = 0
        if label == "straddle":
            plan = pa.split_plan(G, D, BS, MB, pool_dtype)
            bound = plan[1] * BS if plan else SPLIT_KEYS
            pos = np.minimum(bound * (1 + np.arange(B)) - G // 2, MB * BS - G)
        return pos

    def decode_edge(bs, pool_dtype, d=D):
        """Positions of the decode path's edges at page size ``bs``: a lane
        at position 0, one whose last page is partly visible, one on the
        first key of its second split, one at the table's last position."""
        mb = SEQ // bs
        pos = np.minimum(bs * rng.integers(0, mb, size=B) + bs // 2 + np.arange(B), mb * bs - 1)
        pos[:4] = (0, 3 * bs + 5, pa.decode_plan(1, d, bs, mb, pool_dtype)[1] * bs, mb * bs - 1)
        return pos

    # the decode path's edges: (label, BS, D)
    DECODE_EDGES = (("decode_edges", BS, D), ("decode_edges_bs8", 8, D),
                    ("decode_edges_d128", BS, 128))

    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    # (q dtype, pool dtype): the engine's float32 and bfloat16 pools, and
    # a float32 engine over a bfloat16 pool (kv_dtype="bf16")
    FLOAT_PAIRS = ((f32, f32), (bf16, bf16), (f32, bf16))
    worst = {}  # pool dtype -> max abs err over the float32-q cases
    for q_dtype, dtype in FLOAT_PAIRS:
        # decode (the single pass), the verify width and the prefill chunk
        # (the row-group path), then the row-group path's edges
        cases = [(None, G) for G in (1, 4, CHUNK)]
        cases += [(label, 20) for label in ("ragged", "position_0", "straddle")]
        for label, G in cases:
            pos = spread(G) if label is None else edge(label, G, dtype)
            err = hold("paged_attention", case(rng, G, dtype, pos, q_dtype),
                       **({} if label is None else {"case": label}))
            if q_dtype == f32:
                key = str(dtype).replace("torch.", "")
                worst[key] = max(worst.get(key, 0.0), err)
        for label, bs, d in DECODE_EDGES:
            hold("paged_attention", case(rng, 1, dtype, decode_edge(bs, dtype, d), q_dtype, bs, d),
                 case=label)

    # a page too large for shared memory is refused by the launcher (two
    # rows a lane over 1024-position pages take the single pass, whose ring
    # holds whole pages), and the refusal leaves no error behind for the
    # next launch
    one = case(np.random.default_rng(SEED), 1, f32, np.zeros(B, np.int64))
    wide = torch.zeros(2, H, 1024, D, device=dev)
    two_rows = torch.cat([one[0], one[0]], dim=1)
    if pa.route(2, D, 1024, 1, f32) != "single":
        raise SystemExit("the refusal case no longer takes the single pass")
    try:
        pa.paged_attention(two_rows, wide, wide, one[3],
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

    def timing(G, ctx, pool="float32"):
        """The kernel at the serve phase's shapes: 8 lanes whose row 0 sits
        at ``ctx``, q float32; a float32 or bfloat16 pool, or an int8/fp8
        one with its scales."""
        pos = np.full(B, ctx, np.int64)
        rng_t = np.random.default_rng(SEED + G)
        if pool in ("float32", "bfloat16"):
            q, pk, pv, p_d, bt = case(rng_t, G, getattr(torch, pool), pos, torch.float32)
            sk = sv = None
        else:
            q, pk, pv, sk, sv, p_d, bt = quant_case(rng_t, G, pool, pos, torch.float32)
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
        def kernel_ms(decode_path=True, split_min_rows=pa.SPLIT_MIN_ROWS):
            keep = pa.DECODE_PATH, pa.SPLIT_MIN_ROWS
            pa.DECODE_PATH, pa.SPLIT_MIN_ROWS = decode_path, split_min_rows
            try:
                return time_ms(lambda: pa.paged_attention(q, pk, pv, p_d, bt, scale, sk, sv))
            finally:
                pa.DECODE_PATH, pa.SPLIT_MIN_ROWS = keep

        path = pa.route(G, D, BS, MB, pk.dtype)
        ms = kernel_ms()
        was = {}
        # the single-pass design each split path replaced, on the same
        # inputs; at G 1 also the row-group path forced to one row
        if path == "split":
            was["was_ms"] = kernel_ms(split_min_rows=G + 1)
        if path == "decode":
            was["was_ms"] = kernel_ms(decode_path=False)
            was["row_group_g1_ms"] = kernel_ms(decode_path=False, split_min_rows=1)
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
        # over float32 pools; a bfloat16, int8 or e4m3 page is a bfloat16
        # value, so over those pools three bfloat16 products (q and the
        # weights split in three parts) hold float32's products exactly
        peak_ops = peak_3xtf32 if pk.dtype == torch.float32 else peak_3xbf16
        t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_ops * 1e3
        return {
            "G": G, "context": ctx, "route": path, "ms": ms, **was, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }

    t_dec = timing(1, 512)
    t_pre = timing(CHUNK, 480)
    t_bf = {"decode": timing(1, 512, "bfloat16"), "prefill": timing(CHUNK, 480, "bfloat16")}
    emit({"phase": "paged_attention_timing", "decode": t_dec, "prefill": t_pre,
          "bfloat16": t_bf,
          "peaks": {"bytes_per_s": peak_bw, "f32_3xtf32_flop_per_s": peak_3xtf32,
                    "f32_3xbf16_flop_per_s": peak_3xbf16},
          "library_call": "scaled_dot_product_attention on K/V pre-gathered at the full "
                          "virtual length (the gather itself not timed)",
          "card": card})

    # --- 2q. paged_attention_quant: int8/fp8 pools against plain, timing ------
    quant_worst = {}  # kv dtype -> max abs err over the float32-q cases
    for kv_dtype in ("int8", "fp8"):
        for q_dtype in (f32, bf16):
            # G 1, 4 and 32 as over the float pools, then the row-group
            # path's edges
            cases = [(None, G) for G in (1, 4, CHUNK)]
            cases += [(label, 20) for label in ("ragged", "position_0", "straddle")]
            for label, G in cases:
                pos = spread(G) if label is None else edge(label, G, torch.int8)
                q, pk, pv, sk, sv, p_d, bt = quant_case(rng, G, kv_dtype, pos, q_dtype)
                err = hold("paged_attention_quant", (q, pk, pv, p_d, bt), (sk, sv),
                           kv_dtype=kv_dtype, **({} if label is None else {"case": label}))
                if q_dtype == f32:
                    quant_worst[kv_dtype] = max(quant_worst.get(kv_dtype, 0.0), err)
            for label, bs, d in DECODE_EDGES:
                q, pk, pv, sk, sv, p_d, bt = quant_case(
                    rng, 1, kv_dtype, decode_edge(bs, torch.int8, d), q_dtype, bs, d)
                hold("paged_attention_quant", (q, pk, pv, p_d, bt), (sk, sv),
                     kv_dtype=kv_dtype, case=label)

    def forced(phase, G, decode_path, split_min_rows):
        """Hold ``G``-row calls over every pool format on the path that
        ``DECODE_PATH`` and ``SPLIT_MIN_ROWS`` set as given choose."""
        keep = pa.DECODE_PATH, pa.SPLIT_MIN_ROWS
        pa.DECODE_PATH, pa.SPLIT_MIN_ROWS = decode_path, split_min_rows
        try:
            for q_dtype, dtype in FLOAT_PAIRS:
                hold(phase, case(rng, G, dtype, spread(G), q_dtype))
            for kv_dtype in ("int8", "fp8"):
                for q_dtype in (f32, bf16):
                    q, pk, pv, sk, sv, p_d, bt = quant_case(rng, G, kv_dtype, spread(G), q_dtype)
                    hold(phase, (q, pk, pv, p_d, bt), (sk, sv), kv_dtype=kv_dtype)
        finally:
            pa.DECODE_PATH, pa.SPLIT_MIN_ROWS = keep

    # the single pass, which the engine takes at a D the other paths do not
    # take or a BS that does not divide 64: forced here at G 32 and G 1 over
    # every pool format, as timing() forces it for was_ms; and the row-group
    # path forced to G 1, which timing() times beside the decode path
    forced("paged_attention_single_pass", CHUNK, True, CHUNK + 1)
    forced("paged_attention_single_pass", 1, False, 2)
    forced("paged_attention_row_group_g1", 1, False, 1)
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
        for route in pa.LAUNCHES_BY_ROUTE:
            pa.LAUNCHES_BY_ROUTE[route] = 0
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
    by_route_serve = dict(pa.LAUNCHES_BY_ROUTE)
    layers = GPT2_SMALL["num_layers"]
    expect = layers * (rep.decode_steps + rep.prefill_dispatches)

    def routes(decode, prefill):
        """Launches by route when ``decode`` calls run at G 1 (decode steps,
        drafts: the decode path) and ``prefill`` at G >= 2 (prefill chunks,
        verifies: the row-group path), one per layer each."""
        return {"single": 0, "split": prefill, "decode": decode}

    expect_route = routes(layers * rep.decode_steps, layers * rep.prefill_dispatches)
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
        "launches_by_route": by_route_serve, "expected_by_route": expect_route,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }
    emit(serve)
    if not (launches > 0 and launches == expect):
        raise SystemExit(f"paged_attention launches {launches} != {expect}")
    if by_route_serve != expect_route:
        raise SystemExit(f"paged_attention launches by route {by_route_serve} != {expect_route}")
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
        by_route = dict(pa.LAUNCHES_BY_ROUTE)
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
                "paged_attention_launches": launches, "launches_by_pool": by_pool,
                "launches_by_route": by_route}
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
        line["expected_by_route"] = routes(layers * r_q.decode_steps,
                                           layers * r_q.prefill_dispatches)
        if not (line["paged_attention_launches"] == expect > 0
                and line["launches_by_pool"] == {pool_name: expect}
                and line["launches_by_route"] == line["expected_by_route"]):
            raise SystemExit(f"serve_quant {kv_dtype}: launches {line['launches_by_pool']} "
                             f"!= {{{pool_name!r}: {expect}}}, or by route "
                             f"{line['launches_by_route']} != {line['expected_by_route']}")
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
    # drafts at G 1 take the decode path; verifies (G 4) and prefill chunks
    # the row-group path
    expect_route = routes(SPEC_DRAFT * SPEC_K * macros,
                          layers * (r_s.prefill_dispatches + macros))
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
                 "expected_launches": expect, "expected_by_route": expect_route,
                 "streams_identical_to_plain_int8": len(rs_s) - len(diverged),
                 "diverged": diverged, "margin_threshold_rel": SPEC_MARGIN,
                 "reference_streams_equal_to_serve_quant_int8": compare_streams(
                     rs_p, quant_reqs["int8"])[0],
                 "card": card})
    emit(line)
    if not (line["paged_attention_launches"] == expect > 0
            and line["launches_by_pool"] == {"int8": expect}
            and line["launches_by_route"] == expect_route):
        raise SystemExit(f"serve_spec: launches {line['launches_by_pool']} != {expect}, or by "
                         f"route {line['launches_by_route']} != {expect_route}")
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
    expect_route = routes(layers * r_w.decode_steps, layers * r_w.prefill_dispatches)
    same_w, _ = compare_streams(rs_w, rs_p)
    line.update({"expected_launches": expect, "expected_by_route": expect_route,
                 "fp32_tok_s": serve["tok_s"],
                 "int8_kv_tok_s": quant_lines["int8"]["tok_s"],
                 "streams_identical_to_int8_kv": same_w, "card": card})
    emit(line)
    if line["paged_attention_launches"] != expect or line["launches_by_route"] != expect_route:
        raise SystemExit(f"serve_w8: launches {line['paged_attention_launches']} != {expect}, "
                         f"or by route {line['launches_by_route']} != {expect_route}")
    del e_w
    torch.cuda.empty_cache()

    # --- 3r. kv_spill_roundtrip / serve_preempt / serve_drain ----------------
    spill_roundtrip(dev, card)
    resilience_phases(dev, model, engine_kw, card, zero_counts, routes, margin_recorder,
                      margins_by_request)
    torch.cuda.empty_cache()

    # --- 4. flash_attention: kernels against plain, then timing --------------
    def qkv(shape_q, shape_k, dtype, seed, on_card=False):
        """q, k, v and dO from a seeded generator, on the host or (for the
        2 GB tensors of ``bh_65544``) on the card."""
        g = torch.Generator(device=dev if on_card else "cpu").manual_seed(seed)
        q, k, v, do = (torch.randn(s, generator=g, device=g.device).to(dev, dtype)
                       for s in (shape_q, shape_k, shape_k, shape_q))
        return q, k, v, do

    def rel(a, b, mask=None):
        a, b = a.float(), b.float()
        if mask is not None:
            a, b = a[mask], b[mask]
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    flash_worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}  # float32 max abs errors

    def flash_case(name, B_, H_, sq, sk, D_, dtype, causal, rate=0.0, seed=0, v_eye=False):
        q, k, v, do = qkv((B_, H_, sq, D_), (B_, H_, sk, D_), dtype, SEED + sq + sk + D_,
                          on_card=B_ * H_ > fa.GRID_Y_MAX)
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
    # the shape phase gpt_train gives the kernels: GPT-2 small, batch 4, causal at S 1024
    GH, GD = GPT2_SMALL["heads"], GPT2_SMALL["hidden"] // GPT2_SMALL["heads"]
    flash_case("gpt_causal", GPT_B, GH, SEQ, SEQ, GD, f32, True)
    flash_case("gpt_causal", GPT_B, GH, SEQ, SEQ, GD, bf16, True)
    # B * H past the grid's y limit: each call launches its kernel over
    # chunks of GRID_Y_MAX rows (65535 and 9 here)
    for dtype in (f32, bf16):
        flash_case("bh_65544", *BIG_BH, 128, 128, 64, dtype, False)
        torch.cuda.empty_cache()
    # the chunking with dropout and the causal mask, at a small size: chunks
    # of 5 rows, each kernel hashing its row as the chunk's first row plus
    # blockIdx.y
    grid_y_max, fa.GRID_Y_MAX = fa.GRID_Y_MAX, 5
    try:
        flash_case("grid_chunks_dropout", 2, 6, 256, 256, 64, f32, True, 0.1, 99)
        flash_case("grid_chunks_dropout", 2, 6, 256, 256, 64, bf16, True, 0.1, 99)
    finally:
        fa.GRID_Y_MAX = grid_y_max

    def flash_bound(kind, dtype, bh=TRAIN_B * TH, s_=TRAIN_S, d_=TD):
        """Least time for one kernel's work at (B * H, S, D), the slice's
        shape by default: each input read once and each output written
        once, or its matmul flops (4 / 6 / 8 x D per (row, key) pair) at
        the card's peak for the input type (float32: 3xTF32), whichever is
        larger."""
        esize = 4 if dtype == f32 else 2
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
        # the first designs, which the redesigns replaced
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

    def flash_big_timing(dtype):
        """The three kernels at ``bh_65544``'s shape, where each call
        launches over two chunks of rows, beside their bound."""
        shape = BIG_BH + (128, 64)
        q, k, v, do = qkv(shape, shape, dtype, SEED, on_card=True)
        out, lse = fa.flash_fwd(q, k, v)
        args = (q, k, v, do, lse, fa.flash_delta(out, do))
        res = {"fwd": time_ms(lambda: fa.flash_fwd(q, k, v), iters=10),
               "dq": time_ms(lambda: fa.flash_bwd_dq(*args), iters=10),
               "dkv": time_ms(lambda: fa.flash_bwd_dkv(*args), iters=10)}
        return {kind: {"ms": t, **flash_bound(kind, dtype, BIG_BH[0] * BIG_BH[1], 128, 64)}
                for kind, t in res.items()}

    big_t = {"float32": flash_big_timing(f32)}
    torch.cuda.empty_cache()
    big_t["bfloat16"] = flash_big_timing(bf16)
    torch.cuda.empty_cache()
    emit({"phase": "flash_attention_bh_65544_timing", "B": BIG_BH[0], "H": BIG_BH[1], "S": 128,
          "D": 64, "launches_per_call": len(fa.bh_chunks(BIG_BH[0] * BIG_BH[1])), **big_t,
          "card": card})
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

    # --- 5b. train_fit / 5c. gpt_train: fit, checkpoints, the decoder ---------
    fit_launches = train_fit_phase(dev, card, zero_counts)
    torch.cuda.empty_cache()
    gpt_launches = gpt_train_phase(dev, card, zero_counts,
                                   (peak_bw, peak_3xtf32, peak_bf16))
    torch.cuda.empty_cache()

    # --- 5d. zoo: every zoo model through fit, against float64 --------------
    zoo_launches = zoo_phase(dev, card, zero_counts)

    # --- 6. kernels -----------------------------------------------------------
    src = "flexflow_tpu_torch/ops/cuda/csrc/"
    tpu = "flexflow_tpu/ops/pallas/"

    def timed(t):
        return {k: t[k] for k in ("ms", "was_ms", "row_group_g1_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms") if k in t}

    # launches by path: each path's count, read just after it ran with every
    # count set to 0 just before it; "launches" is their sum
    paged_paths = {"serve": launches_serve, "gpt_train_serve": gpt_launches["serve"],
                   "zoo": zoo_launches["paged"]}
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": src + "paged_attention.cu",
        "replaces": tpu + "paged_attention.py:122",
        "launches": sum(paged_paths.values()),
        "launches_by_path": paged_paths,
        "launches_by_route": by_route_serve,
        "max_abs_err": worst["float32"],
        **timed(t_dec),
        "prefill": timed(t_pre),
        # a float32 q over bfloat16 pools (the engine's kv_dtype="bf16"),
        # which no serve arm runs
        "bfloat16": {"max_abs_err": worst["bfloat16"], **timed(t_bf["decode"]),
                     "prefill": timed(t_bf["prefill"])},
    }]
    for kind, name, replaces in (
            ("fwd", "flash_fwd", tpu + "flash_attention.py:177"),
            ("dq", "flash_bwd_dq", tpu + "flash_attention.py:407"),
            ("dkv", "flash_bwd_dkv", tpu + "flash_attention.py:460")):
        t32, t16 = flash_t["float32"][kind], flash_t["bfloat16"][kind]
        paths32 = {"train": train_launches["float32"][kind],
                   "train_fit": fit_launches["fit"][kind],
                   "train_fit_resume": fit_launches["resume"][kind],
                   "train_fit_eval": fit_launches["eval"][kind],
                   "gpt_train": gpt_launches["float32"][kind],
                   "zoo": zoo_launches[kind]}
        paths16 = {"train": train_launches["bfloat16"][kind],
                   "gpt_train": gpt_launches["bfloat16"][kind]}
        entry = {"name": name, "route": "cuda", "source": src + "flash_attention.cu",
                 "replaces": replaces, "launches": sum(paths32.values()),
                 "launches_by_path": paths32, "max_abs_err": flash_worst[kind],
                 **{k: t32[k] for k in ("ms", "was_ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms") if k in t32},
                 "bfloat16": {**{k: t16[k] for k in ("ms", "was_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms") if k in t16},
                              "launches": sum(paths16.values()),
                              "launches_by_path": paths16}}
        if kind == "fwd":
            entry["also_replaces"] = tpu + "flash_attention.py:98"
        kernels.append(entry)
    kernels.append({
        "name": "paged_attention_quant",
        "route": "cuda",
        "source": src + "paged_attention.cu",
        "replaces": tpu + "paged_attention.py:158",
        "also_replaces": tpu + "paged_attention.py:215",
        "launches": quant_launches["int8"],
        "launches_by_route": quant_lines["int8"]["launches_by_route"],
        "max_abs_err": quant_worst["int8"],
        **timed(t_quant["int8"]["decode"]),
        "prefill": timed(t_quant["int8"]["prefill"]),
        "fp8": {"launches": quant_launches["fp8"],
                "launches_by_route": quant_lines["fp8"]["launches_by_route"],
                "max_abs_err": quant_worst["fp8"],
                **timed(t_quant["fp8"]["decode"]), "prefill": timed(t_quant["fp8"]["prefill"])},
        "spec_launches": spec_launches,
    })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def spill_roundtrip(dev, card) -> None:
    """Phase ``kv_spill_roundtrip``: pools at GPT-2-small model shape (12
    layers, 12 heads, D 64), BS 16, in every pool format; a 500-position
    slot's pages (and scale rows) filled with seeded bits, spilled, and
    restored into a BS 8 and a BS 32 pool, where the gathered pages and
    scales must equal the spilled bits; the payload through ``ffkv/1``
    bytes and back must equal itself; a quantized payload into a float32
    pool (a full-precision one into an int8 pool) must be refused with
    the reservation released.  Spill and restore are host-timed copies
    (each ends in a synchronizing copy or ``synchronize``)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models.transformer import GPT2_SMALL
    from flexflow_tpu_torch.serve.kvcache import PagedKVCache, pool_bits
    from flexflow_tpu_torch.serve.wire import decode_handoff, encode_handoff, kv_payload_nbytes

    n_layers, heads = GPT2_SMALL["num_layers"], GPT2_SMALL["heads"]
    head_dim = GPT2_SMALL["hidden"] // heads

    def pool(kv_dtype, bs):
        return PagedKVCache(n_layers, heads, head_dim, slots=1, block_size=bs, max_seq_len=SEQ,
                            kv_dtype=kv_dtype, device=dev)

    def bits(t) -> bytes:  # a tensor's or an array's bytes
        if isinstance(t, torch.Tensor):
            return pool_bits(t).contiguous().view(torch.uint8).cpu().numpy().tobytes()
        return np.ascontiguousarray(t).tobytes()

    def dense(kv, n):  # the slot's pages and scales as bytes, layers stacked
        out = [bits(t) for t in kv.gather_dense(0, n)]
        return out + ([bits(t) for t in kv.gather_scales(0, n)] if kv.quantized else [])

    def payload_bits(p, names):
        return [np.stack([p["layers"][f"layer{i}"][k] for i in range(n_layers)]).tobytes()
                for k in names]

    length = 500
    for fmt in ("fp32", "bf16", "int8", "fp8"):
        src = pool(fmt, BS)
        src.reserve(0, length)
        row = torch.as_tensor(src.tables[0, :src.blocks_for(length)], dtype=torch.long,
                              device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for t in (src.cache_k, src.cache_v, src.scale_k, src.scale_v):
            if t is not None:
                u8 = pool_bits(t).view(torch.uint8)
                shape = (u8.shape[0], len(row)) + tuple(u8.shape[2:])
                u8[:, row] = torch.randint(0, 256, shape, generator=gen, device=dev,
                                           dtype=torch.uint8)
        before = dense(src, length)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = src.spill(0, length)  # ends in its one device-to-host copy
        spill_ms = (time.perf_counter() - t0) * 1e3
        names = ("k", "v", "sk", "sv") if src.quantized else ("k", "v")
        exact = payload_bits(payload, names) == before
        mb = kv_payload_nbytes(payload) / 1e6
        restore = {}
        for bs in (8, 32):
            dst = pool(fmt, bs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.restore(0, payload, length)
            torch.cuda.synchronize()
            restore[f"bs{bs}"] = {"ms": (time.perf_counter() - t0) * 1e3,
                                  "bit_exact": dense(dst, length) == before,
                                  "copies": dst.restore_copies, "bytes": dst.restore_bytes}
            del dst
        req = {"id": 0, "prompt": np.arange(length, dtype=np.int32), "max_new_tokens": 8,
               "tokens": [1], "kv_spill": payload}
        t0 = time.perf_counter()
        frame = encode_handoff(req)
        encode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = decode_handoff(frame)
        decode_ms = (time.perf_counter() - t0) * 1e3
        frame_ok = (payload_bits(back["kv_spill"], names) == before
                    and back["kv_spill"]["length"] == length
                    and back["kv_spill"].get("kv_dtype") == payload.get("kv_dtype"))
        other = pool("fp32" if src.quantized else "int8", BS)
        try:
            other.restore(0, payload, length)
        except ValueError as e:
            refused = str(e)
        else:
            refused = None
        released = other.owned(0) == () and other.restore_copies == 0
        ok = (exact and frame_ok and refused is not None and released
              and src.spill_copies == 1 and src.owned(0) == ()
              and all(r["bit_exact"] and r["copies"] == 1 for r in restore.values()))
        emit({"phase": "kv_spill_roundtrip", "kv_dtype": fmt,
              "pool_dtype": str(src.dtype).replace("torch.", ""), "layers": n_layers,
              "heads": heads, "head_dim": head_dim, "block_size": BS, "length": length,
              "payload_mb": mb, "spill_ms": spill_ms, "spill_mb_s": mb / spill_ms * 1e3,
              "spill_copies": src.spill_copies, "spill_bit_exact": exact,
              "restore": {k: {**r, "mb_s": mb / r["ms"] * 1e3} for k, r in restore.items()},
              "frame_mb": len(frame) / 1e6, "encode_ms": encode_ms, "decode_ms": decode_ms,
              "frame_round_trip_equal": frame_ok, "refused": refused,
              "refusal_released_reservation": released, "ok": ok, "card": card})
        if not ok:
            raise SystemExit(f"kv_spill_roundtrip {fmt}: spill/restore not bit-exact, the frame "
                             f"changed it, or the wrong-format restore was not refused")
        del src, other, payload, back
        torch.cuda.empty_cache()


def resilience_phases(dev, model, engine_kw, card, zero_counts, routes, margin_recorder,
                      margins_by_request) -> None:
    """Phases ``serve_preempt`` (float32 and int8 pools) and ``serve_drain``
    (float32 pools) on the serve phase's GPT-2-small model and engine.

    ``serve_preempt``: 8 batch requests (tenant ``batch``, prompts
    128-512, 48-64 new tokens) are submitted and admitted, and windows
    run through ``_window`` until at least 4 of them decode (at least 4
    windows); then 4 interactive requests (tenant ``vip``, prompts
    32-128, 16-32 new tokens) are submitted and ``run()`` serves
    everything.  Each interactive arrival preempts one decoding batch
    request, whose K/V spills and later restores.  Gates: 4 preemptions,
    each victim once, 4 spills and 4 restores; every request finishes
    with its full budget; one host sync per window; the paged kernel's
    launches (counted from the first window to the end of the run) only
    on the decode path (12 x decode steps) and the row-group path (12 x
    prefill dispatches); the allocator's invariants; and every stream
    equal to its reference (the 8 batch requests served alone on a fresh
    engine; each interactive request served alone) up to the first
    token whose relative top-2 margin in the reference is under
    ``SPEC_MARGIN``.

    ``serve_drain``: the same 8 batch requests through ``run(requests)``
    with the fault plan ``serve:sigterm@N`` (N = the preemption warm-up's
    window count, so that requests are decoding) and a ``drain_path``:
    the run must drain on the engine's own SIGTERM handler; the file must
    load (digest checked); a fresh engine's ``resume_from_drain`` and
    ``run`` finish every request; the streams before and after, together,
    must equal the undrained reference's by the same margin rule; a
    truncated copy of the file must be refused."""
    import os
    import tempfile

    import torch

    from flexflow_tpu_torch.model import CheckpointError
    from flexflow_tpu_torch.models.transformer import GPT2_SMALL
    from flexflow_tpu_torch.ops.cuda import paged_attention as pa
    from flexflow_tpu_torch.runtime.faults import FaultPlan, set_fault_plan
    from flexflow_tpu_torch.serve import (
        RequestState,
        ServeEngine,
        TrafficSpec,
        load_drain,
        save_drain,
        synthetic_requests,
    )

    layers = GPT2_SMALL["num_layers"]
    batch_spec = TrafficSpec(n_requests=8, seed=SEED, prompt_len=(128, 512), max_new=(48, 64),
                             vocab=VOCAB)
    vip_spec = TrafficSpec(n_requests=4, seed=SEED + 1, prompt_len=(32, 128), max_new=(16, 32),
                           vocab=VOCAB)

    def batch_reqs():
        rs = synthetic_requests(batch_spec)
        for r in rs:
            r.tenant = "batch"
        return rs

    def vip_reqs():
        rs = synthetic_requests(vip_spec)
        for j, r in enumerate(rs):
            r.id, r.tenant, r.tier = 100 + j, "vip", "interactive"
        return rs

    def first_divergence(got, ref, margins):
        """Requests whose stream leaves its reference: the first token that
        differs and the first reference token (up to there) whose relative
        top-2 margin is under SPEC_MARGIN (None: no such token, a failure)."""
        out = []
        for r in got:
            want = ref[r.id]
            k = next((i for i, (x, y) in enumerate(zip(r.tokens, want)) if x != y), None)
            if k is None:
                continue
            m = margins.get(r.id, {})
            out.append({"request": r.id, "token": k, "got": r.tokens[k], "want": want[k],
                        "first_small_margin_token": min(
                            (i for i in range(k + 1) if m.get(i, 1.0) < SPEC_MARGIN),
                            default=None)})
        return out

    def full(rs):
        return all(len(r.tokens) == r.max_new_tokens and all(0 <= t < VOCAB for t in r.tokens)
                   for r in rs)

    def tier_ttft(rep):
        return {t: {k: d[k] for k in ("finished", "preemptions", "ttft_p50_ms", "ttft_p99_ms",
                                      "tpot_p99_ms")} for t, d in rep.per_tier.items()}

    drain_ref = None
    for kv_dtype in ("fp32", "int8"):
        # the references: the batch requests alone, then each interactive one alone
        ref_eng = ServeEngine(model, kv_dtype=kv_dtype, **engine_kw)
        calls = margin_recorder(ref_eng)
        ref_batch = batch_reqs()
        ref_rep = ref_eng.run(ref_batch)
        ref_vip, vip_ttft = [], []
        for r in vip_reqs():
            rep_1 = ref_eng.run([r])
            ref_vip.append(r)
            vip_ttft.append(rep_1.ttft_p50_ms)
        margins = margins_by_request(calls)
        ref = {r.id: list(r.tokens) for r in ref_batch + ref_vip}
        if not (full(ref_batch) and full(ref_vip)):
            raise SystemExit(f"serve_preempt {kv_dtype}: a reference request fell short")
        del ref_eng
        torch.cuda.empty_cache()

        eng = ServeEngine(model, kv_dtype=kv_dtype, **engine_kw)
        zero_counts()  # every kernel count to 0 just before the path
        torch.cuda.synchronize()
        batch = []
        for r in batch_reqs():
            b = eng.submit(r.prompt, r.max_new_tokens, req_id=r.id, tenant=r.tenant)
            b.arrival_abs_s = eng._now()  # TTFT from submission, as the reference's
            batch.append(b)
        eng.sched.admit()
        warm = 0
        while warm < 4 or sum(b.state is RequestState.DECODE for b in batch) < 4:
            eng._window()
            warm += 1
        warm_decode, warm_prefill, warm_syncs = (eng.decode_steps, eng.prefill_dispatches,
                                                 eng.host_syncs)
        decoding = [b.id for b in batch if b.state is RequestState.DECODE]
        finished_early = [b.id for b in batch if b.state is RequestState.FINISHED]
        vip = [eng.submit(r.prompt, r.max_new_tokens, req_id=r.id, tenant=r.tenant,
                          tier=r.tier) for r in vip_reqs()]
        rep = eng.run()
        launches, by_route = pa.LAUNCHES, dict(pa.LAUNCHES_BY_ROUTE)
        by_pool = dict(pa.LAUNCHES_BY_POOL)
        decode_steps = warm_decode + rep.decode_steps
        dispatches = warm_prefill + rep.prefill_dispatches
        expect_route = routes(layers * decode_steps, layers * dispatches)
        diverged = first_divergence(batch + vip, ref, margins)
        eng.kv.check_invariants()
        victims = sorted(b.id for b in batch if b.preemptions)
        checks = {
            "preemptions_4": rep.preemptions == 4 and len(victims) == 4
            and all(b.preemptions <= 1 for b in batch),
            "victims_were_decoding": set(victims) <= set(decoding) and not finished_early,
            "spills_and_restores_4": rep.kv_spill_copies == rep.kv_restore_copies == 4,
            "full_budgets": full(batch) and full(vip) and rep.requests_finished == 12,
            "host_syncs_eq_windows": rep.host_syncs == rep.windows and warm_syncs == warm,
            "launches_by_route": by_route == expect_route and launches > 0
            and by_pool == {str(eng.kv.dtype).replace("torch.", ""): launches},
            "no_shared_write_hazard": eng.kv.shared_write_hazards() == [],
            "streams_by_margin_rule": all(d["first_small_margin_token"] is not None
                                          for d in diverged),
        }
        emit({"phase": "serve_preempt", "model": "GPT2_SMALL", "layers": layers,
              "kv_dtype": kv_dtype, "batch_traffic": batch_spec.identity,
              "interactive_traffic": vip_spec.identity, "warm_windows": warm,
              "decoding_at_arrival": decoding, "victims": victims,
              "preemptions": rep.preemptions, "kv_spill_copies": rep.kv_spill_copies,
              "kv_spill_bytes": rep.kv_spill_bytes, "kv_restore_copies": rep.kv_restore_copies,
              "kv_restore_bytes": rep.kv_restore_bytes, "tok_s": rep.tok_s, "wall_s": rep.wall_s,
              "windows": rep.windows, "host_syncs": rep.host_syncs,
              "per_tier": tier_ttft(rep),
              "reference": {"batch_tok_s": ref_rep.tok_s, "batch_wall_s": ref_rep.wall_s,
                            "batch_per_tier": tier_ttft(ref_rep),
                            "interactive_solo_ttft_ms": vip_ttft},
              "paged_attention_launches": launches, "launches_by_route": by_route,
              "expected_by_route": expect_route, "launches_by_pool": by_pool,
              "streams_identical": len(batch) + len(vip) - len(diverged),
              "diverged": diverged, "margin_threshold_rel": SPEC_MARGIN,
              "checks": checks, "ok": all(checks.values()), "card": card})
        if not all(checks.values()):
            raise SystemExit(f"serve_preempt {kv_dtype}: failed "
                             f"{[k for k, v in checks.items() if not v]}")
        if kv_dtype == "fp32":
            drain_ref = (ref, margins, warm, sorted(r.id for r in ref_batch))
        del eng
        torch.cuda.empty_cache()

    # --- serve_drain: SIGTERM at a window boundary, file, resume -------------
    ref, margins, warm, batch_ids = drain_ref
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drain.npz")
        eng = ServeEngine(model, drain_path=path, **engine_kw)
        eng2 = ServeEngine(model, **engine_kw)  # resumes; built (and warmed) before the count
        reqs = batch_reqs()
        zero_counts()
        torch.cuda.synchronize()
        set_fault_plan(FaultPlan.parse(f"serve:sigterm@{warm}", seed=SEED))
        try:
            rep = eng.run(reqs)
        finally:
            set_fault_plan(None)
        first = (rep.decode_steps, rep.prefill_dispatches)
        drained_ok = rep.drained and eng.sigterm_installed and os.path.exists(path)
        if not drained_ok:
            raise SystemExit(f"serve_drain: the run did not drain on SIGTERM (drained "
                             f"{rep.drained}, handler installed {eng.sigterm_installed})")
        file_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        payload = load_drain(path)  # digest checked
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        save_drain(os.path.join(tmp, "again.npz"), eng.drain_payload)
        save_ms = (time.perf_counter() - t0) * 1e3
        spilled = [d["id"] for d in payload["requests"] if d["kv_spill"] is not None]
        blob = open(path, "rb").read()
        torn = os.path.join(tmp, "torn.npz")
        with open(torn, "wb") as f:
            f.write(blob[: len(blob) // 2])
        try:
            load_drain(torn)
        except CheckpointError as e:
            torn_refused = str(e)[:160]
        else:
            torn_refused = None
        del eng
        restored = eng2.resume_from_drain(payload)
        rep2 = eng2.run()
        launches, by_route = pa.LAUNCHES, dict(pa.LAUNCHES_BY_ROUTE)
        expect_route = routes(layers * (first[0] + rep2.decode_steps),
                              layers * (first[1] + rep2.prefill_dispatches))
        done = [r for r in reqs if r.state is RequestState.FINISHED] + restored
        diverged = first_divergence(done, ref, margins)
        eng2.kv.check_invariants()
        checks = {
            "drained": drained_ok,
            "requests_spilled": len(spilled) > 0 and rep.kv_spill_copies == len(spilled),
            "restored": rep2.kv_restore_copies == len(spilled),
            "every_request_finishes": sorted(r.id for r in done) == batch_ids and full(done),
            "host_syncs_eq_windows": rep.host_syncs == rep.windows
            and rep2.host_syncs == rep2.windows,
            "launches_by_route": by_route == expect_route and launches > 0,
            "torn_file_refused": torn_refused is not None,
            "streams_by_margin_rule": all(d["first_small_margin_token"] is not None
                                          for d in diverged),
        }
        emit({"phase": "serve_drain", "model": "GPT2_SMALL", "kv_dtype": "fp32",
              "traffic": batch_spec.identity, "fault_plan": f"serve:sigterm@{warm}",
              "windows_before_drain": rep.windows, "finished_before_drain": rep.requests_finished,
              "requests_in_file": len(payload["requests"]), "requests_spilled": len(spilled),
              "kv_spill_bytes": rep.kv_spill_bytes, "file_mb": file_mb, "save_ms": save_ms,
              "load_ms": load_ms, "resumed_windows": rep2.windows, "resumed_tok_s": rep2.tok_s,
              "kv_restore_copies": rep2.kv_restore_copies,
              "paged_attention_launches": launches, "launches_by_route": by_route,
              "expected_by_route": expect_route, "torn_file_refused": torn_refused,
              "streams_identical": len(done) - len(diverged), "diverged": diverged,
              "checks": checks, "ok": all(checks.values()), "card": card})
        if not all(checks.values()):
            raise SystemExit(f"serve_drain: failed {[k for k, v in checks.items() if not v]}")
        del eng2


def train_fit_phase(dev, card, zero_counts) -> dict:
    """Phase ``train_fit``: BERT-Base on tokens (vocab 30522, batch 16, seq
    512, 64 classes, float32, Adam(1e-4)) through ``FFModel.fit``: 160
    samples, 2 epochs, shuffle seed 0.  The uninterrupted fit is the
    reference; a second run checkpoints every 6 steps and dies at the top
    of step 14 (the fault plan's ``device_loss``); a fresh model resumes
    from the step-12 checkpoint and must end bit for bit where the
    reference ended (weights, Adam moments, step).  The same fit with the
    plain attention core gives the loss curve to hold the flash one
    against; ``eval`` over 40 more samples (the last batch padded) is held
    against its rows recomputed on the host.  Returns the flash launches
    of the reference fit and of the resumed one."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from flexflow_tpu_torch.model import _checkpoint_digest
    from flexflow_tpu_torch.models.transformer import BERT_BASE
    from flexflow_tpu_torch.ops.cuda import flash_attention as fa
    from flexflow_tpu_torch.ops.cuda import paged_attention as pa
    from flexflow_tpu_torch.runtime.driver import FIT_METRICS, build_model, make_token_data
    from flexflow_tpu_torch.runtime.faults import FaultPlan, InjectedFault, set_fault_plan

    layers, n, n_eval = BERT_BASE["num_layers"], FIT_SAMPLES, FIT_EVAL
    xs, y = make_token_data(n + n_eval, TRAIN_S, BERT_BASE["hidden"], FIT_VOCAB, TRAIN_CLASSES,
                            SEED)
    train_x, train_y = [a[:n] for a in xs], y[:n]
    kw = dict(batch=TRAIN_B, seq=TRAIN_S, num_classes=TRAIN_CLASSES, vocab=FIT_VOCAB,
              lr=TRAIN_LR, seed=SEED, device=dev, compute_dtype="float32", metrics=FIT_METRICS,
              **BERT_BASE)
    fit_kw = dict(epochs=FIT_EPOCHS, shuffle=True, seed=SEED, verbose=False)
    nb = n // TRAIN_B
    steps = nb * FIT_EPOCHS

    def recording(model):
        """Keep each step's loss tensor as the fit loop takes the step (no
        host sync; read once at the end)."""
        ex, losses = model.executor, []
        step = ex.train_step

        def train_step(inputs, labels):
            loss, m = step(inputs, labels)
            losses.append(loss)
            return loss, m

        ex.train_step = train_step
        return losses

    def state(model):
        ex = model.executor
        named = ex.opt_state_by_name()
        tensors = ex.param_list() + [t for slot in ("m", "v") for ws in named[slot].values()
                                     for t in ws.values()]
        return tensors, named["step"], ex._step_count

    ref = build_model(use_flash=True, **kw)
    w0 = ref.get_weights()
    ref_losses = recording(ref)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # every kernel count to 0 just before the main path
    t0 = time.perf_counter()
    ref.fit(train_x, train_y, **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, paged_during = dict(fa.LAUNCHES), pa.LAUNCHES
    peak_mem = torch.cuda.max_memory_allocated()
    fit_syncs = ref.executor.host_syncs

    # eval: 40 samples in batches of 16, 16 and 8 (padded to 16), one sync
    s0 = ref.executor.host_syncs
    zero_counts()
    t0 = time.perf_counter()
    pe = ref.eval([a[n:] for a in xs], y[n:])
    eval_s = time.perf_counter() - t0
    eval_launches, eval_syncs = dict(fa.LAUNCHES), ref.executor.host_syncs - s0
    loss_sum, correct = 0.0, 0
    for start in range(0, n_eval, TRAIN_B):
        rows = min(TRAIN_B, n_eval - start)
        bx = [a[n + start:n + start + rows] for a in xs]
        bx = [np.concatenate([b, np.repeat(b[-1:], TRAIN_B - rows, axis=0)]) for b in bx]
        probs = ref.eval_batch(bx)[:rows].double().cpu().numpy()
        lab = y[n + start:n + start + rows, 0]
        loss_sum += float(-np.log(np.maximum(probs[np.arange(rows), lab], 1e-12)).sum())
        correct += int((probs.argmax(-1) == lab).sum())
    eval_rel = abs(pe.sparse_cce_loss - loss_sum) / abs(loss_sum)
    eval_ok = (eval_syncs == 1 and pe.train_all == n_eval and pe.train_correct == correct
               and eval_rel <= EVAL_TOL and eval_launches["fwd"] == layers * 3
               and eval_launches["dq"] == eval_launches["dkv"] == 0)

    tmp = tempfile.mkdtemp(prefix="ffckpt_")
    try:
        ck = os.path.join(tmp, "fit.npz")
        killed = build_model(use_flash=True, **kw)
        killed.set_weights(w0)
        set_fault_plan(FaultPlan.parse(f"device_loss@{FIT_KILL}"))
        died = None
        t0 = time.perf_counter()
        try:
            killed.fit(train_x, train_y, checkpoint_every=FIT_CKPT_EVERY, checkpoint_path=ck,
                       **fit_kw)
        except InjectedFault as e:
            died = str(e)
        finally:
            set_fault_plan(None)
        killed_s = time.perf_counter() - t0
        killed_steps, killed_syncs = killed.executor._step_count, killed.executor.host_syncs
        ckpt_bytes = os.path.getsize(ck)
        with np.load(ck) as z:
            manifest = json.loads(z["meta/manifest"].tobytes().decode())

        resumed = build_model(use_flash=True, **kw)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        resumed.fit(train_x, train_y, resume=ck, **fit_kw)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resume_launches = dict(fa.LAUNCHES)
        (ta, sa, ca), (tb, sb, cb) = state(ref), state(resumed)
        bit_identical = (sa == sb and ca == cb == steps and len(ta) == len(tb)
                         and all(torch.equal(a, b) for a, b in zip(ta, tb)))
        differing = sum(not torch.equal(a, b) for a, b in zip(ta, tb))

        # the save, the host snapshot alone, and the load, each timed apart
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat, _ = resumed._snapshot_checkpoint()
        snapshot_s = time.perf_counter() - t0
        del flat
        t0 = time.perf_counter()
        saved = resumed.save_checkpoint(os.path.join(tmp, "save.npz"))
        save_s = time.perf_counter() - t0
        save_bytes = os.path.getsize(saved)
        os.remove(saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        killed.load_checkpoint(ck)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del killed
        # two of the load's host stages alone: reading the archive, hashing it
        t0 = time.perf_counter()
        with np.load(ck) as z:
            arrays = {key: np.asarray(z[key]) for key in z.files}
        read_s = time.perf_counter() - t0
        arrays.pop("meta/manifest")
        t0 = time.perf_counter()
        _checkpoint_digest(arrays)
        digest_s = time.perf_counter() - t0
        del arrays
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    plain = build_model(use_flash=False, **kw)
    plain.set_weights(w0)
    plain_losses = recording(plain)
    flash_before = dict(fa.LAUNCHES)
    t0 = time.perf_counter()
    plain.fit(train_x, train_y, **fit_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if dict(fa.LAUNCHES) != flash_before:
        raise SystemExit("train_fit: use_flash=False launched a flash kernel")
    rl = torch.stack(ref_losses).cpu().tolist()
    pl = torch.stack(plain_losses).cpu().tolist()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rl, pl))
    ck_step = FIT_KILL // FIT_CKPT_EVERY * FIT_CKPT_EVERY  # the last checkpoint's step
    expect, expect_resume = layers * steps, layers * (steps - ck_step)
    cursor = {"epoch": ck_step // nb, "batch": ck_step % nb, "shuffle": True, "seed": SEED,
              "batches": nb}
    checks = {
        "launches_12_a_step": all(v == expect for v in launches.values()) and paged_during == 0,
        "resume_launches_12_a_step": all(v == expect_resume for v in resume_launches.values()),
        "killed_at_step": died is not None and "device_loss" in died and killed_steps == FIT_KILL,
        "checkpoint_cursor": manifest["step"] == ck_step and manifest["loader"] == cursor,
        "resume_bit_identical": bit_identical,
        "losses_vs_plain_core": (len(rl) == len(pl) == steps
                                 and all(math.isfinite(v) for v in rl + pl)
                                 and loss_rel <= TRAIN_LOSS_TOL["float32"]),
        "host_syncs_one_an_epoch": fit_syncs == FIT_EPOCHS,
        "eval_equals_rows": eval_ok,
    }
    line = {
        "phase": "train_fit", "model": "BERT_BASE", **BERT_BASE, "vocab": FIT_VOCAB,
        "batch": TRAIN_B, "seq": TRAIN_S, "classes": TRAIN_CLASSES, "compute_dtype": "float32",
        "optimizer": f"Adam({TRAIN_LR})", "samples": n, "epochs": FIT_EPOCHS, "shuffle": True,
        "steps": steps, "parameters": ref.num_parameters(), "fit_s": fit_s,
        "step_ms_mean": fit_s / steps * 1e3, "samples_per_s": n * FIT_EPOCHS / fit_s,
        "peak_mem_bytes": peak_mem, "host_syncs": fit_syncs,
        "host_syncs_per_epoch": fit_syncs / FIT_EPOCHS,
        "host_stall_ms": ref.executor.host_stall_s * 1e3, "losses": rl, "plain_losses": pl,
        "plain_fit_s": plain_s, "loss_rel_err_vs_plain": loss_rel,
        "loss_tol": TRAIN_LOSS_TOL["float32"], "flash_launches": launches,
        "expected_launches_each": expect,
        "eval": {"samples": pe.train_all, "loss": pe.sparse_cce_loss / pe.train_all,
                 "accuracy": pe.accuracy, "correct": pe.train_correct,
                 "recomputed_correct": correct, "loss_rel_err_vs_rows": eval_rel,
                 "host_syncs": eval_syncs, "flash_launches": eval_launches, "s": eval_s},
        "kill": {"fault": died, "at_step": killed_steps, "host_syncs": killed_syncs,
                 "checkpoint_every": FIT_CKPT_EVERY, "s": killed_s, "manifest_step":
                 manifest["step"], "cursor": manifest["loader"]},
        "checkpoint": {"bytes": ckpt_bytes, "save_ms": save_s * 1e3, "save_bytes": save_bytes,
                       "snapshot_ms": snapshot_s * 1e3, "load_ms": load_s * 1e3,
                       "read_ms": read_s * 1e3, "digest_ms": digest_s * 1e3},
        "resume": {"s": resume_s, "steps": steps - manifest["step"],
                   "flash_launches": resume_launches, "expected_launches_each": expect_resume,
                   "differing_tensors": differing},
        "checks": checks, "ok": all(checks.values()), "card": card,
    }
    emit(line)
    if not line["ok"]:
        raise SystemExit(f"train_fit: failed checks {[k for k, v in checks.items() if not v]}")
    return {"fit": launches, "resume": resume_launches, "eval": eval_launches}


def gpt_train_phase(dev, card, zero_counts, peak) -> dict:
    """Phase ``gpt_train``: ``GPT2_SMALL`` built through ``FFModel``
    (``gpt_decoder``: vocab 50257, batch 4, seq 1024), 3 train steps on
    next-token labels in float32 and in bfloat16, on the causal flash
    kernels (12 launches of each a step), the losses held against the same
    steps on the plain attention core; one more step traced for the flash
    kernels' device time a launch, beside each kernel's bound at this causal
    shape (``peak``: bytes/s, float32-accurate and bfloat16 flop/s; the
    flops of the visible pairs only).  Then the float32 model's weights go into the
    port's ``GPTDecoder`` and paged ``ServeEngine`` (float32 pool): its
    greedy streams must equal ``gpt_generate``'s (full-prefix forwards)
    up to the first token whose relative top-2 margin there is under
    ``SPEC_MARGIN``.  Returns the launches of each path."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models.transformer import (
        GPT2_SMALL, GPTDecoder, gpt_generate, load_jax_params,
    )
    from flexflow_tpu_torch.ops.cuda import flash_attention as fa
    from flexflow_tpu_torch.ops.cuda import paged_attention as pa
    from flexflow_tpu_torch.runtime.driver import build_gpt, make_gpt_batches
    from flexflow_tpu_torch.serve import ServeEngine
    from flexflow_tpu_torch.serve.scheduler import Request

    layers = GPT2_SMALL["num_layers"]
    batches = make_gpt_batches(GPT_STEPS, GPT_B, SEQ, VOCAB, SEED)
    out, trained = {}, None
    for cdt in ("float32", "bfloat16"):
        kw = dict(batch=GPT_B, seq=SEQ, vocab=VOCAB, compute_dtype=cdt, lr=TRAIN_LR,
                  seed=SEED, device=dev, **GPT2_SMALL)
        model = build_gpt(use_flash=True, **kw)
        plain = build_gpt(use_flash=False, **kw)
        plain.set_weights(model.get_weights())
        ex = model.executor
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()  # every kernel count to 0 just before the main path
        losses, times = [], []
        for ids, yb in batches:
            t0 = time.perf_counter()
            loss, _ = ex.train_step([ids], yb)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        launches, paged_during = dict(fa.LAUNCHES), pa.LAUNCHES
        peak_mem = torch.cuda.max_memory_allocated()
        plain_losses = [plain.executor.train_step([ids], yb)[0] for ids, yb in batches]
        if dict(fa.LAUNCHES) != launches:
            raise SystemExit("gpt_train: use_flash=False launched a flash kernel")
        del plain
        torch.cuda.empty_cache()
        rl = torch.stack(losses).cpu().tolist()
        pl = torch.stack(plain_losses).cpu().tolist()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rl, pl))
        ids, yb = batches[-1]
        prof = device_profile(lambda: ex.train_step([ids], yb), top=None)
        prof.pop("result")
        flash_us = {k["name"]: {"us": k["total_us"], "count": k["count"]}
                    for k in prof.pop("top_kernels_us") if "flash" in k["name"]}
        # each kernel's bound at this shape: (B, H, S, D) tensors read and
        # written once (fwd: q k v o + lse; dq: q k v do dq + lse, delta;
        # dkv: q k v do dk dv + lse, delta), or 4 / 6 / 8 x D flops a
        # visible (row, key) pair, S (S + 1) / 2 of them a head
        heads, d_ = GPT2_SMALL["heads"], GPT2_SMALL["hidden"] // GPT2_SMALL["heads"]
        mat = GPT_B * heads * SEQ * d_ * (4 if cdt == "float32" else 2)
        rows = GPT_B * heads * SEQ * 4
        pairs = GPT_B * heads * SEQ * (SEQ + 1) // 2
        rate = peak[1] if cdt == "float32" else peak[2]
        bounds = {}
        for kind, key, nbytes, fl in (("fwd", "flash_fwd", 4 * mat + rows, 4),
                                      ("dq", "flash_bwd_dq", 5 * mat + 2 * rows, 6),
                                      ("dkv", "flash_bwd_dkv", 6 * mat + 2 * rows, 8)):
            t_b, t_o = nbytes / peak[0] * 1e3, fl * d_ * pairs / rate * 1e3
            us = [v["us"] / v["count"] for n, v in flash_us.items() if key + "_" in n]
            bounds[kind] = {"ms": us[0] / 1e3 if us else None, "bound_ms": max(t_b, t_o),
                            "bound_by": "bytes" if t_b >= t_o else "operations"}
        expect = layers * GPT_STEPS
        ok = (all(math.isfinite(v) for v in rl + pl) and paged_during == 0
              and all(v == expect for v in launches.values())
              and loss_rel <= TRAIN_LOSS_TOL[cdt])
        emit({"phase": "gpt_train", "model": "GPT2_SMALL", **GPT2_SMALL, "vocab": VOCAB,
              "batch": GPT_B, "seq": SEQ, "causal": True, "compute_dtype": cdt,
              "optimizer": f"Adam({TRAIN_LR})", "steps": GPT_STEPS, "losses": rl,
              "plain_losses": pl, "loss_rel_err_vs_plain": loss_rel,
              "loss_tol": TRAIN_LOSS_TOL[cdt], "step_ms": [t * 1e3 for t in times],
              "peak_mem_bytes": peak_mem, "parameters": model.num_parameters(),
              "flash_launches": launches, "expected_launches_each": expect,
              "traced_step": {**prof, "flash_kernels_us": flash_us},
              "flash_ms_per_launch": bounds, "ok": ok, "card": card})
        if not ok:
            raise SystemExit(f"gpt_train {cdt}: launches {launches} (expected {expect} each), "
                             f"loss rel err vs plain {loss_rel}")
        out[cdt] = launches
        if cdt == "float32":
            trained = model
        del model, ex
        torch.cuda.empty_cache()

    # train -> serve: gpt_generate on the trained float32 model against the
    # paged engine over a float32 pool on the same weights
    prompt = batches[0][0][:, :GPT_PROMPT]
    t0 = time.perf_counter()
    gen = gpt_generate(trained, prompt, GPT_NEW)
    gen_s = time.perf_counter() - t0
    cur = np.zeros((GPT_B, SEQ), np.int32)
    cur[:, :GPT_PROMPT + GPT_NEW] = gen
    probs = trained.eval_batch([cur]).reshape(GPT_B, SEQ, -1)
    top2 = probs[:, GPT_PROMPT - 1:GPT_PROMPT + GPT_NEW - 1].topk(2, dim=-1).values
    margins = ((top2[..., 0] - top2[..., 1]) / top2[..., 0]).cpu().numpy()
    del probs, top2
    dec = GPTDecoder(seq=SEQ, vocab=VOCAB, seed=SEED, device=dev, **GPT2_SMALL)
    load_jax_params(dec, trained.get_weights())
    del trained
    torch.cuda.empty_cache()
    eng = ServeEngine(dec, attn="auto", slots=GPT_B, block_size=BS, prefill_chunk=CHUNK,
                      sync_every=4, device=dev)
    reqs = [Request(prompt=prompt[b].copy(), max_new_tokens=GPT_NEW, id=b)
            for b in range(GPT_B)]
    zero_counts()
    rep = eng.run(reqs)
    serve_launches, by_route = pa.LAUNCHES, dict(pa.LAUNCHES_BY_ROUTE)
    expect = layers * (rep.decode_steps + rep.prefill_dispatches)
    expect_route = {"single": 0, "split": layers * rep.prefill_dispatches,
                    "decode": layers * rep.decode_steps}
    streams, diverged = [], []
    for b, r in enumerate(reqs):
        want = gen[b, GPT_PROMPT:].tolist()
        got = [int(t) for t in r.tokens]
        small = [j for j, m in enumerate(margins[b]) if m < SPEC_MARGIN]
        cut = small[0] if small else GPT_NEW
        streams.append(got == want)
        if got != want:
            k = next(j for j, (u, v) in enumerate(zip(got, want)) if u != v)
            diverged.append({"request": b, "token": k, "engine": got[k], "generate": want[k],
                             "first_small_margin": small[0] if small else None,
                             "margin": float(margins[b][k])})
            if got[:cut] != want[:cut]:
                streams[-1] = None
    checks = {
        "streams": all(s is not None for s in streams) and rep.requests_finished == GPT_B,
        "launches": serve_launches == expect and by_route == expect_route,
        "host_syncs": rep.host_syncs == rep.windows,
    }
    emit({"phase": "gpt_train_serve", "model": "GPT2_SMALL", "kv_dtype": "fp32",
          "prompt_len": GPT_PROMPT, "new_tokens": GPT_NEW, "generate_s": gen_s,
          "generated": gen[:, GPT_PROMPT:].tolist(), "streams_equal": sum(bool(s) for s in streams),
          "requests": GPT_B, "diverged": diverged, "min_margin": float(margins.min()),
          "paged_attention_launches": serve_launches, "expected_launches": expect,
          "launches_by_route": by_route, "expected_by_route": expect_route,
          "host_syncs": rep.host_syncs, "windows": rep.windows, "checks": checks,
          "ok": all(checks.values()), "card": card})
    if not all(checks.values()):
        raise SystemExit(f"gpt_train_serve: failed checks {checks}; diverged {diverged}")
    out["serve"] = serve_launches
    return out


def zoo_phase(dev, card, zero_counts) -> dict:
    """Phase ``zoo``: every model of the zoo through ``FFModel.fit`` on the
    card, float32, 3 SGD steps of batch 64 at its published widths
    (``ZOO_CASES``), held against a float64 run of the same port model
    from the same weights and batches: the 3 losses within
    ``ZOO_LOSS_TOL`` relative.  Each line reports the step times,
    samples/s and peak memory of the float32 run beside the card.  Every
    kernel count is set to 0 just before each float32 fit and read just
    after it: the zoo launches no flash or paged kernel.  A last line,
    ``zoo_batch_norm``, trains a small conv -> batch_norm model the same
    way (no zoo model has BatchNorm) and checks that its running stats
    moved and match the float64 run's.  Returns the kernel launches over
    the zoo's float32 fits.  ``peak_mem_bytes`` is the peak of the float32
    fit, its model's weights and the data placed included;
    ``resident_before_fit_bytes`` what was allocated when it began."""
    import gc

    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.ops.cuda import flash_attention as fa
    from flexflow_tpu_torch.ops.cuda import paged_attention as pa
    from flexflow_tpu_torch.optimizer import SGDOptimizer
    from flexflow_tpu_torch.runtime.driver import build_zoo, make_zoo_data

    def fit(model, xs, y):
        """3 steps of ``fit``, one epoch; each step's loss and its time
        (the wrapper synchronises after each step to time it)."""
        ex = model.executor
        step = ex.train_step
        losses, times = [], []

        def timed_step(*args):
            t0 = time.perf_counter()
            loss, m = step(*args)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            return loss, m

        ex.train_step = timed_step
        try:
            model.fit(xs, y, batch_size=ZOO_BATCH, epochs=1, verbose=False)
        finally:
            del ex.train_step  # the class's method again, and no reference cycle
        return [float(v) for v in losses], times

    launches = {"fwd": 0, "dq": 0, "dkv": 0, "paged": 0}
    for label, name, kw in ZOO_CASES:
        model = build_zoo(name, batch=ZOO_BATCH, device=dev, **kw)
        start = model.get_weights()  # the float64 run starts from these
        xs, y = make_zoo_data(name, model, ZOO_STEPS * ZOO_BATCH)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()  # every kernel count to 0 just before the main path
        losses, times = fit(model, xs, y)
        counts = dict(fa.LAUNCHES, paged=pa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for k in launches:
            launches[k] += counts[k]
        del model
        gc.collect()
        torch.cuda.empty_cache()
        wide = build_zoo(name, batch=ZOO_BATCH, device=dev, compute_dtype="float64", **kw)
        wide.set_weights(start)
        ref, _ = fit(wide, xs, y)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        step_s = float(np.median(times[1:]))
        ok = (len(losses) == ZOO_STEPS and all(math.isfinite(v) for v in losses + ref)
              and rel <= ZOO_LOSS_TOL and not any(counts.values()))
        line = {"phase": "zoo", "model": label, "builder": name, **kw,
                "batch": ZOO_BATCH, "steps": ZOO_STEPS, "optimizer": "SGD",
                "loss_type": wide.executor.loss_fn.__name__,
                "parameters": wide.num_parameters(), "losses": losses,
                "float64_losses": ref, "loss_rel_err_vs_float64": rel, "loss_tol": ZOO_LOSS_TOL,
                "step_ms": [t * 1e3 for t in times], "step_ms_median_after_first": step_s * 1e3,
                "samples_per_s": ZOO_BATCH / step_s, "peak_mem_bytes": peak,
                "resident_before_fit_bytes": resident, "kernel_launches": counts, "ok": ok,
                "card": card}
        emit(line)
        if not ok:
            raise SystemExit(f"zoo {label}: {line}")
        del wide, xs, y
        gc.collect()
        torch.cuda.empty_cache()

    # executor state on the card: conv -> batch_norm -> pool -> dense
    def bn_model(dtype):
        m = FFModel(FFConfig(batch_size=ZOO_BATCH, compute_dtype=dtype, device=str(dev)))
        t = m.create_tensor((ZOO_BATCH, 3, 32, 32))
        t = m.batch_norm(m.conv2d(t, 64, 3, 3, 1, 1, 1, 1, name="conv"), name="bn")
        t = m.pool2d(t, 32, 32, 1, 1, 0, 0, name="pool")
        m.softmax(m.dense(m.flat(t), 10, name="head"))
        m.compile(SGDOptimizer(lr=0.01))
        return m

    model, wide = bn_model("float32"), bn_model("float64")
    wide.set_weights(model.get_weights())
    before = model.get_weights()["bn"]
    rng = np.random.default_rng(SEED)
    xs = [(rng.normal(size=(ZOO_STEPS * ZOO_BATCH, 3, 32, 32)) * 2 + 1).astype(np.float32)]
    y = rng.integers(0, 10, size=(ZOO_STEPS * ZOO_BATCH, 1)).astype(np.int32)
    losses, _ = fit(model, xs, y)
    ref, _ = fit(wide, xs, y)
    after, after64 = model.get_weights()["bn"], wide.get_weights()["bn"]
    moved = {k: float(np.abs(after[k] - before[k]).max()) for k in ("running_mean", "running_var")}
    stats_err = max(float(np.abs(after[k] - after64[k]).max()) for k in after)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    ok = (rel <= ZOO_LOSS_TOL and min(moved.values()) > 1e-3 and stats_err <= 1e-4
          and sorted(model.executor.state["bn"]) == ["running_mean", "running_var"])
    line = {"phase": "zoo_batch_norm", "losses": losses, "float64_losses": ref,
            "loss_rel_err_vs_float64": rel, "running_stats_moved": moved,
            "running_stats_max_abs_err_vs_float64": stats_err, "ok": ok, "card": card}
    emit(line)
    if not ok:
        raise SystemExit(f"zoo_batch_norm: {line}")
    del model, wide
    torch.cuda.empty_cache()
    return launches


def device_profile(fn, top=10, host_top=0) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall time, the union of device
    intervals (busy time), the idle share, and the ``top`` kernels with the
    most device time (all of them for None); where the paged-attention
    kernel ran, its device time by route (``paged_us_by_route``); with
    ``host_top``, that many host operations with the most self time on the
    host as well.  ``result`` is what ``fn`` returned."""
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
    # the paged-attention kernel's device time by route: the single pass,
    # the row-group path (split and combine kernels, two a call) and the
    # decode path (one kernel a call)
    paged = {}
    for name, (tot, cnt) in by_name.items():
        route = ("single" if "paged_attention_kernel" in name else
                 "decode" if "paged_decode" in name else
                 "split" if "paged_split" in name or "paged_combine" in name else None)
        if route:
            us, n = paged.get(route, (0.0, 0))
            paged[route] = (us + tot, n + cnt)
    extra = {}
    if paged:
        extra["paged_us_by_route"] = {r: {"us": us, "kernels": n} for r, (us, n) in paged.items()}
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_top]
        extra["top_host_ops_us"] = [{"name": a.key[:80], "self_us": a.self_cpu_time_total,
                                     "count": a.count} for a in ops]
    return {**extra, "wall_us": wall_us, "device_busy_us": busy if spans else None,
            "device_idle_share": 1.0 - busy / wall_us if spans else None,
            "device_events": len(spans),
            "top_kernels_us": [{"name": n[:80], "total_us": t, "count": c}
                               for n, (t, c) in top],
            "result": result}


if __name__ == "__main__":
    sys.exit(main())
