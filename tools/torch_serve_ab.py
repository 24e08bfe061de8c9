#!/usr/bin/env python3
"""Time one tree of the PyTorch/CUDA port on a CUDA card, so that two trees
(a change and its parent) can be compared in one session on one card.

    python3 tools/torch_serve_ab.py [--root DIR] [--label NAME]

``--root`` is the directory whose ``flexflow_tpu_torch`` is imported (by
default this checkout); the timer, the inputs and the traffic are this
script's, so the two trees are measured alike.  Run it as parent, change,
change, parent, one process each.  Prints, one JSON line each:

* ``paged_time``: the paged-attention kernel at the serve shapes (8
  lanes, 12 heads, D 64, BS 16, 64 pages), decode (G 1 at 512), verify
  (G 4 at 512) and prefill (G 32 at 480) over float32, bfloat16, int8
  and float8 pools with a float32 q: median device ms of 30 calls, the
  L2 flushed before each, the card spinning while the host queues the
  call;
* ``paged_host``: the host's time to queue one call of the wrapper (mean
  over 100 calls queued behind a spinning card), per path and pool;
* ``serve``: ``ServeEngine.run`` at GPT-2-small width and depth (random
  weights from seed 0) on ``chip_smoke.py``'s 16 requests, float32 pools
  (``plain``) and int8 pools with speculative decoding (``spec``, k 3, a
  6-layer draft): tokens per second and wall seconds;
* ``profile``: the ``plain`` arm (float32 pools) traced on
  ``chip_smoke.py``'s profile traffic (8 requests): wall and device-busy
  time, the idle share, the paged-attention kernel's device time by route
  (``paged_us_by_route``: the single pass; the row-group path's split and
  combine kernels; the decode path's kernel, where the tree has one) and
  the kernels with the most device time;
* ``profile_spec``: the ``spec`` arm traced on ``chip_smoke.py``'s profile
  traffic (8 requests): wall and device-busy time, the idle share, the
  device time of the paged-attention kernels (``paged_us``) and of the
  row-group and decode paths among them (``split_us``, ``decode_us``,
  zero where the tree has none),
  wall and busy time per speculative macro step, and the host operations
  with the most self time on the host.

The card's name and power limit come last.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SPEC_K, SPEC_DRAFT = 3, 6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() if "--root" in args else HERE
    label = args[args.index("--label") + 1] if "--label" in args else root.name
    sys.path.insert(0, str(root))
    smoke_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(smoke_spec)
    smoke_spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from flexflow_tpu_torch.models.transformer import GPT2_SMALL, GPTDecoder
    from flexflow_tpu_torch.ops import cuda as ffcuda
    from flexflow_tpu_torch.ops.cuda import paged_attention as pa
    from flexflow_tpu_torch.serve import ServeEngine, TrafficSpec, synthetic_requests
    from flexflow_tpu_torch.serve.kvcache import pool_bits, quantize_kv

    package = Path(sys.modules["flexflow_tpu_torch"].__file__).resolve()
    if root not in package.parents:
        raise SystemExit(f"torch_serve_ab: imported {package}, not a package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(smoke.DEVICE)
    ffcuda.build()
    B, H, D, BS, MB = smoke.B, smoke.H, smoke.D, smoke.BS, smoke.MB
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)

    def time_ms(fn, iters=30):
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            torch.cuda._sleep(smoke.SPIN_CYCLES)
            flush.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    # --- the paged kernel's paths, both trees on the same inputs --------------
    rng = np.random.default_rng(0)
    N = B * MB + 1
    x = [torch.from_numpy(rng.standard_normal((N, BS, H, D)).astype(np.float32)).to(dev)
         for _ in range(2)]
    bt = torch.from_numpy((rng.permutation(N - 1) + 1)[: B * MB].reshape(B, MB)
                          .astype(np.int32)).to(dev)
    pools = {"float32": ([t.permute(0, 2, 1, 3).contiguous() for t in x], (None, None))}
    pools["bfloat16"] = ([p.bfloat16() for p in pools["float32"][0]], (None, None))
    for kv_dtype in ("int8", "fp8"):
        qs = [quantize_kv(t, kv_dtype) for t in x]
        pools[kv_dtype] = ([pool_bits(qx).permute(0, 2, 1, 3).contiguous().view(qx.dtype)
                            for qx, _ in qs], tuple(sc.contiguous() for _, sc in qs))
    def host_us(fn, n=100):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(smoke.SPIN_CYCLES * 20)  # the card stays busy while the host queues
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    for G, ctx, name in ((1, 512, "decode"), (4, 512, "verify"), (32, 480, "prefill")):
        q = torch.from_numpy(rng.standard_normal((B, G, H, D)).astype(np.float32)).to(dev)
        pos = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        line = {"phase": "paged_time", "tree": label, "path": name, "G": G, "context": ctx}
        host = {"phase": "paged_host", "tree": label, "path": name, "G": G}
        for pool_name, ((pk, pv), (sk, sv)) in pools.items():
            extra = () if sk is None else (sk, sv)

            def call():
                return pa.paged_attention(q, pk, pv, pos, bt, None, *extra)
            line[pool_name] = time_ms(call)
            host[pool_name] = host_us(call)
        emit(line)
        emit(host)

    # --- serve arms and the speculative arm's trace ---------------------------
    model = GPTDecoder(seq=smoke.SEQ, vocab=smoke.VOCAB, seed=smoke.SEED, device=dev,
                       **GPT2_SMALL)
    engine_kw = dict(slots=B, block_size=BS, prefill_chunk=smoke.CHUNK, sync_every=4,
                     device=dev)
    spec = TrafficSpec(n_requests=16, seed=smoke.SEED, prompt_len=(128, 512),
                       max_new=(32, 64), vocab=smoke.VOCAB)
    arms = {"plain": {}, "spec": dict(kv_dtype="int8", spec_k=SPEC_K,
                                      spec_draft_layers=SPEC_DRAFT)}
    for arm, kw in arms.items():
        e = ServeEngine(model, **engine_kw, **kw)
        torch.cuda.synchronize()
        r = e.run(synthetic_requests(spec))
        emit({"phase": "serve", "tree": label, "arm": arm, "tok_s": r.tok_s,
              "wall_s": r.wall_s, "decode_steps": r.decode_steps,
              "prefill_dispatches": r.prefill_dispatches})
        del e
        torch.cuda.empty_cache()

    prof_spec = TrafficSpec(n_requests=8, seed=smoke.SEED + 1, prompt_len=(128, 512),
                            max_new=(32, 64), vocab=smoke.VOCAB)
    # a fresh engine: a second run of the same prompts on one engine would
    # find them in its prefix cache and skip most of their prefill
    e = ServeEngine(model, **engine_kw)
    prof = smoke.device_profile(lambda: e.run(synthetic_requests(prof_spec)))
    r = prof.pop("result")
    emit({"phase": "profile", "tree": label, "arm": "plain", **prof,
          "windows": r.windows, "decode_steps": r.decode_steps,
          "prefill_dispatches": r.prefill_dispatches})
    del e
    torch.cuda.empty_cache()
    e = ServeEngine(model, **engine_kw, **arms["spec"])
    prof = smoke.device_profile(lambda: e.run(synthetic_requests(prof_spec)), top=None,
                                host_top=15)
    r = prof.pop("result")
    macros = r.decode_steps // (SPEC_K + 1)
    kernels = prof.pop("top_kernels_us")
    paged_us = sum(k["total_us"] for k in kernels if "paged_" in k["name"])
    split_us = sum(k["total_us"] for k in kernels
                   if "paged_split" in k["name"] or "paged_combine" in k["name"])
    decode_us = sum(k["total_us"] for k in kernels if "paged_decode" in k["name"])
    emit({"phase": "profile_spec", "tree": label, **prof, "paged_us": paged_us,
          "split_us": split_us, "split_share_of_busy": split_us / prof["device_busy_us"],
          "decode_us": decode_us,
          "macros": macros, "prefill_dispatches": r.prefill_dispatches,
          "wall_us_per_macro": prof["wall_us"] / macros,
          "busy_us_per_macro": prof["device_busy_us"] / macros,
          "top_kernels_us": kernels[:6]})
    emit({"card": smoke.card_line(), "package": os.fspath(package.parent)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
