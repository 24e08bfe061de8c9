"""``python -m flexflow_tpu_torch --serve``: the serving driver.

Counterpart of ``flexflow_tpu/serve/driver.py`` for one colocated
engine.  It builds a :class:`~flexflow_tpu_torch.models.transformer.GPTDecoder`
with random weights from ``--seed``, stands up the continuous-batching
:class:`~flexflow_tpu_torch.serve.engine.ServeEngine` on ``--device``,
replays a seeded synthetic open-loop workload against it and prints ONE
JSON summary line (plus the ``--metrics-out`` ``ffmetrics/1`` stream).
Defaults are smoke-sized; pass the model flags for a real width::

    python -m flexflow_tpu_torch --serve --hidden 768 --heads 12 \\
        --ff-dim 3072 --num-layers 12 --vocab 50257 --seq 1024 \\
        --requests 16 --prompt-len 128:512 --max-new 32:64 \\
        --serve-slots 8 --metrics-out serve.jsonl

``--device cpu`` runs the plain PyTorch path on the CPU.  The quantized
and speculative arms take the JAX driver's flags: ``--serve-kv-dtype
fp32|bf16|int8|fp8``, ``--serve-weight-dtype fp32|int8``,
``--serve-spec-k K`` and ``--serve-spec-draft-layers N``.

Multi-tenant traffic and preemption: ``--tenants N --shared-prefix P
--interactive-frac F`` give per-tenant system prompts and put the first
``ceil(N x F)`` tenants on the interactive tier, whose requests preempt
batch requests when every slot is held; ``--deadline-ms D`` stamps
every request with a queue-wait deadline; ``--serve-prefix-sharing
off`` turns prefix sharing off.  Resilience: ``--serve-drain-file F``
is where a SIGTERM drain writes its ``ffdrain/1`` file, ``--resume-drain
F`` queues a drain file's requests before the run; ``--serve-watchdog-s
S`` counts windows slower than S seconds; ``--serve-shed-windows N``
sheds the queued batch tier after N consecutive windows over
``--serve-slo-ms`` per token; ``--fault-plan SPEC|FILE`` installs a
serve-site fault plan (seeded by ``--seed``) for the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from flexflow_tpu_torch.serve.kvcache import KV_DTYPES

__all__ = ["main"]


def _int_pair(s: str) -> tuple:
    lo, _, hi = s.partition(":")
    return (int(lo), int(hi or lo))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m flexflow_tpu_torch --serve")
    m = p.add_argument_group("model")
    m.add_argument("--hidden", type=int, default=64)
    m.add_argument("--heads", type=int, default=4)
    m.add_argument("--ff-dim", type=int, default=128)
    m.add_argument("--num-layers", type=int, default=2)
    m.add_argument("--vocab", type=int, default=256)
    m.add_argument("--seq", type=int, default=64)
    m.add_argument("--seed", type=int, default=0, help="weight seed")
    t = p.add_argument_group("traffic")
    t.add_argument("--requests", type=int, default=16)
    t.add_argument("--rate", type=float, default=0.0, help="arrivals/s; 0 = all at t=0")
    t.add_argument("--prompt-len", type=_int_pair, default=(4, 12), help="LO:HI")
    t.add_argument("--max-new", type=_int_pair, default=(4, 24), help="LO:HI")
    t.add_argument("--traffic-seed", type=int, default=0)
    t.add_argument("--tenants", type=int, default=1)
    t.add_argument("--shared-prefix", type=int, default=0, help="system-prompt tokens a tenant")
    t.add_argument("--interactive-frac", type=float, default=0.0,
                   help="share of tenants on the interactive tier")
    t.add_argument("--deadline-ms", type=float, default=0.0,
                   help="queue-wait deadline of every request; 0 = none")
    e = p.add_argument_group("engine")
    e.add_argument("--serve-slots", type=int, default=4)
    e.add_argument("--serve-block-size", type=int, default=16)
    e.add_argument("--serve-prefill-chunk", type=int, default=32)
    e.add_argument("--serve-sync-every", type=int, default=4)
    e.add_argument("--serve-attn", default="auto", choices=("auto", "paged", "gather"))
    e.add_argument("--serve-kv-dtype", default="fp32", choices=KV_DTYPES)
    e.add_argument("--serve-weight-dtype", default="fp32", choices=("fp32", "int8"))
    e.add_argument("--serve-spec-k", type=int, default=0,
                   help="draft tokens per speculative step; 0 = off")
    e.add_argument("--serve-spec-draft-layers", type=int, default=0,
                   help="draft depth; 0 = half the layers")
    e.add_argument("--serve-prefix-sharing", default="on", type=lambda v: v.lower(),
                   choices=("on", "off", "1", "0", "true", "false", "yes", "no"))
    e.add_argument("--serve-watchdog-s", type=float, default=0.0,
                   help="count windows slower than this; 0 = off")
    e.add_argument("--serve-shed-windows", type=int, default=0,
                   help="shed the batch queue after N windows over the SLO; 0 = off")
    e.add_argument("--serve-slo-ms", type=float, default=50.0, help="per-token SLO")
    e.add_argument("--serve-drain-file", default=None, help="where a SIGTERM drain writes")
    e.add_argument("--resume-drain", default=None, help="a drain file to resume before the run")
    e.add_argument("--fault-plan", default=None, help="serve-site fault spec or JSON file")
    e.add_argument("--metrics-out", default=None)
    e.add_argument("--device", default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from flexflow_tpu_torch.models.transformer import GPTDecoder
    from flexflow_tpu_torch.ops.cuda import paged_attention as pa
    from flexflow_tpu_torch.runtime.faults import FaultPlan, get_fault_plan, set_fault_plan
    from flexflow_tpu_torch.serve import ServeEngine, TrafficSpec, load_drain, synthetic_requests

    model = GPTDecoder(
        seq=args.seq, hidden=args.hidden, heads=args.heads, ff_dim=args.ff_dim,
        num_layers=args.num_layers, vocab=args.vocab, seed=args.seed, device=args.device,
    )
    engine = ServeEngine(
        model, slots=args.serve_slots, block_size=args.serve_block_size,
        prefill_chunk=args.serve_prefill_chunk, sync_every=args.serve_sync_every,
        metrics_out=args.metrics_out, attn=args.serve_attn, device=args.device,
        kv_dtype=args.serve_kv_dtype, weight_dtype=args.serve_weight_dtype,
        spec_k=args.serve_spec_k, spec_draft_layers=args.serve_spec_draft_layers,
        prefix_sharing=args.serve_prefix_sharing in ("on", "1", "true", "yes"),
        watchdog_s=args.serve_watchdog_s, shed_after_windows=args.serve_shed_windows,
        slo_ms=args.serve_slo_ms, drain_path=args.serve_drain_file,
    )
    resumed = engine.resume_from_drain(load_drain(args.resume_drain)) if args.resume_drain else []
    spec = TrafficSpec(
        n_requests=args.requests, seed=args.traffic_seed, rate_rps=args.rate,
        prompt_len=args.prompt_len, max_new=args.max_new, vocab=args.vocab,
        tenants=args.tenants, shared_prefix=args.shared_prefix,
        interactive_frac=args.interactive_frac,
    )
    reqs = synthetic_requests(spec)
    for r in reqs:
        # clamp budgets to the model's position range so every request serves
        r.max_new_tokens = max(1, min(r.max_new_tokens, args.seq - r.prompt_len))
        if args.deadline_ms > 0:
            r.deadline_ms = args.deadline_ms
    plan = None
    if args.fault_plan:
        plan = (FaultPlan.from_file(args.fault_plan) if os.path.exists(args.fault_plan)
                else FaultPlan.parse(args.fault_plan, seed=args.seed))
    launches0 = pa.LAUNCHES
    old_plan = get_fault_plan()
    set_fault_plan(plan if plan is not None else old_plan)
    try:
        report = engine.run(reqs)
    finally:
        set_fault_plan(old_plan)
    out = {
        "metric": "serve_demo",
        "serve_traffic": spec.identity,
        "model": f"gpt L{args.num_layers} h{args.hidden} v{args.vocab} s{args.seq}",
        "device": str(engine.device),
        "slots": args.serve_slots,
        "block_size": engine.kv.block_size,
        "num_blocks": engine.kv.num_blocks,
        "sync_every": engine.sync_every,
        "attn_kernel": engine.attn_kernel,
        "attn_launches": pa.LAUNCHES - launches0,
        "kv_dtype": engine.kv.kv_dtype,
        "weight_dtype": engine.weight_dtype,
        "kv_bytes_per_token": engine.kv.bytes_per_token,
        "resumed_requests": len(resumed),
        "fault_plan": plan.identity if plan is not None else None,
        **report.to_dict(),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
