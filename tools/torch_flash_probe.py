#!/usr/bin/env python3
"""Build the port's flash-attention kernels on a CUDA card, hold each
against its plain version on a set of shapes, and time them.

    python3 tools/torch_flash_probe.py

Prints the ``ptxas`` register and spill report of every kernel, then one
JSON line per case: the relative errors (max |kernel - plain| / max
|plain|) of O, lse, dQ, dK and dV, and the mean ms per launch of each
kernel over 20 back-to-back launches (no L2 flush between them, unlike
``chip_smoke.py``).  A quick check for kernel work; ``chip_smoke.py``
holds the tolerances and the main path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from flexflow_tpu_torch.ops import cuda as ffcuda  # noqa: E402
from flexflow_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

# (B, H, Sq, Sk, D, causal, dropout rate, seed, dtype)
CASES = [
    (16, 12, 512, 512, 64, False, 0.0, 0, torch.bfloat16),
    (16, 12, 512, 512, 128, False, 0.0, 0, torch.bfloat16),
    (16, 12, 512, 512, 64, False, 0.0, 0, torch.float32),
    (2, 4, 128, 256, 64, True, 0.0, 0, torch.bfloat16),
    (2, 4, 384, 256, 128, True, 0.0, 0, torch.bfloat16),
    (2, 12, 2048, 2048, 64, True, 0.0, 0, torch.bfloat16),
    (2, 4, 512, 512, 128, True, 0.1, -7, torch.bfloat16),
    (2, 4, 512, 256, 64, True, 0.2, 5, torch.float32),
]


def ptxas_report() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([ffcuda.find_nvcc(), *ffcuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            os.path.join(tmp, "probe.so"),
                            str(ffcuda.CSRC_DIR / "flash_attention.cu")],
                           capture_output=True, text=True, check=True)
    name = None
    for line in r.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line and name:
            print(json.dumps({"kernel": name, "ptxas": line.split(":", 1)[1].strip()}))


def mean_ms(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def case(B, H, sq, sk, d, causal, rate, seed, dtype) -> dict:
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(B, H, sq, d, generator=g).to("cuda", dtype) for _ in range(2))
    k, v = (torch.randn(B, H, sk, d, generator=g).to("cuda", dtype) for _ in range(2))
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
    rel = {}
    for name, a, b in (("o", out, p_out), ("lse", lse, p_lse), ("dq", dq, p_dq),
                       ("dk", dk, p_dk), ("dv", dv, p_dv)):
        a, b = a.float(), b.float()
        if name == "lse":  # rows that see a key
            a, b = a[b > -1e29], b[b > -1e29]
        rel[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    bwd = (q, k, v, do, lse, delta, *args)
    return {"B": B, "H": H, "Sq": sq, "Sk": sk, "D": d, "causal": causal, "dropout": rate,
            "dtype": str(dtype).replace("torch.", ""), "rel_err": rel,
            "ms": {"fwd": mean_ms(lambda: fa.flash_fwd(q, k, v, *args)),
                   "dq": mean_ms(lambda: fa.flash_bwd_dq(*bwd)),
                   "dkv": mean_ms(lambda: fa.flash_bwd_dkv(*bwd))}}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_probe: needs a CUDA device", file=sys.stderr)
        return 1
    ffcuda.build(["flash_attention"])
    ptxas_report()
    for c in CASES:
        print(json.dumps(case(*c)), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
