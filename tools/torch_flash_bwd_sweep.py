#!/usr/bin/env python3
"""Where the flash backward's time goes on a CUDA card: rebuild
``csrc/flash_attention.cu`` with one of the backward redesign's constants
changed, or with one of its steps cut out, and time dQ and dK/dV beside
the source as it is.

    python3 tools/torch_flash_bwd_sweep.py [--dtype bfloat16|float32]

Each variant is the source with one textual change (every occurrence of
each replaced text); all of them build at once (``nvcc -Xptxas -v``) into
a temporary directory and are loaded in turn in place of the package's
library.  bfloat16 variants (the ``wgmma`` redesign, the default):

* ``as_is``: the source unchanged;
* ``warpgroups_1``: one warpgroup of 64 rows per block, not two;
* ``stages_2``: a ring of two stages, not three;
* ``dq_uncapped``: dQ at D 64 without its cap of 128 registers a thread
  (one block per SM);
* ``dkv_q_tile_32``: dK/dV at D 64 on 32-query tiles, as at D 128;
* ``cut_exp``: p is its exponent's argument, no ``expf`` (timing only);
* ``cut_ds``: no ds step at all, the scores go to the gradient products
  as they are (timing only).

float32 variants (the 3xTF32 redesign; ``as_is``, ``cut_exp`` and
``cut_ds`` as above):

* ``stages_3``: a ring of three stages, not two (one block per SM);
* ``warps_8``: eight warps of 16 rows a block, not four (one block per SM);
* ``split_cut``: each operand's TF32 head cut (its low 13 bits cleared),
  not rounded to nearest (its errors differ: compare ``rel_err``);
* ``one_tf32``: one TF32 product (hi . hi) in place of three (its
  ``check`` shows whether the float32 gate, 1e-4, turns it away).

Prints, one JSON line each: ``ptxas`` registers and spills of the four
backward instantiations of every variant; ``check``, for each variant
other than ``cut_exp`` and ``cut_ds`` on ``tools/torch_kernel_designs.py``'s
cases, its largest error against the plain versions relative to max
|plain| (``rel_err``), whether that is within the gate (``within_tol``)
and whether it gives ``as_is``'s dQ, dK and dV bit for bit; ``time``, per head
dim, the median device ms of 30 launches with the L2 flushed (variants
in turns, three rounds of 10) at B 16, H 12, S 512, not causal.  The
card's name and power limit come last.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_kernel_designs as tkd  # noqa: E402
from flexflow_tpu_torch.ops import cuda as ffcuda  # noqa: E402
from flexflow_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

# steps cut out: their results are not checked
CUTS = ("cut_exp", "cut_ds")
_CUT_EXP = [("expf(s[4 * j + e] * scale - lse_s[c])", "(s[4 * j + e] * scale - lse_s[c])"),
            ("expf(s[4 * j + e] * scale - lse[h])", "(s[4 * j + e] * scale - lse[h])")]
_CUT_DS = [(f"      {f}_ds<NB, {m}>(", f"      if (false) {f}_ds<NB, {m}>(")
           for f in ("dq", "dkv") for m in ("true", "false")]
BF16_VARIANTS = {
    "as_is": [],
    "warpgroups_1": [("kBwdWarpgroups = 2;", "kBwdWarpgroups = 1;")],
    "stages_2": [("kBwdStages = 3;", "kBwdStages = 2;")],
    "dq_uncapped": [("kDqMinBlocks = 2;", "kDqMinBlocks = 1;")],
    "dkv_q_tile_32": [("int wgmma_dkv_q_tile() { return D == 128 ? 32 : 64; }",
                       "int wgmma_dkv_q_tile() { return 32; }")],
    "cut_exp": _CUT_EXP,
    "cut_ds": _CUT_DS,
}
F32_VARIANTS = {
    "as_is": [],
    "stages_3": [("kTfStages = 2;", "kTfStages = 3;"), ("kTfMinBlocks = 2;", "kTfMinBlocks = 1;")],
    "warps_8": [("kTfWarps = 4;", "kTfWarps = 8;"), ("kTfMinBlocks = 2;", "kTfMinBlocks = 1;")],
    "split_cut": [("hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                   "hi = __float_as_uint(x) & 0xffffe000u;")],
    "one_tf32": [("  mma_tf32(d[4 * n], d[4 * n + 1], d[4 * n + 2], d[4 * n + 3], al, bh0, bh1);\n"
                  "  mma_tf32(d[4 * n], d[4 * n + 1], d[4 * n + 2], d[4 * n + 3], ah, bl0, bl1);\n",
                  "")],
    "cut_exp": _CUT_EXP,
    "cut_ds": _CUT_DS,
}
DTYPE = torch.float32 if "float32" in sys.argv else torch.bfloat16
VARIANTS = F32_VARIANTS if DTYPE == torch.float32 else BF16_VARIANTS
# the redesign's kernels, whose ptxas lines are printed
REDESIGN = "tf32_kernel" if DTYPE == torch.float32 else "wgmma_kernel"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_all(tmp):
    """{variant: ctypes library}, every variant compiled at once."""
    src = (ffcuda.CSRC_DIR / "flash_attention.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"{name}: {a!r} is not in the source")
            text = text.replace(a, b)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        cmd = [ffcuda.find_nvcc(), *ffcuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"{name} failed to build:\n{err[-4000:]}")
        kernel = None
        for line in err.splitlines():
            if "Compiling entry function" in line:
                kernel = re.sub(r".*(flash_bwd_\w+?_kernelILi\d+E(?:Lb[01]E)?).*", r"\1", line)
            elif kernel and REDESIGN in kernel and "flash_bwd" in kernel and (
                    "registers" in line or "spill" in line):
                emit({"ptxas": name, "kernel": kernel, "report": line.split(":", 1)[-1].strip()})
        # the package's loader hands out this library, and the wrappers
        # bind their argument types to it
        ffcuda._loaded["flash_attention"] = ctypes.CDLL(so)
        fa._lib = None
        libs[name] = fa._library()
    return libs


def bwd(args):
    return (fa.flash_bwd_dq(*args),) + fa.flash_bwd_dkv(*args)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_bwd_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for case, Bq, Hq, sq, sk, d, causal, rate, seed in tkd.FLASH_CASES:
            q, k, v = tkd.flash_inputs(Bq, Hq, sq, sk, d, dtype=DTYPE)
            do = tkd.flash_inputs(Bq, Hq, sq, sk, d, seed=1, dtype=DTYPE)[0]
            out, lse = fa.flash_attention_fwd_plain(q, k, v, causal, rate, seed)
            args = (q, k, v, do, lse, fa.flash_delta(out, do), causal, rate, seed)
            plain = (fa.flash_attention_bwd_dq_plain(*args),) + fa.flash_attention_bwd_dkv_plain(
                *args)
            fa._lib = libs["as_is"]
            want = bwd(args)
            for name in libs:
                if name in CUTS:
                    continue
                fa._lib = libs[name]
                try:  # a setting may not fit the card at some head dims
                    got = bwd(args)
                except RuntimeError as e:
                    emit({"check": case, "variant": name, "error": str(e)[:200]})
                    continue
                rel_err = max(tkd.rel(a, b) for a, b in zip(got, plain))
                emit({"check": case, "variant": name,
                      "equal": all(torch.equal(a, b) for a, b in zip(got, want)),
                      "rel_err": rel_err, "within_tol": rel_err <= tkd.BWD_TOL[DTYPE]})
        for d in (64, 128):
            q, k, v = tkd.flash_inputs(16, 12, 512, 512, d, dtype=DTYPE)
            do = tkd.flash_inputs(16, 12, 512, 512, d, seed=1, dtype=DTYPE)[0]
            out, lse = fa.flash_attention_fwd_plain(q, k, v)
            args = (q, k, v, do, lse, fa.flash_delta(out, do))
            times = {f"{n}_{kind}": [] for n in libs for kind in ("dq", "dkv")}
            for _ in range(3):
                for name, lib in libs.items():
                    fa._lib = lib
                    for kind, fn in (("dq", fa.flash_bwd_dq), ("dkv", fa.flash_bwd_dkv)):
                        if times[f"{name}_{kind}"] is None:
                            continue
                        try:
                            times[f"{name}_{kind}"] += tkd.time_samples(lambda: fn(*args), 10)
                        except RuntimeError:
                            times[f"{name}_{kind}"] = None
            emit({"time": "flash_bwd", "dtype": str(DTYPE).replace("torch.", ""),
                  "B": 16, "H": 12, "S": 512, "D": d,
                  **{k: float(np.median(v)) if v else None for k, v in times.items()}})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": card.stdout.strip(), "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
