#!/usr/bin/env python3
"""Where the float32 flash forward's time and error go on a CUDA card:
rebuild ``csrc/flash_attention.cu`` with one of the 3xTF32 forward's
settings changed, or a step cut out, and hold and time the forward beside
the source as it is.

    python3 tools/torch_flash_fwd_sweep.py

Each variant is the source with one textual change, all built at once
(``nvcc -Xptxas -v``) into a temporary directory and loaded in turn in
place of the package's library:

* ``as_is``: the source unchanged (each key tile's P.V summed into a
  zeroed accumulator and folded into the output in float32 FMAs);
* ``running_acc``: one running output accumulator kept in the tensor core
  across the tiles (o scaled by alpha, then P.V added in the mma.sync
  sums), the design the fold replaced;
* ``stages_3``: a ring of three stages, not two;
* ``keys_32``: K/V tiles of 32 keys at D 64 as well (the source takes
  32 at D 128 only);
* ``one_tf32``: one TF32 product (hi . hi) in place of three (its error
  shows what 3xTF32 buys);
* ``cut_exp``: p is its exponent's argument, no ``expf`` (timing only).

The constants are shared with the float32 backward, which the sweep does
not run.  Prints, one JSON line each: ``ptxas`` registers and spills of
the forward's two instantiations in every variant; ``check``, per variant
other than ``cut_exp`` and case of ``tools/torch_kernel_designs.py``'s, the
error of O and lse against the plain version relative to max |plain|
(``rel_o``, ``rel_lse``) and whether both are within the float32 forward
gate of ``chip_smoke.py`` (2e-5); ``time``, per head dim, the median device
ms of 30 launches with the L2 flushed (variants in turns, three rounds of
10) at B 16, H 12, S 512, not causal.  The card's name and power limit
come last.
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

TOL = tkd.FLASH_TOL[torch.float32]
CUTS = ("cut_exp",)
_FOLD = """  float pv[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) pv[i] = 0.f;
  tf_mma_nn<D, NB, N0, NC / 8>(pv, p, vs);"""
_RUNNING = """  if constexpr (NC == D) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i % 4) / 2];
    tf_mma_nn<D, NB>(o, p, vs);
    return;
  }
""" + _FOLD
VARIANTS = {
    "as_is": [],
    "running_acc": [(_FOLD, _RUNNING),
                    ("int tf32_fwd_cols() { return D == 128 ? 64 : D; }",
                     "int tf32_fwd_cols() { return D; }")],
    "stages_3": [("constexpr int kTfStages = 2;", "constexpr int kTfStages = 3;")],
    "keys_32": [("constexpr int kTfKeys = 64;", "constexpr int kTfKeys = 32;")],
    "one_tf32": [("  mma_tf32(d[4 * n], d[4 * n + 1], d[4 * n + 2], d[4 * n + 3], al, bh0, bh1);\n"
                  "  mma_tf32(d[4 * n], d[4 * n + 1], d[4 * n + 2], d[4 * n + 3], ah, bl0, bl1);\n",
                  "")],
    "cut_exp": [("float p = vis ? expf(s[i] - m_new[h]) : 0.f;",
                 "float p = vis ? (s[i] - m_new[h]) : 0.f;")],
}


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
                kernel = re.sub(r".*(flash_fwd_tf32_kernelILi\d+E).*", r"\1", line)
            elif kernel and kernel.startswith("flash_fwd_tf32") and (
                    "registers" in line or "spill" in line):
                emit({"ptxas": name, "kernel": kernel, "report": line.split(":", 1)[-1].strip()})
        # the package's loader hands out this library, and the wrappers
        # bind their argument types to it
        ffcuda._loaded["flash_attention"] = ctypes.CDLL(so)
        fa._lib = None
        libs[name] = fa._library()
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_fwd_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for case, Bq, Hq, sq, sk, d, causal, rate, seed in tkd.FLASH_CASES:
            q, k, v = tkd.flash_inputs(Bq, Hq, sq, sk, d, dtype=torch.float32)
            p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal, rate, seed)
            live = p_lse > -1e29
            for name in libs:
                if name in CUTS:
                    continue
                fa._lib = libs[name]
                out, lse = fa.flash_fwd(q, k, v, causal, rate, seed)
                torch.cuda.synchronize()
                rel_o, rel_lse = tkd.rel(out, p_out), tkd.rel(lse[live], p_lse[live])
                emit({"check": case, "variant": name, "rel_o": rel_o, "rel_lse": rel_lse,
                      "within_tol": rel_o <= TOL and rel_lse <= TOL})
        for d in (64, 128):
            q, k, v = tkd.flash_inputs(16, 12, 512, 512, d, dtype=torch.float32)
            times = {name: [] for name in libs}
            for _ in range(3):
                for name, lib in libs.items():
                    fa._lib = lib
                    times[name] += tkd.time_samples(lambda: fa.flash_fwd(q, k, v), 10)
            emit({"time": "flash_fwd", "dtype": "float32", "B": 16, "H": 12, "S": 512, "D": d,
                  **{k: float(np.median(v)) for k, v in times.items()}})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": card.stdout.strip(), "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
