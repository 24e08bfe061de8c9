#!/usr/bin/env python3
"""Where the paged kernel's decode path spends its time on a CUDA card:
rebuild ``csrc/paged_attention.cu`` with one of the decode path's
constants changed, or a step cut out, and time the decode call over every
pool format beside the source as it is.

    python3 tools/torch_paged_decode_sweep.py

Variants, each the source with one textual change, all built at once into
a temporary directory and loaded in turn in place of the package's
library:

* ``as_is``: the source unchanged;
* ``keys_32``, ``keys_128``, ``keys_256``: splits of 32, 128 or 256 keys'
  worth of pages, not 64 (``kDecodeKeys``; the wrapper's copy follows);
* ``loads_8_uncapped``: up to 8 loads of K (and of V) a lane in flight,
  not 4 (``kDecodeLoads``; float32 pages then take one round a split, not
  two), and no register cap (``kDecodeMinBlocks`` 1, not 8: 4-6 blocks an
  SM, so the serve shapes' 864 blocks run in two waves);
* ``min_blocks_7``: registers capped for 7 blocks an SM, not 8;
* ``cut_merge``: no block merges the lane's splits (timing only: the
  output is not the result);
* ``cut_all``: every block returns at once (timing only: what launching
  the grid costs).

Prints, one JSON line each: ``ptxas`` registers and spills of the decode
instantiations at D 64 with a float32 q; ``check``, per variant other
than the cuts and pool format, the largest error against the
plain version over the serve shapes' lanes plus a lane at position 0;
``time``, per pool format, each variant's median device ms of 30 calls
with the L2 flushed (variants in turns, three rounds of 10) and the mean
of 50 calls back to back (``_b2b``), at the serve shapes (8 lanes at
position 512, H 12, D 64, BS 16, q float32); ``kernels``: the as-is
source's device time of the decode kernel from ``torch.profiler`` over 20
calls per format.  The card's name and power
limit come last.
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
from flexflow_tpu_torch.ops.cuda import paged_attention as pa  # noqa: E402

KEYS = "constexpr int kDecodeKeys = 64;"
LOADS = "constexpr int kDecodeLoads = 4;"
MIN_BLOCKS = "constexpr int kDecodeMinBlocks = 8;"
VARIANTS = {
    "as_is": ([], 64),
    "keys_32": ([(KEYS, KEYS.replace("64", "32"))], 32),
    "keys_128": ([(KEYS, KEYS.replace("64", "128"))], 128),
    "keys_256": ([(KEYS, KEYS.replace("64", "256"))], 256),
    "loads_8_uncapped": ([(MIN_BLOCKS, MIN_BLOCKS.replace("8;", "1;")),
                          (LOADS, LOADS.replace("4;", "8;"))], 64),
    "min_blocks_7": ([(MIN_BLOCKS, MIN_BLOCKS.replace("8;", "7;"))], 64),
    "cut_merge": ([("  if (!merges_lane) return;", "  return;")], 64),
    "cut_all": ([("  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;\n",
                  "  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;\n"
                  "  if (split >= 0) return;\n")], 64),
}
CUTS = ("cut_merge", "cut_all")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_all(tmp):
    """{variant: ctypes library}, every variant compiled at once."""
    src = (ffcuda.CSRC_DIR / "paged_attention.cu").read_text()
    procs = {}
    for name, (subs, _) in VARIANTS.items():
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
                kernel = re.sub(r".*(paged_decode_kernelI\w+?Li64E).*", r"\1", line)
            elif kernel and kernel.startswith("paged_decode_kernelIf") and (
                    "registers" in line or "spill" in line):
                emit({"ptxas": name, "kernel": kernel, "report": line.split(":", 1)[-1].strip()})
        # the package's loader hands out this library, and the wrapper
        # binds its argument types to it
        ffcuda._loaded["paged_attention"] = ctypes.CDLL(so)
        pa._lib = None
        libs[name] = pa._library()
    return libs


def use(name, libs):
    pa._lib = libs[name]
    pa._DECODE_KEYS = VARIANTS[name][1]
    pa._COUNTS.clear()  # cut_merge leaves its counts standing


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_decode_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    B, H, D, BS, MB = tkd.B, tkd.H, tkd.D, tkd.BS, tkd.MB
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for pool in tkd.POOLS:
            pos = np.full(B, 512)
            pos[0] = 0
            args = tkd.pool_case(np.random.default_rng(3), 1, pool, pos, torch.float32)
            want = pa.paged_attention_plain(*args)
            for name in libs:
                if name in CUTS:
                    continue
                use(name, libs)
                got = pa.paged_attention(*args)
                torch.cuda.synchronize()
                emit({"check": pool, "variant": name,
                      "max_abs_err": float((got - want).abs().max())})
        for pool in tkd.POOLS:
            args = tkd.pool_case(np.random.default_rng(1), 1, pool, np.full(B, 512),
                                 torch.float32)
            flushed = {name: [] for name in libs}
            b2b = {name: [] for name in libs}
            for _ in range(3):
                for name in libs:
                    use(name, libs)
                    flushed[name] += tkd.time_samples(lambda: pa.paged_attention(*args), 10)
                    b2b[name].append(tkd.back_to_back_ms(lambda: pa.paged_attention(*args)))
            emit({"time": pool, "B": B, "H": H, "D": D, "BS": BS, "MB": MB, "context": 512,
                  **{n: float(np.median(v)) for n, v in flushed.items()},
                  **{f"{n}_b2b": float(np.median(v)) for n, v in b2b.items()}})
        use("as_is", libs)
        from torch.profiler import ProfilerActivity, profile
        for pool in tkd.POOLS:
            args = tkd.pool_case(np.random.default_rng(1), 1, pool, np.full(B, 512),
                                 torch.float32)
            pa.paged_attention(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    pa.paged_attention(*args)
                torch.cuda.synchronize()
            by = {}
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    kind = "decode" if "paged_decode" in evt.name else None
                    if kind:
                        by.setdefault(kind, []).append(evt.time_range.end - evt.time_range.start)
            emit({"kernels": pool, **{k: float(np.mean(v)) for k, v in by.items()},
                  "unit": "us, mean of 20 (L2 warm)"})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": card.stdout.strip(), "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
