#!/usr/bin/env python3
"""Trace the train step of one tree of the PyTorch/CUDA port on a CUDA
card, so that two trees (a change and its parent) can be compared in one
run of one command on one card.

    python3 tools/torch_train_ab.py [--root DIR] [--label NAME] [--dtype float32|bfloat16]

``--root`` is the directory whose ``flexflow_tpu_torch`` is imported: this
checkout (the default) or a directory inside it, such as the parent's
``git archive`` unpacked into a git-ignored one.  The model, the batch and
the profiler are this script's and ``chip_smoke.py``'s, so the two trees
are measured alike.  Run it as parent, change, change, parent, one process
each.

The model is ``chip_smoke.py``'s train phase: BERT-Base on (16, 512, 768)
inputs with a 64-class pooled head, Adam(1e-4), weights from seed 0,
``--dtype`` compute (float32 by default), the flash kernels on.  Two steps
warm it up, then three steps run under ``torch.profiler``.  Prints one
JSON line, ``train_trace``: wall and device-busy microseconds of the three
steps, the idle share, the device time and launches of each flash kernel
(``flash``: forward, dQ, dK/dV, by kernel name), and the kernels with the
most device time.  The card's name and power limit come last.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
STEPS_WARM, STEPS_TRACED = 2, 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() if "--root" in args else HERE
    label = args[args.index("--label") + 1] if "--label" in args else root.name
    dtype = args[args.index("--dtype") + 1] if "--dtype" in args else "float32"
    if root != HERE and HERE not in root.parents:
        raise SystemExit(f"torch_train_ab: --root {root} is not inside {HERE}")
    if dtype not in ("float32", "bfloat16"):
        raise SystemExit(f"torch_train_ab: --dtype {dtype!r} is not float32 or bfloat16")
    sys.path.insert(0, str(root))
    smoke_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(smoke_spec)
    smoke_spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("torch_train_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from flexflow_tpu_torch.models.transformer import BERT_BASE
    from flexflow_tpu_torch.ops import cuda as ffcuda
    from flexflow_tpu_torch.runtime.driver import build_model, make_batch

    package = Path(sys.modules["flexflow_tpu_torch"].__file__).resolve()
    if root not in package.parents:
        raise SystemExit(f"torch_train_ab: imported {package}, not a package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(smoke.DEVICE)
    ffcuda.build()
    model = build_model(batch=smoke.TRAIN_B, seq=smoke.TRAIN_S, num_classes=smoke.TRAIN_CLASSES,
                        lr=smoke.TRAIN_LR, seed=smoke.SEED, device=dev, compute_dtype=dtype,
                        use_flash=True, **BERT_BASE)
    x, y = make_batch(smoke.TRAIN_B, smoke.TRAIN_S, BERT_BASE["hidden"], smoke.TRAIN_CLASSES,
                      smoke.SEED)
    ex = model.executor
    xs, ys = ex.place(x), ex.place(y)
    for _ in range(STEPS_WARM):
        ex.train_step([xs], ys)
    torch.cuda.synchronize()
    prof = smoke.device_profile(lambda: [ex.train_step([xs], ys) for _ in range(STEPS_TRACED)],
                                top=None)
    prof.pop("result")
    flash = {k: v for k, v in ((t["name"], {"total_us": t["total_us"], "count": t["count"]})
                               for t in prof["top_kernels_us"]) if "flash_" in k}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit({"train_trace": label, "root": str(root.relative_to(HERE)), "compute_dtype": dtype,
          "steps": STEPS_TRACED, "wall_us": prof["wall_us"],
          "device_busy_us": prof["device_busy_us"],
          "device_idle_share": prof["device_idle_share"],
          "device_events": prof["device_events"], "flash": flash,
          "flash_us": sum(v["total_us"] for v in flash.values()),
          "top_kernels_us": prof["top_kernels_us"][:10]})
    emit({"card": card.stdout.strip(), "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
