"""Build and load the port's hand-written CUDA kernels.

Counterpart of ``flexflow_tpu/ops/pallas/__init__.py``.  Each kernel is
one source ``csrc/<name>.cu`` with a plain C interface.  It is compiled
by ``nvcc`` into a shared library and loaded with ``ctypes``, at the
kernel's first launch on a CUDA tensor and never at import, so the
package imports where there is no ``nvcc`` and no GPU.

Libraries go to ``_build/`` beside this file (listed in ``.gitignore``)
under a name that carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  The sources build in
parallel, one ``nvcc`` each.  A failed build raises with ``nvcc``'s
stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = [
    "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "BUILD_SECONDS", "find_nvcc", "sources", "library_path", "build", "load",
]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# seconds each source's nvcc took, by kernel name, for the builds this
# process ran
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install path."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built at their first launch on a CUDA tensor"
    )


def sources() -> Iterable[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return Path(build_dir) / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(
    names: Optional[Iterable[str]] = None,
    *,
    build_dir: Path = BUILD_DIR,
    nvcc: Optional[str] = None,
) -> Dict[str, Path]:
    """Compile every named kernel (default: all of ``csrc/*.cu``) that has
    no up-to-date library, one ``nvcc`` per source, all run at once.  Returns
    ``{name: library path}``; raises ``RuntimeError`` with ``nvcc``'s
    stderr when a build fails."""
    names = list(sources() if names is None else names)
    build_dir = Path(build_dir)
    out: Dict[str, Path] = {n: library_path(n, build_dir) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = nvcc or find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    # one nvcc per source, all started together; stderr goes to a file
    # beside the library so a long error listing cannot block a pipe
    procs = {}
    failed = []
    try:
        for n in todo:
            tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
            log = tmp.with_suffix(".log")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            with open(log, "w") as err:
                try:
                    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err)
                except OSError as e:
                    log.unlink(missing_ok=True)
                    raise RuntimeError(f"cannot run {nvcc!r} to build {n}.cu: {e}") from e
            procs[n] = (tmp, log, proc, time.perf_counter())
        running = dict(procs)
        while running:
            for n, (tmp, log, proc, t0) in list(running.items()):
                if proc.poll() is None:
                    continue
                BUILD_SECONDS[n] = time.perf_counter() - t0
                del running[n]
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failed.append(f"nvcc failed building {n}.cu (exit {proc.returncode}):\n"
                                  f"{log.read_text(errors='replace')}")
                else:
                    os.replace(tmp, out[n])  # atomic: a reader never sees half a library
                log.unlink(missing_ok=True)
            if running:
                time.sleep(0.05)
    finally:
        for tmp, log, proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
                log.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
