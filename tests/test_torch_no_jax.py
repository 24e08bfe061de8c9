"""The port stands alone: no JAX, no ``ml_dtypes`` and nothing of ``flexflow_tpu``.

A fresh interpreter, started in an empty directory, imports
``flexflow_tpu_torch`` and every submodule; afterwards neither ``jax``
nor ``flexflow_tpu`` may be in ``sys.modules``, nothing may have been
built, and the directory must still be empty.  An AST scan of the
package and of ``chip_smoke.py`` finds no import of any of them (the
card's machine has no ``ml_dtypes``: bfloat16 and float8 KV pages travel
as bit views).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "flexflow_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import flexflow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "flexflow_tpu" or m.startswith("flexflow_tpu.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
print(json.dumps({"modules": names, "bad": bad,
                  "triton": "triton" in sys.modules}))
"""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "flexflow_tpu", "ml_dtypes")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_import_pulls_in_no_jax(tmp_path):
    build_dir = PKG / "ops" / "cuda" / "_build"
    built_before = sorted(build_dir.glob("*")) if build_dir.exists() else []
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert not res["triton"]
    assert set(res["modules"]) >= {
        "flexflow_tpu_torch.serve.engine",
        "flexflow_tpu_torch.ops.cuda.paged_attention",
        # the training slice
        "flexflow_tpu_torch.fftype", "flexflow_tpu_torch.tensor", "flexflow_tpu_torch.config",
        "flexflow_tpu_torch.ops.base", "flexflow_tpu_torch.ops.dense",
        "flexflow_tpu_torch.ops.norm", "flexflow_tpu_torch.ops.elementwise",
        "flexflow_tpu_torch.ops.tensor_ops", "flexflow_tpu_torch.ops.attention",
        "flexflow_tpu_torch.ops.cuda.flash_attention", "flexflow_tpu_torch.loss",
        "flexflow_tpu_torch.metrics", "flexflow_tpu_torch.optimizer",
        "flexflow_tpu_torch.runtime.executor", "flexflow_tpu_torch.runtime.driver",
        "flexflow_tpu_torch.model", "flexflow_tpu_torch.models.transformer",
        # preemption, drain and resume
        "flexflow_tpu_torch.serve.wire", "flexflow_tpu_torch.runtime.faults",
        "flexflow_tpu_torch.serve.kvcache", "flexflow_tpu_torch.serve.scheduler",
        "flexflow_tpu_torch.serve.driver",
        # the fit loop, checkpoints and the decoder through FFModel
        "flexflow_tpu_torch.dataloader", "flexflow_tpu_torch.ops.embedding",
        "flexflow_tpu_torch.ops.parallel_ops",
        # the single-device op set and the model zoo
        "flexflow_tpu_torch.ops.conv", "flexflow_tpu_torch.ops.moe",
        "flexflow_tpu_torch.initializer", "flexflow_tpu_torch.models.mlp",
        "flexflow_tpu_torch.models.cnn", "flexflow_tpu_torch.models.dlrm",
        "flexflow_tpu_torch.models.dlrm_data", "flexflow_tpu_torch.models.candle_uno",
        "flexflow_tpu_torch.models.moe",
    }
    assert list(tmp_path.iterdir()) == []  # importing wrote nothing
    built_after = sorted(build_dir.glob("*")) if build_dir.exists() else []
    assert built_after == built_before  # and built nothing


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")] + ["chip_smoke.py"]
))
def test_no_jax_import_in_source(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            args = [a.value for a in node.args if isinstance(a, ast.Constant)]
            found += [a for a in args if isinstance(a, str) and _forbidden(a)]
    assert found == [], f"{path} imports {found}"
