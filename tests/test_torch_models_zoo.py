"""MLP, DLRM, XDL, CANDLE-Uno, the MoE classifier (both ``fused``
settings) and the MoE encoder through the port's ``FFModel.fit`` against
the JAX package's, on the CPU (cases and tolerances in ``_torch_zoo.py``);
``load_criteo`` on files the tests write against the JAX reader, the
synthetic DLRM data against the example's draw, and every zoo mode of
the train driver at small sizes on the CPU."""

from __future__ import annotations

import gzip
import json

import numpy as np
import pytest
import torch

from _torch_zoo import check_fits_as_jax, zoo_setup  # noqa: F401  (autouse fixture)
from flexflow_tpu.models.dlrm_data import load_criteo as jload
from flexflow_tpu_torch.models.dlrm_data import load_criteo as tload, synthetic_dlrm
from flexflow_tpu_torch.runtime import driver


@pytest.mark.parametrize("case", ["candle_uno", "dlrm", "mlp", "moe_classifier",
                                  "moe_classifier_fused", "moe_encoder", "xdl"])
def test_zoo_model_fits_as_jax(case):
    check_fits_as_jax(case)


def _criteo_rows(rng, n):
    rows = []
    for i in range(n):
        ints = [str(int(v)) if v >= 0 else "" for v in rng.integers(-2, 50, size=13)]
        cats = [format(int(v), "x") if v else "" for v in rng.integers(0, 2**32, size=26)]
        rows.append("\t".join([str(int(rng.integers(0, 2)))] + ints + cats))
    return rows


@pytest.mark.parametrize("kind", ["tsv", "tsv.gz", "npz"])
def test_load_criteo_reads_a_local_file_as_jax(tmp_path, kind):
    """A file the test writes itself, read by both packages' readers."""
    rng = np.random.default_rng(21)
    path = str(tmp_path / f"day.{kind}")
    if kind == "npz":
        np.savez(path, X_int=rng.integers(0, 100, size=(40, 13)),
                 X_cat=rng.integers(0, 10**6, size=(40, 26)), y=rng.integers(0, 2, size=40))
    else:
        text = "\n".join(_criteo_rows(rng, 40) + ["1\t2"]) + "\n"  # and a ragged tail line
        with (gzip.open(path, "wt") if kind.endswith("gz") else open(path, "w")) as f:
            f.write(text)
    for kw in (dict(vocab_sizes=1000), dict(vocab_sizes=[97] * 26, max_samples=25)):
        jx, jy = jload(path, **kw)
        tx, ty = tload(path, **kw)
        assert len(tx) == len(jx) == 27
        for a, b in zip(tx, jx):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ty, jy)


def test_synthetic_dlrm_draws_as_the_example():
    """``synthetic_dlrm`` draws what ``examples/dlrm/dlrm.py`` draws from
    the same seed."""
    vocabs, n = (65536,) * 4, 64
    rng = np.random.default_rng(0)
    want = [rng.integers(0, v, size=(n, 1)).astype(np.int32) for v in vocabs]
    want.append(rng.normal(size=(n, 4)).astype(np.float32))
    wy = rng.uniform(size=(n, 2)).astype(np.float32)
    xs, y = synthetic_dlrm(n, vocabs)
    for a, b in zip(xs, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(y, wy)


ZOO_MODES = {
    "mlp": ["--samples", "128", "--epochs", "1"],
    "cnn": ["--arch", "alexnet", "--size", "64", "--batch", "2", "--samples", "4"],
    "inception": ["--size", "75", "--batch", "2", "--samples", "2"],
    "dlrm": ["--embedding-size", "500", "--samples", "128", "--epochs", "1"],
    "xdl": ["--embedding-size", "500", "--num-tables", "3", "--samples", "128", "--epochs", "1"],
    "candle_uno": ["--samples", "64", "--epochs", "1"],
    "moe": ["--samples", "128", "--epochs", "1", "--fused"],
    "moe_encoder": ["--batch", "4", "--samples", "8", "--epochs", "1"],
}


@pytest.mark.parametrize("mode", sorted(ZOO_MODES))
def test_driver_zoo_mode_fits_on_the_cpu(mode, capsys):
    argv = ["--model", mode, "--device", "cpu"] + ZOO_MODES[mode]
    assert driver.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    name = {"cnn": "alexnet"}.get(mode, mode)
    assert rec["model"] == name and rec["device"] == "cpu"
    assert rec["steps"] >= 1 and rec["host_syncs"] >= 1
    assert rec["flash_launches"] == {"fwd": 0, "dq": 0, "dkv": 0}
    loss = rec["last_epoch"]["mse" if mode in ("dlrm", "xdl", "candle_uno") else "sparse_cce"]
    assert np.isfinite(loss) and loss > 0


def test_driver_zoo_reads_a_criteo_file_and_needs_a_card_by_default(tmp_path, capsys):
    path = tmp_path / "day.tsv"
    path.write_text("\n".join(_criteo_rows(np.random.default_rng(3), 16)) + "\n")
    argv = ["--model", "dlrm", "--data", str(path), "--embedding-size", "100", "--batch", "8"]
    assert driver.main(argv + ["--device", "cpu", "--epochs", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["samples"] == 16 and rec["steps"] == 2 and rec["data"] == str(path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            driver.main(argv)
