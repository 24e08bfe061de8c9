"""Data for the DLRM and XDL apps: synthetic click data, and a reader
for Criteo-format files the user supplies.

Counterpart of ``flexflow_tpu/models/dlrm_data.py`` (``load_criteo``)
and of the synthetic data that ``examples/dlrm/dlrm.py`` makes.  Nothing
is downloaded.

* :func:`synthetic_dlrm`: ``n`` samples drawn from one numpy seed, as
  the example draws them: uniform ids per table, normal dense features
  (DLRM only), uniform labels.
* :func:`load_criteo`: a local file in one of the reference pipeline's
  three stages: ``.tsv`` / ``.txt`` (optionally ``.gz``), raw Criteo
  Kaggle rows ``label \\t 13 int features \\t 26 hex categoricals``
  (missing ints are 0, the hex strings hash into the table vocabulary);
  ``.npz`` with ``X_int`` / ``X_cat`` / ``y`` raw counts; ``.h5`` /
  ``.hdf5`` already log-transformed (needs ``h5py``).  Dense features of
  the raw stages get the reference's ``log(x + 1)``.

Both return the models' input order: one ``(N, bag_size)`` int32 array
per table, then (DLRM) the ``(N, n_dense)`` float32 dense array, and
float32 labels.
"""

from __future__ import annotations

import gzip
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["load_criteo", "synthetic_dlrm", "CRITEO_NUM_DENSE", "CRITEO_NUM_TABLES"]

CRITEO_NUM_DENSE = 13
CRITEO_NUM_TABLES = 26


def synthetic_dlrm(n: int, vocabs: Sequence[int], bag_size: int = 1, dense_dim: int = 4,
                   label_dim: int = 2, seed: int = 0, arch: str = "dlrm"
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
    """``n`` samples: ids uniform in each table's vocabulary, then (for
    ``arch`` "dlrm") normal dense features, and uniform [0, 1) labels of
    width ``label_dim``."""
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, v, size=(n, bag_size)).astype(np.int32) for v in vocabs]
    if arch == "dlrm":
        xs.append(rng.normal(size=(n, dense_dim)).astype(np.float32))
    y = rng.uniform(size=(n, label_dim)).astype(np.float32)
    return xs, y


def _from_arrays(x_int: np.ndarray, x_cat: np.ndarray, y: np.ndarray, vocab_sizes,
                 log_transform: bool) -> Tuple[List[np.ndarray], np.ndarray]:
    n, n_tables = x_cat.shape
    if np.isscalar(vocab_sizes):
        vocab_sizes = [int(vocab_sizes)] * n_tables
    if len(vocab_sizes) != n_tables:
        raise ValueError(f"{len(vocab_sizes)} vocabulary sizes for {n_tables} tables")
    dense = x_int.astype(np.float32)
    if log_transform:
        dense = np.log(np.maximum(dense, 0.0) + 1.0)
    xs = [(x_cat[:, i].astype(np.int64) % vocab_sizes[i]).astype(np.int32).reshape(n, 1)
          for i in range(n_tables)]
    xs.append(dense)
    return xs, y.astype(np.float32).reshape(n, 1)


def _load_tsv(path: str, vocab_sizes, max_samples: Optional[int]):
    opener = gzip.open if path.lower().endswith(".gz") else open
    width = 1 + CRITEO_NUM_DENSE + CRITEO_NUM_TABLES
    labels: List[float] = []
    ints: List[List[float]] = []
    cats: List[List[int]] = []
    with opener(path, "rt") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < width:
                continue  # a ragged tail line
            labels.append(float(parts[0]))
            ints.append([float(v) if v else 0.0 for v in parts[1:1 + CRITEO_NUM_DENSE]])
            cats.append([int(v, 16) if v else 0 for v in parts[1 + CRITEO_NUM_DENSE:width]])
            if max_samples is not None and len(labels) >= max_samples:
                break
    if not labels:
        raise ValueError(f"no parseable Criteo rows in {path!r}: expected "
                         f"'label\\t13 ints\\t26 hex cats' per line ({width} tab-separated "
                         f"fields)")
    return _from_arrays(np.asarray(ints, np.float32), np.asarray(cats, np.int64),
                        np.asarray(labels, np.float32), vocab_sizes, log_transform=True)


def load_criteo(path: str, vocab_sizes=65536, max_samples: Optional[int] = None
                ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Read a Criteo-format file (see the module docstring).
    ``vocab_sizes``: one int for every table or one per table; ids are
    reduced modulo the table's vocabulary.  Returns ``(xs, y)`` for
    ``FFModel.fit``."""
    lower = path.lower()
    sl = slice(None) if max_samples is None else slice(max_samples)
    if lower.endswith((".h5", ".hdf5")):
        import h5py

        with h5py.File(path, "r") as f:
            return _from_arrays(np.asarray(f["X_int"][sl]), np.asarray(f["X_cat"][sl]),
                                np.asarray(f["y"][sl]), vocab_sizes, log_transform=False)
    if lower.endswith(".npz"):
        with np.load(path) as f:
            return _from_arrays(f["X_int"][sl], f["X_cat"][sl], f["y"][sl], vocab_sizes,
                                log_transform=True)
    if lower.endswith((".tsv", ".txt", ".tsv.gz", ".txt.gz")):
        return _load_tsv(path, vocab_sizes, max_samples)
    raise ValueError(f"unrecognized Criteo dataset extension: {path!r} "
                     f"(expected .h5/.hdf5, .npz, or .tsv/.txt[.gz])")
