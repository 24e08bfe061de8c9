"""PyTorch/CUDA port of ``flexflow_tpu``, one slice at a time.

This package mirrors the JAX package's module paths and names so each
piece has an obvious counterpart, but it imports ``torch`` and numpy
only — never ``jax`` and nothing of ``flexflow_tpu``.  The slice ported
so far is the paged serving path: a GPT decoder served by a
continuous-batching engine over a paged KV pool, whose attention runs
through a hand-written CUDA kernel (``ops/cuda/paged_attention.py``).

Importing the package builds nothing and writes no file: the CUDA
library is compiled at its first launch on a CUDA tensor.  Every entry
point takes a ``device`` argument that defaults to ``"cuda"`` and raises
when no CUDA device is present (pass ``device="cpu"`` to run the plain
PyTorch versions on the CPU).
"""

from flexflow_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
