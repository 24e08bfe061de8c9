#!/usr/bin/env python3
"""How an H100's tensor cores round a float32 accumulation of TF32
products, and what that costs a 3xTF32 sum.

    python3 tools/torch_tf32_probe.py

Builds one small CUDA kernel (``nvcc``, the port's flags) in which a warp
takes d (16 x 8) = c + a (16 x K) . b (K x 8) as chained
``mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32``, k-steps of 8 in order,
with the flash backward's 3xTF32 split (``split_tf32`` and the product
order lo.hi, hi.lo, hi.hi of ``csrc/flash_attention.cu``) or one TF32
product (hi.hi).  Each result is held against the float64 sum and against
two models of the kernel that differ only in how each ``mma`` rounds its
sum (c plus the 8 products, taken exactly) to float32: to nearest
(``rn``, what ``tests/test_torch_flash_attention.py``'s numpy emulation
does) and toward zero (``rz``).  Prints, one JSON line each:

* ``one_step``: K 8 on operands that TF32 holds exactly, c full float32:
  the share of results equal to each model, and of those that differ
  from ``rn``, the share that lie toward zero;
* ``chain``: K 512 and 2048, a and b full float32 (``signed``: both
  standard normal, as ds . K; ``nonneg``: a uniform in [0, 1), as
  p^T . dO), 3xTF32 and one TF32 product: the largest error against the
  float64 sum relative to its largest magnitude, of the card, of each
  model and of cuBLAS's float32 product with TF32 off (FMAs on the CUDA
  cores), and the share of results equal to each model.

The card's name and power limit come last.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from flexflow_tpu_torch.ops import cuda as ffcuda  # noqa: E402

SEED = 0
SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

// as csrc/flash_attention.cu's split_tf32 and mma_tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// block i: d[i] (16 x 8) = c[i] + a[i] (16 x K) . b[i] (K x 8), row-major
__global__ void probe_kernel(const float* a, const float* b, const float* c, float* d, int K,
                             int terms) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  a += (size_t)blockIdx.x * 16 * K;
  b += (size_t)blockIdx.x * K * 8;
  c += blockIdx.x * 128;
  d += blockIdx.x * 128;
  const int o[4] = {g * 8 + 2 * t, g * 8 + 2 * t + 1, (g + 8) * 8 + 2 * t, (g + 8) * 8 + 2 * t + 1};
  float acc[4] = {c[o[0]], c[o[1]], c[o[2]], c[o[3]]};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a[g * K + k0 + t], a[(g + 8) * K + k0 + t], a[g * K + k0 + t + 4],
                         a[(g + 8) * K + k0 + t + 4]};
    const float bv[2] = {b[(k0 + t) * 8 + g], b[(k0 + t + 4) * 8 + g]};
    uint32_t ah[4], al[4], bh[2], bl[2];
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
    for (int i = 0; i < 2; ++i) split_tf32(bv[i], bh[i], bl[i]);
    if (terms == 3) {
      mma_tf32(acc, al, bh[0], bh[1]);
      mma_tf32(acc, ah, bl[0], bl[1]);
    }
    mma_tf32(acc, ah, bh[0], bh[1]);
  }
  for (int i = 0; i < 4; ++i) d[o[i]] = acc[i];
}

extern "C" int ff_tf32_probe(const float* a, const float* b, const float* c, float* d,
                             int blocks, int K, int terms) {
  probe_kernel<<<blocks, 32>>>(a, b, c, d, K, terms);
  return (int)cudaGetLastError();
}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(tmp):
    cu, so = os.path.join(tmp, "tf32_probe.cu"), os.path.join(tmp, "tf32_probe.so")
    with open(cu, "w") as f:
        f.write(SOURCE)
    subprocess.run([ffcuda.find_nvcc(), *ffcuda.NVCC_FLAGS, "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    lib.ff_tf32_probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.ff_tf32_probe.restype = ctypes.c_int
    return lib


def cut13(x):
    """x's TF32 head: its low 13 bits cleared."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def split(x):
    """(hi, lo) as split_tf32 forms them, lo as the tensor core reads it."""
    hi = ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    return hi, cut13(x - hi)


def to_f32(x, mode):
    """float64 x rounded to float32 to nearest (``rn``) or toward zero."""
    r = x.float()
    if mode == "rz":
        over = r.double().abs() > x.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def model(a, b, c, terms, mode):
    """The kernel's sum with each mma's exact sum rounded by ``mode``."""
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
    acc = c.clone()
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            part = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = to_f32(acc.double() + part, mode)
    return acc


def run(lib, a, b, c, terms):
    d = torch.empty_like(c)
    torch.cuda.synchronize()
    err = lib.ff_tf32_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                            a.shape[0], a.shape[-1], terms)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"probe launch failed: cudaError {err}")
    return d


def rel(x, exact):
    return float((x.double() - exact).abs().max() / exact.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tf32_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        blocks = 4096
        a, b = cut13(randn(blocks, 16, 8)), cut13(randn(blocks, 8, 8))
        c = randn(blocks, 16, 8) * 4
        got = run(lib, a, b, c, 1)
        exact = c.double() + a.double() @ b.double()
        rn, rz = to_f32(exact, "rn"), to_f32(exact, "rz")
        off = got != rn
        emit({"probe": "one_step", "samples": got.numel(),
              "equal_rn": float((got == rn).double().mean()),
              "equal_rz": float((got == rz).double().mean()),
              "off_rn_toward_zero": float((got[off].double().abs() < rn[off].double().abs())
                                          .double().mean()) if bool(off.any()) else None})
        blocks = 512
        for K in (512, 2048):
            for kind in ("signed", "nonneg"):
                a = (randn(blocks, 16, K) if kind == "signed"
                     else torch.rand((blocks, 16, K), generator=g).to(dev))
                b, c = randn(blocks, K, 8), torch.zeros(blocks, 16, 8, device=dev)
                exact = a.double() @ b.double()
                fma = torch.matmul(a, b)
                for terms in (3, 1):
                    got = run(lib, a, b, c, terms)
                    line = {"probe": "chain", "K": K, "a": kind, "terms": terms,
                            "rel_card": rel(got, exact), "rel_cublas_fma": rel(fma, exact)}
                    for mode in ("rn", "rz"):
                        m = model(a, b, c, terms, mode)
                        line[f"rel_{mode}_model"] = rel(m, exact)
                        line[f"equal_{mode}_model"] = float((got == m).double().mean())
                    emit(line)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": card.stdout.strip(), "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
