// Flash attention, forward and backward, for sm_90a.
//
// Replaces the four TPU kernels of flexflow_tpu/ops/pallas/flash_attention.py:
//   flash_fwd      <- _fwd_kernel_onepass (_flash_fwd_onepass) and _fwd_kernel
//                     (_flash_fwd): one kernel for both, a one-pass row is a
//                     K/V loop that runs one tile;
//   flash_bwd_dq   <- _dq_kernel  (_flash_bwd, first pallas_call);
//   flash_bwd_dkv  <- _dkv_kernel (_flash_bwd, second pallas_call).
// All tensors are (BH, S, D) row-major, bh = b * H + h; lse and delta are
// float32 (BH, Sq).  They compute, with s = (q . k) * scale, the end-aligned
// causal mask visible = q_pos + (Sk - Sq) >= k_pos (every key visible when
// not causal), and masked scores set to -1e30 as the JAX kernels do:
//
//   forward:  o = softmax(s) @ v with dropout on the probabilities after the
//             row sum; lse = m + log(max(l, 1e-30)).  A row that sees no key
//             outputs 0 and saves lse = -1e30 + log(1e-30), which the
//             backward kernels rely on (p is zeroed by the mask, not by lse).
//   dq:       p = exp(s - lse); dp = do . v (dropout: kept / keep, else 0);
//             ds = p * (dp - delta); dq = scale * ds @ k.
//   dk, dv:   dv = p_eff^T @ do; dk = scale * ds^T @ q, over the q tiles that
//             can see the k tile.
//
// Dropout is the JAX package's counter hash _uniform01(seed, bh, q_pos,
// k_pos) (murmur3-style uint32 finalizer), bit for bit: forward and backward
// rebuild the same mask from the seed and no mask is stored.
//
// Two sets of kernels share that contract:
//
// * float32 inputs: the forward runs as float32 FMAs on the CUDA cores.
//   Each block of 256 threads stages a 64-row Q tile and 64-row K/V tiles in
//   shared memory, widened with a padded row stride; each thread keeps a
//   4 x 4 register tile of scores and a 4 x D/16 tile of the output, so one
//   shared-memory load feeds several FMAs.  The backward's first designs
//   (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) are built the same way and
//   stay only so that the redesign can be timed beside them; its default is
//   its Hopper redesign on the tensor cores ("The float32 backward on the
//   tensor cores" below).  One TF32 product misses the backward's float32
//   gate (1e-4 of the plain version) by 8-12x, so each product there is
//   three (3xTF32: each operand split into a TF32 head and the rest, the
//   small cross terms summed before the heads'), which meets it, though
//   not at the FMA kernels' error level (see that section).
// * bfloat16 inputs: tensor cores (bfloat16 in, float32 accumulate), with
//   the score and probability tiles kept in registers.  Each kernel's
//   default is its Hopper redesign on wgmma (the sections "The bfloat16
//   forward, redesigned" and "The bfloat16 backward, redesigned" below);
//   the first designs, on mma.sync.m16n8k16 with one warp per 16 rows,
//   stay only so that the two can be timed side by side.  The casts are
//   the JAX kernels': matmul inputs stay bfloat16, products accumulate in
//   float32, p (and ds) round to bfloat16 before their product, outputs
//   round once.
//
// What bounds them on this card.  float32: operations (the forward at
// BERT-Base, S 512, D 64, does 4*S*D = 131k flops per row, far above the
// H100's balance point); the forward runs them on the CUDA cores (67
// TFLOP/s), the backward's redesign on the tensor cores as 3xTF32 (a third
// of TF32's 495 TFLOP/s) through a cp.async ring.  What holds the backward
// back: its three mma.sync a k-step (TF32 wgmma takes no transposed
// operand) take about half its time, and in dQ the ds step about a third,
// since the gradient product waits for ds and ds for the score products.
// bfloat16 forward: bytes and operations
// nearly alike (about 0.015 ms for Q, K, V and O, 0.013 ms for the flops at
// 989 TFLOP/s), so the kernel has to keep the tensor cores fed from tiles
// that arrive while it computes.  The redesign does that with a cp.async
// ring, and puts both products on wgmma; what still holds it back is that
// each warpgroup runs its S -> softmax -> P.V chain in order, so the tensor
// cores wait during the softmax, and registers (128 a thread) allow only
// four warpgroups per SM to cover each other's gaps.  The bfloat16 backward
// kernels recompute the scores and do 6 x D (dQ) and 8 x D (dK/dV) flops per
// (row, key) pair, so operations bound them; their redesign brings the
// other side's tiles through a cp.async ring while earlier tiles are
// computed and runs every product on wgmma.  What still bounds them is the
// forward's limit, heavier: each warpgroup runs its scores -> ds ->
// gradient products chain in order, so the tensor cores wait while it forms
// ds, and registers leave four warpgroups per SM for dQ (128 a thread at
// D 64) and two for dK/dV (its two float32 accumulators beside the two
// score tiles).  The (Sq, Sk) score matrix never reaches device memory.
//
// Plain C interface (built by nvcc into a shared library, loaded with ctypes);
// each entry point returns the cudaGetLastError() code after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;      // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;  // 16 x 16 threads; thread (ty, tx)
constexpr int kRows = 4;       // rows per thread: ty * 4 .. ty * 4 + 3
constexpr int kCols = 4;       // score columns per thread: tx + 16 * j
constexpr int kPLd = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float uniform01(uint32_t seed, uint32_t bh, uint32_t q_pos,
                                           uint32_t k_pos) {
  uint32_t h = q_pos * 0x9E3779B1u + k_pos * 0x85EBCA77u + seed + bh * 0xC2B2AE35u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
}

// reductions over the 16 threads (tx) that share a row group; they are 16
// consecutive lanes of one warp
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + kTile) of a (S, D) matrix into a float32 tile with row
// stride D + 1 (the pad spreads the column walks over the banks)
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0) {
  const float* base = src + static_cast<size_t>(r0) * D;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] = base[idx];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int causal, float scale, float rate,
                 float keep, uint32_t seed) {
  constexpr int LD = D + 1;
  constexpr int kAcc = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kTile][LD]
  float* ks = qs + kTile * LD;   // [kTile][LD]
  float* vs = ks + kTile * LD;   // [kTile][LD]
  float* ps = vs + kTile * LD;   // [kTile][kPLd]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = sk - sq;
  const float* qb = q + static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;

  // keys past the last row's diagonal are invisible to the whole tile
  int k_end = sk;
  if (causal) k_end = min(sk, max(0, q0 + kTile + off));

  load_tile<D>(qs, qb, q0);

  float m[kRows], l[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    load_tile<D>(ks, kb, k0);
    load_tile<D>(vs, vb, k0);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int q_pos = q0 + r;
      bool vis[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        vis[j] = !causal || q_pos + off >= k_pos;
        s[i][j] = vis[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        if (rate > 0.f) {
          const float u = uniform01(seed, bh, q_pos, k_pos);
          p = u >= rate ? p / keep : 0.f;
        }
        ps[r * kPLd + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kAcc; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float a[kRows], b[kAcc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = ps[(ty * kRows + i) * kPLd + kk];
#pragma unroll
      for (int c = 0; c < kAcc; ++c) b[c] = vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kAcc; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q_pos = q0 + ty * kRows + i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* o = out + (static_cast<size_t>(bh) * sq + q_pos) * D;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) o[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0) lse[static_cast<size_t>(bh) * sq + q_pos] = m[i] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int sq, int sk,
                    int causal, float scale, float rate, float keep, uint32_t seed) {
  constexpr int LD = D + 1;
  constexpr int kAcc = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // [kTile][LD]
  float* dos = qs + kTile * LD;    // [kTile][LD]
  float* ks = dos + kTile * LD;    // [kTile][LD]
  float* vs = ks + kTile * LD;     // [kTile][LD]
  float* dss = vs + kTile * LD;    // [kTile][kPLd]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = sk - sq;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;

  int k_end = sk;
  if (causal) k_end = min(sk, max(0, q0 + kTile + off));

  load_tile<D>(qs, q + static_cast<size_t>(bh) * sq * D, q0);
  load_tile<D>(dos, dout + static_cast<size_t>(bh) * sq * D, q0);

  float row_lse[kRows], row_delta[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const size_t idx = static_cast<size_t>(bh) * sq + q0 + ty * kRows + i;
    row_lse[i] = lse[idx];
    row_delta[i] = delta[idx];
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, kb, k0);
    load_tile<D>(vs, vb, k0);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], g[kRows], b[kCols], w[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = qs[(ty * kRows + i) * LD + d];
        g[i] = dos[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        b[j] = ks[(tx + 16 * j) * LD + d];
        w[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool vis = !causal || q_pos + off >= k_pos;
        // a row with no visible key saved lse ~ -1e30, so exp(s - lse) of a
        // masked score does not vanish: the mask zeroes it
        const float p = vis ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        float g = dp[i][j];
        if (rate > 0.f) {
          const float u = uniform01(seed, bh, q_pos, k_pos);
          g = u >= rate ? g / keep : 0.f;
        }
        dss[r * kPLd + tx + 16 * j] = p * (g - row_delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float a[kRows], b[kAcc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = dss[(ty * kRows + i) * kPLd + kk];
#pragma unroll
      for (int c = 0; c < kAcc; ++c) b[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kAcc; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float* o = dq + (static_cast<size_t>(bh) * sq + q0 + ty * kRows + i) * D;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) o[tx + 16 * c] = acc[i][c] * scale;
  }
}

// One block per (k tile, bh).  Thread (ty, tx) owns keys ty*4 .. ty*4+3 of
// the tile and, within a q tile, query columns tx + 16 * j: it builds the
// transposed score tile s^T directly.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv,
                     int sq, int sk, int causal, float scale, float rate, float keep,
                     uint32_t seed) {
  constexpr int LD = D + 1;
  constexpr int kAcc = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                // [kTile][LD]
  float* vs = ks + kTile * LD;     // [kTile][LD]
  float* qs = vs + kTile * LD;     // [kTile][LD]
  float* dos = qs + kTile * LD;    // [kTile][LD]
  float* pts = dos + kTile * LD;   // [kTile keys][kPLd]: p_eff^T
  float* dst = pts + kTile * kPLd; // [kTile keys][kPLd]: ds^T
  float* lse_s = dst + kTile * kPLd;  // [kTile]
  float* delta_s = lse_s + kTile;     // [kTile]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = sk - sq;
  const float* qb = q + static_cast<size_t>(bh) * sq * D;
  const float* db = dout + static_cast<size_t>(bh) * sq * D;

  // the first q tile whose last row can see this tile's first key
  int q_begin = 0;
  if (causal) q_begin = max(0, (k0 - off) / kTile * kTile);

  load_tile<D>(ks, k + static_cast<size_t>(bh) * sk * D, k0);
  load_tile<D>(vs, v + static_cast<size_t>(bh) * sk * D, k0);

  float dk_acc[kRows][kAcc], dv_acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kAcc; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = q_begin; q0 < sq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, qb, q0);
    load_tile<D>(dos, db, q0);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[static_cast<size_t>(bh) * sq + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[static_cast<size_t>(bh) * sq + q0 + threadIdx.x];
    }
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], w[kRows], b[kCols], g[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = ks[(ty * kRows + i) * LD + d];
        w[i] = vs[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        b[j] = qs[(tx + 16 * j) * LD + d];
        g[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int k_pos = k0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const int q_pos = q0 + c;
        const bool vis = !causal || q_pos + off >= k_pos;
        const float p = vis ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        float p_eff = p, g = dp[i][j];
        if (rate > 0.f) {
          const float u = uniform01(seed, bh, q_pos, k_pos);
          const float keep_mask = (u >= rate ? 1.f : 0.f) / keep;
          p_eff = p * keep_mask;
          g = g * keep_mask;
        }
        pts[r * kPLd + c] = p_eff;
        dst[r * kPLd + c] = p * (g - delta_s[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float a[kRows], e[kRows], b[kAcc], x[kAcc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = pts[(ty * kRows + i) * kPLd + qq];
        e[i] = dst[(ty * kRows + i) * kPLd + qq];
      }
#pragma unroll
      for (int c = 0; c < kAcc; ++c) {
        b[c] = dos[qq * LD + tx + 16 * c];
        x[c] = qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          dv_acc[i][c] = fmaf(a[i], b[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(e[i], x[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const size_t row = static_cast<size_t>(bh) * sk + k0 + ty * kRows + i;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      dk[row * D + tx + 16 * c] = dk_acc[i][c] * scale;
      dv[row * D + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 kernels on the tensor cores: mma.sync.m16n8k16 (bfloat16 in,
// float32 accumulate).  A block of four warps owns 64 rows of its own side
// (q rows for the forward and dQ, keys for dK/dV), one warp per 16 rows,
// and loops over the other side's tiles staged in shared memory.  Score,
// probability and dP tiles stay in registers: the float32 accumulator of
// two adjacent n8 tiles, packed to bfloat16 pairs, is exactly the A operand
// of the next m16n8k16 product (keys or queries as its k dimension).  The
// rounding points are those of the FMA kernels above: p and ds round to
// bfloat16 before their products, everything else accumulates in float32.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A regs hold
// (row g | g+8, cols 2t, 2t+1 | +8); B regs hold (k rows 2t, 2t+1 | +8,
// col g); the accumulator holds (row g, cols 2t, 2t+1) and (row g+8, same).
constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;  // rows of the block's own side, 16 per warp

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows from `row0`, k columns kc .. kc+15) of a row-major
// bfloat16 matrix with row stride `ld`
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m, int ld, int row0,
                                       int kc) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bf16* r0 = m + (size_t)(row0 + g) * ld + kc + 2 * t;
  const bf16* r1 = r0 + 8 * (size_t)ld;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// B fragment (k = kc .. kc+15, n = n0 .. n0+7) for B[k][n] = m[n][k]: the
// product against a row-major matrix's transpose (two 32-bit loads)
__device__ __forceinline__ void load_b_t(uint32_t& b0, uint32_t& b1, const bf16* m, int ld,
                                         int n0, int kc) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bf16* r = m + (size_t)(n0 + g) * ld + kc + 2 * t;
  b0 = ld32(r);
  b1 = ld32(r + 8);
}

// B fragment (k = kc .. kc+15, n = n0 .. n0+7) for B[k][n] = m[k][n]: the
// product against a row-major matrix itself (four 16-bit loads)
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* m, int ld,
                                       int n0, int kc) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bf16* c = m + (size_t)(kc + 2 * t) * ld + n0 + g;
  b0 = pack_bf16(c[0], c[ld]);
  b1 = pack_bf16(c[8 * (size_t)ld], c[9 * (size_t)ld]);
}

// rows [r0, r0 + n) of a (S, D) bfloat16 matrix into shared memory with row
// stride D + 8 (16-byte copies; the pad puts fragment loads on distinct banks)
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int r0,
                                           int n) {
  constexpr int kChunks = D / 8;  // 16-byte pieces per row
  const uint4* s = reinterpret_cast<const uint4*>(src + (size_t)r0 * D);
  for (int idx = threadIdx.x; idx < n * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + 8 * c) = s[idx];
  }
}

// reductions over the four lanes (t) that share a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int causal, float scale,
                     float rate, float keep, uint32_t seed) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16, ND = D / 8, NK = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* vs = ks + kTile * LD;                     // [kTile][LD]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int off = sk - sq;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;
  int k_end = sk;
  if (causal) k_end = min(sk, max(0, q0 + kMmaRows + off));

  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a(qa[kk], qb, D, q0 + warp * 16, kk * 16);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage_rows<D>(ks, kb, k0, kTile);
    stage_rows<D>(vs, vb, k0, kTile);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b0, b1;
        load_b_t(b0, b1, ks, LD, 8 * j, 16 * kk);
        mma16816(s[j], qa[kk], b0, b1);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
        const bool vis = !causal || row[e / 2] + off >= k_pos;
        s[j][e] = vis ? s[j][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new[h]);
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
        const bool vis = !causal || row[h] + off >= k_pos;
        float p = vis ? expf(s[j][e] - m_new[h]) : 0.f;
        psum[h] += p;
        if (rate > 0.f) {
          const float u = uniform01(seed, bh, row[h], k_pos);
          p = u >= rate ? p / keep : 0.f;
        }
        s[j][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, vs, LD, 8 * n, 16 * kk);
        mma16816(o[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(l[h], 1e-30f);
    bf16* orow = out + ((size_t)bh * sq + row[h]) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const uint32_t pr = pack_bf16(o[n][2 * h] / l_safe, o[n][2 * h + 1] / l_safe);
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) = pr;
    }
    if (t == 0) lse[(size_t)bh * sq + row[h]] = m[h] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 forward, redesigned for Hopper: flash_fwd_wgmma_kernel<D, 2,
// BN> below.  Two warpgroups of 64 query rows share each K/V tile (BN 64
// keys at D 64, 128 at D 128), which a ring of two shared-memory stages
// filled with cp.async brings in while the tile before it is computed.
// S = Q.K^T and O += P.V run on wgmma.m64nNk16 (bfloat16 in, float32
// accumulate) with Q, K (both K-major) and V (MN-major) read from
// 128-byte-swizzled shared memory and P from registers.  The mask is tested
// only on tiles that cross a row's diagonal, and dropout is hashed only when
// rate > 0.  The kernel above is the first design, which the wrapper still
// launches on request so that the two can be timed side by side.  The
// redesign keeps the first design's contract: masked scores -1e30, a row
// that sees no key gives 0 and lse -1e30 + log(1e-30), the dropout hash bit
// for bit, p rounded to bfloat16 before P.V, the output rounded once.

// one 16-byte global -> shared copy that does not pass through registers
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The online-softmax step of the redesign for one thread's two rows
// (row[0], row[1]) over a tile of NK n8 blocks of raw scores s[j][e] (e & 1
// the column, e / 2 the row) whose first key is k0: updates m / l, rescales
// o, and leaves p (after dropout) in s.  The arithmetic is the first
// design's, operation for operation (scores times scale, expf against the
// running max), so p and the outputs are its bits: a formulation with one
// FFMA and one ex2 per score was faster but moved the five-step bfloat16
// loss curve of the train phase from 0.8% to 2.3% off sdpa's.  kMask (tiles
// that cross a row's diagonal, the only ones that test visibility) sets
// invisible scores to -1e30 and their p to 0.
template <int NK, int ND, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[NK][4], float (&o)[ND][4], float (&m)[2],
                                             float (&l)[2], const int (&row)[2], int k0,
                                             int off, float scale, float rate, float keep,
                                             uint32_t seed, int bh) {
  const int t = threadIdx.x % 4;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool vis = !kMask || row[e / 2] + off >= k0 + 8 * j + 2 * t + (e & 1);
      s[j][e] = vis ? s[j][e] * scale : kNegInf;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = expf(m[h] - m_new[h]);
  }
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e / 2;
      const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
      const bool vis = !kMask || row[h] + off >= k_pos;
      float p = vis ? expf(s[j][e] - m_new[h]) : 0.f;
      psum[h] += p;
      if (rate > 0.f) {
        const float u = uniform01(seed, bh, row[h], k_pos);
        p = u >= rate ? p / keep : 0.f;
      }
      s[j][e] = p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
    m[h] = m_new[h];
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

template <int NK, int ND>
__device__ __forceinline__ void softmax_tile(bool masked, float (&s)[NK][4], float (&o)[ND][4],
                                             float (&m)[2], float (&l)[2], const int (&row)[2],
                                             int k0, int off, float scale, float rate,
                                             float keep, uint32_t seed, int bh) {
  if (masked)
    softmax_tile<NK, ND, true>(s, o, m, l, row, k0, off, scale, rate, keep, seed, bh);
  else
    softmax_tile<NK, ND, false>(s, o, m, l, row, k0, off, scale, rate, keep, seed, bh);
}

// o / l rounded once to bfloat16, and the row's lse
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], const float (&m)[2],
                                           const float (&l)[2], const int (&row)[2],
                                           bf16* __restrict__ out, float* __restrict__ lse,
                                           int bh, int sq) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(l[h], 1e-30f);
    bf16* orow = out + ((size_t)bh * sq + row[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * h] / l_safe, o[n][2 * h + 1] / l_safe);
    if (t == 0) lse[(size_t)bh * sq + row[h]] = m[h] + logf(l_safe);
  }
}

// A block holds NWG warpgroups of 64 query rows each; they share a ring of
// two stages of BN-key K/V tiles.  Each warpgroup's Q tile sits in shared
// memory for the whole run (S = Q.K^T takes both operands from shared
// memory), and P goes from registers as the A operand of O += P.V.  Q stays
// out of registers on purpose: with Q as a long-lived register A operand,
// ptxas gave P's fragments Q's registers and the second tile scored against
// P (seen on the card at D 64).

// shared-memory matrix descriptor of a 128-byte-swizzled tile (layout 1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, float32) += A (64 x 16 bfloat16, registers) . B (16 x 64, shared
// memory through `desc`); scale_d 0 ignores D's old value
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
}

// D (64 x 128, float32) += A (64 x 16 bfloat16, registers) . B (16 x 128, shared
// memory through `desc`); scale_d 0 ignores D's old value
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
}

// D (64 x 64, float32) += A (64 x 16) . B (16 x 64), bfloat16, both from shared
// memory through their descriptors, K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16) . B (16 x 128), bfloat16, both from shared
// memory through their descriptors, K-major
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Start the copy of `rows` rows of a (S, D) bfloat16 matrix (from `src`) into
// a 128-byte-swizzled tile at `dst`: D / 64 column blocks of `rows` x 64,
// each row 128 bytes whose 16-byte pieces are permuted by (piece ^ row % 8).
// The tile sits on 1024 bytes.  Every thread of the block takes pieces.
template <int D>
__device__ __forceinline__ void issue_rows_sw128(uint32_t dst, const bf16* __restrict__ src,
                                                 int rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(dst + (c / 8) * (rows * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               src + (size_t)r * D + 8 * c);
  }
}

// register budget of one thread: S (BN / 2), O (D / 2), P (BN / 4) and the rest
constexpr int wgmma_min_blocks(int d, int nwg, int bn) {
  return 65536 / (128 * nwg * (bn / 2 + d / 2 + bn / 4 + 40)) > 0
             ? 65536 / (128 * nwg * (bn / 2 + d / 2 + bn / 4 + 40))
             : 1;
}

template <int D, int NWG, int BN>
__global__ void __launch_bounds__(128 * NWG, wgmma_min_blocks(D, NWG, BN))
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int causal, float scale,
                       float rate, float keep, uint32_t seed) {
  constexpr int ND = D / 8, NK = BN / 8;
  constexpr uint32_t kQBytes = 64 * D * 2;   // one warpgroup's Q tile
  constexpr uint32_t kKVBytes = BN * D * 2;  // one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [Q: NWG tiles][stage 0: K | V][stage 1: K | V], each on 1024 bytes
  const uint32_t sq_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_base = sq_base + NWG * kQBytes;

  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4;
  const int q0 = blockIdx.x * 64 * NWG;  // the block's first row
  const int w0 = q0 + wg * 64;           // this warpgroup's first row
  const int off = sk - sq;
  const int row[2] = {w0 + warp * 16 + g, w0 + warp * 16 + g + 8};
  const bool rows_live = w0 < sq;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;
  int k_end = sk;  // the block's keys; a warpgroup stops at its own diagonal
  if (causal) k_end = min(sk, max(0, min(sq, q0 + 64 * NWG) + off));
  int wg_end = rows_live ? sk : 0;
  if (causal && rows_live) wg_end = min(sk, max(0, w0 + 64 + off));

  // Q of every live warpgroup, then the first K/V tile: one group
  const int q_rows = min(64 * NWG, sq - q0);
  for (int w = 0; w < NWG; ++w)
    if (64 * w < q_rows)
      issue_rows_sw128<D>(sq_base + w * kQBytes, q + ((size_t)bh * sq + q0 + 64 * w) * D, 64);
  // tile t into stage t % 2, as one committed group (empty past the block's keys)
  auto issue_tile = [&](int t) {
    if (t * BN < k_end) {
      const uint32_t st = kv_base + (t % 2) * 2 * kKVBytes;
      issue_rows_sw128<D>(st, kb + (size_t)t * BN * D, BN);
      issue_rows_sw128<D>(st + kKVBytes, vb + (size_t)t * BN * D, BN);
    }
    cp_async_commit();
  };
  issue_tile(0);  // with Q

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const uint32_t my_q = sq_base + wg * kQBytes;

  for (int k0 = 0, it = 0; k0 < k_end; k0 += BN, ++it) {
    const uint32_t cur = kv_base + (it % 2) * 2 * kKVBytes;
    issue_tile(it + 1);  // loads while tile it is computed
    cp_async_wait<1>();  // the next tile may still be in flight
    // the copies were generic-proxy writes; wgmma reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (k0 < wg_end) {  // warpgroup-uniform
      float sacc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // both K-major: 16 columns = 32 bytes further along the swizzled rows
        const uint32_t col = (kk % 4) * 32;
        const uint64_t db = sw128_desc(cur + (kk / 4) * (BN * 128) + col, 16, 1024);
        const uint64_t da = sw128_desc(my_q + (kk / 4) * (64 * 128) + col, 16, 1024);
        if constexpr (BN == 64)
          wgmma_ss_m64n64k16(sacc, da, db, kk > 0);
        else
          wgmma_ss_m64n128k16(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sacc[4 * j + e];
      float o4[ND][4];
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o4[n][e] = o[4 * n + e];
      const bool masked = causal && k0 + BN - 1 > w0 + off;
      softmax_tile<NK, ND>(masked, s, o4, m, l, row, k0, off, scale, rate, keep, seed,
                           bh);
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] = o4[n][e];

      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // V is MN-major: 16 keys = 16 rows of 128 bytes further; its column
        // blocks of 64 lie BN rows apart
        const uint64_t dv = sw128_desc(cur + kKVBytes + kk * 16 * 128, BN * 128, 1024);
        if constexpr (D == 64)
          wgmma_m64n64k16<1>(o, pa[kk], dv, 1);
        else
          wgmma_m64n128k16<1>(o, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncthreads();  // every warpgroup is done with the stage before it is refilled
  }
  // no copy may still be in flight when the block ends: with no visible key
  // (k_end 0) the loop never waited for Q's group
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!rows_live) return;
  float o4[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o4[n][e] = o[4 * n + e];
  store_rows<D>(o4, m, l, row, out, lse, bh, sq);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int sq, int sk, int causal, float scale,
                        float rate, float keep, uint32_t seed) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16, ND = D / 8, NK = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kMmaRows][LD]
  bf16* dos = qs + kMmaRows * LD;                // [kMmaRows][LD]
  bf16* ks = dos + kMmaRows * LD;                // [kTile][LD]
  bf16* vs = ks + kTile * LD;                    // [kTile][LD]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int off = sk - sq;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;
  int k_end = sk;
  if (causal) k_end = min(sk, max(0, q0 + kMmaRows + off));

  stage_rows<D>(qs, q + (size_t)bh * sq * D, q0, kMmaRows);
  stage_rows<D>(dos, dout + (size_t)bh * sq * D, q0, kMmaRows);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = lse[(size_t)bh * sq + row[h]];
    row_delta[h] = delta[(size_t)bh * sq + row[h]];
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage_rows<D>(ks, kb, k0, kTile);
    stage_rows<D>(vs, vb, k0, kTile);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, qs, LD, warp * 16, 16 * kk);
      load_a(ado, dos, LD, warp * 16, 16 * kk);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t b0, b1;
        load_b_t(b0, b1, ks, LD, 8 * j, 16 * kk);
        mma16816(s[j], aq, b0, b1);
        load_b_t(b0, b1, vs, LD, 8 * j, 16 * kk);
        mma16816(dp[j], ado, b0, b1);
      }
    }

#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
        const bool vis = !causal || row[h] + off >= k_pos;
        const float p = vis ? expf(s[j][e] * scale - row_lse[h]) : 0.f;
        float gr = dp[j][e];
        if (rate > 0.f) {
          const float u = uniform01(seed, bh, row[h], k_pos);
          gr = u >= rate ? gr / keep : 0.f;
        }
        s[j][e] = p * (gr - row_delta[h]);  // ds
      }

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, LD, 8 * n, 16 * kk);
        mma16816(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* drow = dq + ((size_t)bh * sq + row[h]) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// queries per iteration of the dK/dV loop: D = 128 halves it to keep the
// two D-wide accumulators and the score tiles within the register budget
template <int D>
__host__ __device__ constexpr int mma_dkv_q_tile() { return D == 128 ? 32 : 64; }

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                         int causal, float scale, float rate, float keep, uint32_t seed) {
  constexpr int LD = D + 8;
  constexpr int NQ = mma_dkv_q_tile<D>();
  constexpr int KD = D / 16, ND = D / 8, NJ = NQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kMmaRows][LD]
  bf16* vs = ks + kMmaRows * LD;                 // [kMmaRows][LD]
  bf16* qs = vs + kMmaRows * LD;                 // [NQ][LD]
  bf16* dos = qs + NQ * LD;                      // [NQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + NQ * LD);  // [NQ]
  float* delta_s = lse_s + NQ;                              // [NQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int off = sk - sq;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* db = dout + (size_t)bh * sq * D;
  int q_begin = 0;
  if (causal) q_begin = max(0, (k0 - off) / NQ * NQ);

  stage_rows<D>(ks, k + (size_t)bh * sk * D, k0, kMmaRows);
  stage_rows<D>(vs, v + (size_t)bh * sk * D, k0, kMmaRows);
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = q_begin; q0 < sq; q0 += NQ) {
    __syncthreads();
    stage_rows<D>(qs, qb, q0, NQ);
    stage_rows<D>(dos, db, q0, NQ);
    if (threadIdx.x < NQ) {
      lse_s[threadIdx.x] = lse[(size_t)bh * sq + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[(size_t)bh * sq + q0 + threadIdx.x];
    }
    __syncthreads();

    // s^T (keys x queries) = K Q^T and dp^T = V dO^T
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, ks, LD, warp * 16, 16 * kk);
      load_a(av, vs, LD, warp * 16, 16 * kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        load_b_t(b0, b1, qs, LD, 8 * j, 16 * kk);
        mma16816(s[j], ak, b0, b1);
        load_b_t(b0, b1, dos, LD, 8 * j, 16 * kk);
        mma16816(dp[j], av, b0, b1);
      }
    }

    // s becomes p_eff^T, dp becomes ds^T
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int q_pos = q0 + c, k_pos = key[e / 2];
        const bool vis = !causal || q_pos + off >= k_pos;
        const float p = vis ? expf(s[j][e] * scale - lse_s[c]) : 0.f;
        float p_eff = p, gr = dp[j][e];
        if (rate > 0.f) {
          const float u = uniform01(seed, bh, q_pos, k_pos);
          const float keep_mask = (u >= rate ? 1.f : 0.f) / keep;
          p_eff = p * keep_mask;
          gr = gr * keep_mask;
        }
        s[j][e] = p_eff;
        dp[j][e] = p * (gr - delta_s[c]);
      }

#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk) {
      const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t ad[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, dos, LD, 8 * n, 16 * kk);
        mma16816(dv_acc[n], ap, b0, b1);
        load_b(b0, b1, qs, LD, 8 * n, 16 * kk);
        mma16816(dk_acc[n], ad, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = ((size_t)bh * sk + key[h]) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + r + 8 * n + 2 * t) =
          pack_bf16(dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + r + 8 * n + 2 * t) =
          pack_bf16(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 backward, redesigned for Hopper: flash_bwd_dq_wgmma_kernel<D>
// and flash_bwd_dkv_wgmma_kernel<D> below, built from the forward redesign's
// pieces.  A block holds two warpgroups of 64 rows of its own side (query rows
// for dQ, keys for dK/dV), which sits in 128-byte-swizzled shared memory for
// the whole run; the other side's tiles (K/V for dQ; Q/dO with their lse and
// delta rows for dK/dV) come through a ring of kBwdStages cp.async stages
// while the tiles before are computed, with one block barrier per tile.  Both
// score products (S and dP, or S^T and dP^T) are SS-wgmma with K-major
// operands; the gradient products take the bfloat16 ds (or p_eff^T, ds^T)
// from registers as the A operand (RS-wgmma) and read the tile's rows
// MN-major, as the forward reads V.  The arithmetic is the first designs'
// above, operation for operation: p = expf(s * scale - lse) zeroed by the
// mask, ds = p * (gr - delta) in float32 with gr the dropout-scaled dp, p_eff
// and ds rounded to bfloat16 before their products, float32 accumulation,
// scale applied to dQ and dK at the store, the dropout hash only when
// rate > 0.  Visibility is tested only on tiles that cross a row's diagonal.
// dQ and dK/dV stay two passes with no atomics, as the JAX _flash_bwd has
// them, so the sums are the same from run to run.

// D (64 x 32, float32) += A (64 x 16) . B (16 x 32), bfloat16, both from shared
// memory through their descriptors, K-major
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// descriptor of k-step kk (16 columns, 32 bytes) of a swizzled tile of `rows`
// rows read K-major (its columns are the product's k)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + (kk / 4) * (rows * 128) + (kk % 4) * 32, 16, 1024);
}
// descriptor of k-step kk (16 rows) of a swizzled tile of `rows` rows read
// MN-major (its rows are the product's k, its columns the product's n); the
// column blocks of 64 lie `rows` rows apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

// acc (64 x N) = A . B^T over D: A the warpgroup's 64-row tile at `a`, B an
// N-row tile at `b`, both (rows x D) swizzled and read K-major
template <int D, int N>
__device__ __forceinline__ void wgmma_nt(float (&acc)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = kmajor_desc(a, 64, kk), db = kmajor_desc(b, N, kk);
    if constexpr (N == 32)
      wgmma_ss_m64n32k16(acc, da, db, kk > 0);
    else
      wgmma_ss_m64n64k16(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += A . B: A (64 x K) packed bfloat16 fragments in registers, B
// the K-row tile at `b` (K x D, swizzled, read MN-major)
template <int D, int K>
__device__ __forceinline__ void wgmma_nn(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if constexpr (D == 64)
      wgmma_m64n64k16<1>(acc, a[kk], mnmajor_desc(b, K, kk), 1);
    else
      wgmma_m64n128k16<1>(acc, a[kk], mnmajor_desc(b, K, kk), 1);
  }
}

// a float32 accumulator tile (64 x 8 * NB) as bfloat16 A fragments: n8 blocks
// 2kk and 2kk + 1 make k-step kk
template <int NB>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NB / 2][4], const float (&x)[NB * 4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// dQ's tile step for one thread's two query rows over NB n8 blocks of keys
// from k0: s (S) becomes ds = p * (gr - delta); dp holds dO.V^T
template <int NB, bool kMask>
__device__ __forceinline__ void dq_ds(float (&s)[NB * 4], const float (&dp)[NB * 4],
                                      const int (&row)[2], const float (&lse)[2],
                                      const float (&delta)[2], int k0, int off, float scale,
                                      float rate, float keep, uint32_t seed, int bh) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e / 2;
      const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
      const bool vis = !kMask || row[h] + off >= k_pos;
      // a row with no visible key saved lse ~ -1e30: the mask zeroes p
      const float p = vis ? expf(s[4 * j + e] * scale - lse[h]) : 0.f;
      float gr = dp[4 * j + e];
      if (rate > 0.f) {
        const float u = uniform01(seed, bh, row[h], k_pos);
        gr = u >= rate ? gr / keep : 0.f;
      }
      s[4 * j + e] = p * (gr - delta[h]);
    }
}

// dK/dV's tile step for one thread's two keys over NB n8 blocks of queries
// from q0 (lse_s, delta_s: the tile's rows): s (S^T) becomes p_eff^T, dp
// (dP^T) becomes ds^T
template <int NB, bool kMask>
__device__ __forceinline__ void dkv_ds(float (&s)[NB * 4], float (&dp)[NB * 4],
                                       const int (&key)[2], const float* lse_s,
                                       const float* delta_s, int q0, int off, float scale,
                                       float rate, float keep, uint32_t seed, int bh) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const int q_pos = q0 + c, k_pos = key[e / 2];
      const bool vis = !kMask || q_pos + off >= k_pos;
      const float p = vis ? expf(s[4 * j + e] * scale - lse_s[c]) : 0.f;
      float p_eff = p, gr = dp[4 * j + e];
      if (rate > 0.f) {
        const float u = uniform01(seed, bh, q_pos, k_pos);
        const float keep_mask = (u >= rate ? 1.f : 0.f) / keep;
        p_eff = p * keep_mask;
        // rounded before the subtraction below, as the JAX kernel and the
        // plain version round it (a contracted FMA would not)
        gr = __fmul_rn(gr, keep_mask);
      }
      s[4 * j + e] = p_eff;
      dp[4 * j + e] = p * (gr - delta_s[c]);
    }
}

constexpr int kBwdWarpgroups = 2;  // warpgroups (of 64 rows each) per block
constexpr int kBwdStages = 3;      // stages of the ring
constexpr int kBwdKeys = 64;       // keys per K/V tile of the dQ ring
// blocks of dQ at D 64 an SM should hold (__launch_bounds__), which caps its
// registers at 128 a thread, with no spill; dK/dV and D 128 need more and
// take one
constexpr int kDqMinBlocks = 2;

template <int D>
__global__ void __launch_bounds__(128 * kBwdWarpgroups, D == 64 ? kDqMinBlocks : 1)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int sq, int sk, int causal, float scale,
                          float rate, float keep, uint32_t seed) {
  constexpr int NWG = kBwdWarpgroups, NS = kBwdStages, BN = kBwdKeys, NB = BN / 8;
  constexpr uint32_t kRowsBytes = 64 * D * 2;  // one warpgroup's Q or dO tile
  constexpr uint32_t kKVBytes = BN * D * 2;    // one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [Q: NWG tiles][dO: NWG tiles][NS stages: K | V], on 1024 bytes
  const uint32_t q_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_base = q_base + NWG * kRowsBytes;
  const uint32_t kv_base = do_base + NWG * kRowsBytes;

  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int q0 = blockIdx.x * 64 * NWG;  // the block's first row
  const int w0 = q0 + wg * 64;           // this warpgroup's first row
  const int off = sk - sq;
  const int row[2] = {w0 + warp * 16 + g, w0 + warp * 16 + g + 8};
  const bool rows_live = w0 < sq;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;
  int k_end = sk;  // the block's keys; a warpgroup stops at its own diagonal
  if (causal) k_end = min(sk, max(0, min(sq, q0 + 64 * NWG) + off));
  int wg_end = rows_live ? sk : 0;
  if (causal && rows_live) wg_end = min(sk, max(0, w0 + 64 + off));

  // Q and dO of every live warpgroup, then the first K/V tile: one group
  const int q_rows = min(64 * NWG, sq - q0);
  for (int w = 0; w < NWG; ++w)
    if (64 * w < q_rows) {
      const size_t r0 = (size_t)bh * sq + q0 + 64 * w;
      issue_rows_sw128<D>(q_base + w * kRowsBytes, q + r0 * D, 64);
      issue_rows_sw128<D>(do_base + w * kRowsBytes, dout + r0 * D, 64);
    }
  // tile i into stage i % NS, as one committed group (empty past the block's keys)
  auto issue_tile = [&](int i) {
    if (i * BN < k_end) {
      const uint32_t st = kv_base + (i % NS) * 2 * kKVBytes;
      issue_rows_sw128<D>(st, kb + (size_t)i * BN * D, BN);
      issue_rows_sw128<D>(st + kKVBytes, vb + (size_t)i * BN * D, BN);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue_tile(i);

  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (rows_live)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_lse[h] = lse[(size_t)bh * sq + row[h]];
      row_delta[h] = delta[(size_t)bh * sq + row[h]];
    }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t my_q = q_base + wg * kRowsBytes, my_do = do_base + wg * kRowsBytes;

  for (int k0 = 0, it = 0; k0 < k_end; k0 += BN, ++it) {
    const uint32_t cur = kv_base + (it % NS) * 2 * kKVBytes;
    cp_async_wait<NS - 2>();  // tile it has landed
    // the copies were generic-proxy writes; wgmma reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // every thread's copies are in, and every warpgroup is done with tile
    // it - 1, whose stage the next issue refills
    __syncthreads();
    issue_tile(it + NS - 1);  // loads while tile it is computed

    if (k0 < wg_end) {  // warpgroup-uniform
      float s[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      wgmma_nt<D, BN>(s, my_q, cur);              // S = Q.K^T
      wgmma_nt<D, BN>(dp, my_do, cur + kKVBytes);  // dP = dO.V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      if (causal && k0 + BN - 1 > w0 + off)
        dq_ds<NB, true>(s, dp, row, row_lse, row_delta, k0, off, scale, rate, keep, seed, bh);
      else
        dq_ds<NB, false>(s, dp, row, row_lse, row_delta, k0, off, scale, rate, keep, seed, bh);
      uint32_t da[BN / 16][4];
      pack_a<NB>(da, s);
      fence_regs(acc);
      wgmma_fence();
      wgmma_nn<D, BN>(acc, da, cur);  // dQ += dS.K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
  }
  // no copy may still be in flight when the block ends: with no visible key
  // (k_end 0) the loop never waited for Q's group
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!rows_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* drow = dq + ((size_t)bh * sq + row[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n + 2 * t) =
          pack_bf16(acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
  }
}

// queries per Q/dO tile of the dK/dV ring: D 128 halves it, so that the two
// D-wide accumulators and the two score tiles fit in a thread's registers
template <int D>
__host__ __device__ constexpr int wgmma_dkv_q_tile() { return D == 128 ? 32 : 64; }

template <int D>
__global__ void __launch_bounds__(128 * kBwdWarpgroups, 1)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                           int causal, float scale, float rate, float keep, uint32_t seed) {
  constexpr int NWG = kBwdWarpgroups, NS = kBwdStages, BQ = wgmma_dkv_q_tile<D>(), NB = BQ / 8;
  constexpr uint32_t kKeyBytes = 64 * D * 2;  // one warpgroup's K or V tile
  constexpr uint32_t kQBytes = BQ * D * 2;    // one Q or dO tile
  constexpr uint32_t kStageBytes = 2 * kQBytes + 1024;  // Q | dO | lse, delta
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [K: NWG tiles][V: NWG tiles][NS stages], each on 1024 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_base = (raw + 1023u) & ~1023u;
  const uint32_t v_base = k_base + NWG * kKeyBytes;
  const uint32_t ring = v_base + NWG * kKeyBytes;

  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int k0 = blockIdx.x * 64 * NWG;  // the block's first key
  const int kw0 = k0 + wg * 64;          // this warpgroup's first key
  const int off = sk - sq;
  const int key[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
  const bool keys_live = kw0 < sk;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* db = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;
  // the first q tile whose last row can see the block's (the warpgroup's)
  // first key
  int q_begin = 0;
  if (causal) q_begin = max(0, (k0 - off) / BQ * BQ);
  int wg_begin = keys_live ? 0 : sq;
  if (causal && keys_live) wg_begin = max(0, (kw0 - off) / BQ * BQ);

  // K and V of every live warpgroup, then the first Q/dO tile: one group
  const int k_rows = min(64 * NWG, sk - k0);
  for (int w = 0; w < NWG; ++w)
    if (64 * w < k_rows) {
      const size_t r0 = (size_t)bh * sk + k0 + 64 * w;
      issue_rows_sw128<D>(k_base + w * kKeyBytes, k + r0 * D, 64);
      issue_rows_sw128<D>(v_base + w * kKeyBytes, v + r0 * D, 64);
    }
  // tile i (queries q_begin + i * BQ ..) into stage i % NS with its lse and
  // delta rows, as one committed group (empty past the last query)
  auto issue_tile = [&](int i) {
    const int r0 = q_begin + i * BQ;
    if (r0 < sq) {
      const uint32_t st = ring + (i % NS) * kStageBytes;
      issue_rows_sw128<D>(st, qb + (size_t)r0 * D, BQ);
      issue_rows_sw128<D>(st + kQBytes, db + (size_t)r0 * D, BQ);
      for (int idx = threadIdx.x; idx < BQ / 2; idx += blockDim.x) {
        const int which = idx / (BQ / 4), piece = idx % (BQ / 4);  // 4 floats a piece
        cp_async16(st + 2 * kQBytes + which * BQ * 4 + piece * 16,
                   (which ? deb : lb) + r0 + 4 * piece);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue_tile(i);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t my_k = k_base + wg * kKeyBytes, my_v = v_base + wg * kKeyBytes;

  for (int q0 = q_begin, it = 0; q0 < sq; q0 += BQ, ++it) {
    const uint32_t cur = ring + (it % NS) * kStageBytes;
    const float* lse_s = reinterpret_cast<const float*>(smem_raw + (cur - raw) + 2 * kQBytes);
    const float* delta_s = lse_s + BQ;
    cp_async_wait<NS - 2>();  // tile it has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // as in dQ: tile it is in, tile it - 1 is done
    issue_tile(it + NS - 1);  // loads while tile it is computed

    if (q0 >= wg_begin) {  // warpgroup-uniform
      float s[BQ / 2], dp[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      wgmma_nt<D, BQ>(s, my_k, cur);             // S^T = K.Q^T
      wgmma_nt<D, BQ>(dp, my_v, cur + kQBytes);  // dP^T = V.dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      // the tile's first query cannot see the warpgroup's last key
      if (causal && q0 + off < kw0 + 63)
        dkv_ds<NB, true>(s, dp, key, lse_s, delta_s, q0, off, scale, rate, keep, seed, bh);
      else
        dkv_ds<NB, false>(s, dp, key, lse_s, delta_s, q0, off, scale, rate, keep, seed, bh);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      pack_a<NB>(pa, s);
      pack_a<NB>(da, dp);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      wgmma_nn<D, BQ>(dv_acc, pa, cur + kQBytes);  // dV += P_eff^T.dO
      wgmma_nn<D, BQ>(dk_acc, da, cur);            // dK += dS^T.Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!keys_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = ((size_t)bh * sk + key[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + r + 8 * n + 2 * t) =
          pack_bf16(dk_acc[4 * n + 2 * h] * scale, dk_acc[4 * n + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + r + 8 * n + 2 * t) =
          pack_bf16(dv_acc[4 * n + 2 * h], dv_acc[4 * n + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The float32 backward on the tensor cores: flash_bwd_dq_tf32_kernel<D> and
// flash_bwd_dkv_tf32_kernel<D> below.  Every product is 3xTF32: each
// operand x splits into hi = x rounded to TF32 (to nearest: half a TF32 step
// added, the low 13 bits cleared) and lo = x - hi (exact in float32; the tensor
// core reads its top TF32 bits), and a . b is taken as lo_a . hi_b +
// hi_a . lo_b + hi_a . hi_b on mma.sync.m16n8k8.tf32 with float32
// accumulation, the cross terms first.  That carries about 21 bits of each
// product against TF32's 11, and the products run on the tensor cores at a
// third of the TF32 rate, 2.5x the CUDA cores' float32 rate.  The sums are
// less accurate than FMAs' all the same: the tensor core rounds each mma's
// float32 sum mostly toward zero, so its error is biased and grows with the
// length of the sum.  On an H100 (tools/torch_tf32_probe.py), 87% of
// one-step results equal the exact sum rounded toward zero and 63% equal it
// rounded to nearest; a 3xTF32 dot product of 2048 terms lands 1.4e-5 of
// the largest result off (to nearest would give 1.0e-6; cuBLAS's FMAs
// 3.3e-7).  dQ, dK and dV stay within 3.1e-5 of the plain version against
// FLASH_TOL's 1e-4; one TF32 product lands 7.7e-4 to 1.2e-3 off.
// Rounding hi to nearest rather than cutting it halves lo, which lowers the
// error and, on an H100, also ran faster.  The split happens in registers as
// each fragment is loaded, so the tiles in shared memory stay the inputs' own
// words.
//
// A block of four warps owns 64 rows of its own side (query rows for dQ,
// keys for dK/dV), 16 a warp, which stay in shared memory for the whole run;
// the other side's tiles (K/V for dQ; Q/dO with their lse and delta rows for
// dK/dV) come through a ring of kTfStages cp.async stages with one block
// barrier per tile, as in the bfloat16 redesign.  TF32 wgmma reads its
// shared-memory operands K-major only, and the gradient products contract
// over the tile's rows, so every product runs on mma.sync instead, whose
// fragments come from shared memory in either direction:
// * the score products (S and dP, or S^T and dP^T) contract over D, reading
//   both tiles along their rows 16 bytes at a time (one 16-byte load holds
//   two k-steps: column t of k-step 2u is d = 16u + 4t, column t + 4 is
//   d = 16u + 4t + 1, k-step 2u + 1 the next two; A and B alike);
// * the gradient products contract over the tile's rows with ds (p_eff^T,
//   ds^T) as A straight from the score accumulators: an accumulator holds
//   columns 2t and 2t + 1 where an A fragment wants t and t + 4, so the key
//   (query) order of each k-step is permuted alike in A and B (column t is
//   key 2t, column t + 4 key 2t + 1) and no value moves between lanes.
// Rows sit in shared memory unpadded, their 16-byte pieces permuted by
// tf_swz(row), which keeps both load directions free of bank conflicts.  The
// arithmetic around the products is the FMA kernels' (dq_ds, dkv_ds: expf(s *
// scale - lse) zeroed by the mask, ds in float32, the dropout hash only when
// rate > 0, scale at the store); rows that see no key give 0; dQ and dK/dV
// stay two passes without atomics, so the sums repeat from run to run.
constexpr int kTfWarps = 4;                 // warps per block, 16 own rows each
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfRows = 16 * kTfWarps;      // own rows per block
constexpr int kTfStages = 2;                // stages of the ring
constexpr int kTfKeys = 64;                 // keys per K/V tile of dQ's ring
// blocks an SM should hold at D 64 (__launch_bounds__); shared memory holds
// two at D 64 and one at D 128
constexpr int kTfMinBlocks = 2;
// queries per Q/dO tile of dK/dV's ring: D 128 halves it, so that the two
// D-wide accumulators and the two score tiles fit in a thread's registers
template <int D>
__host__ __device__ constexpr int tf32_dkv_q_tile() { return D == 128 ? 32 : 64; }

// the permutation of row r's 16-byte pieces (within each 128 bytes)
__device__ __forceinline__ int tf_swz(int r) { return (r & 6) ^ ((r & 1) << 2); }

// float offset of element (r, c) of a tile of D-float rows
template <int D>
__device__ __forceinline__ int tf_at(int r, int c) {
  return r * D + ((((c >> 2) ^ tf_swz(r)) << 2) | (c & 3));
}

// Start the copy of `rows` rows of a (S, D) float32 matrix (from `src`) into
// the tile at shared address `dst`.  Every thread of the block takes pieces.
template <int D>
__device__ __forceinline__ void issue_rows_tf(uint32_t dst, const float* __restrict__ src,
                                              int rows) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(dst + 4 * (r * D + ((c ^ tf_swz(r)) << 2)), src + (size_t)r * D + 4 * c);
  }
}

// x = hi + lo: hi x rounded to its TF32 head (to nearest, ties away from 0;
// the low 13 bits cleared), lo the exact rest (at most half a TF32 step)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (one n8 block of a 16 x 8 accumulator) += a . b on m16n8k8.tf32
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n8 block n of `d` += a . b in 3xTF32 (a and b split into hi and lo):
// lo . hi, hi . lo, hi . hi
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N], int n, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d[4 * n], d[4 * n + 1], d[4 * n + 2], d[4 * n + 3], al, bh0, bh1);
  mma_tf32(d[4 * n], d[4 * n + 1], d[4 * n + 2], d[4 * n + 3], ah, bl0, bl1);
  mma_tf32(d[4 * n], d[4 * n + 1], d[4 * n + 2], d[4 * n + 3], ah, bh0, bh1);
}

// c (16 x 8 NB, accumulator layout, flat: n8 block n at c[4n ..]) = A . B^T
// over D: A the warp's 16 rows from row `arow` of tile `a`, B the NB * 8 rows
// of tile `b`
template <int D, int NB>
__device__ __forceinline__ void tf_mma_nt(float (&c)[NB * 4], const float* a, int arow,
                                          const float* b) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < NB * 4; ++i) c[i] = 0.f;
  // rows g (mod 8) of both tiles: piece 4u + t sits at 4 * ((4u + t) ^ swz)
  const int swz = tf_swz(g);
  const int pc[2] = {4 * (t ^ swz), 4 * ((4 | t) ^ swz)};  // u even, u odd
  const float* a0 = a + (arow + g) * D;
  const float* b0 = b + g * D;
#pragma unroll
  for (int u = 0; u < D / 16; ++u) {
    const int col = 32 * (u / 2) + pc[u % 2];
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + col);
    const float4 x1 = *reinterpret_cast<const float4*>(a0 + 8 * D + col);
    uint32_t ah[2][4], al[2][4];
    split_tf32(x0.x, ah[0][0], al[0][0]);
    split_tf32(x1.x, ah[0][1], al[0][1]);
    split_tf32(x0.y, ah[0][2], al[0][2]);
    split_tf32(x1.y, ah[0][3], al[0][3]);
    split_tf32(x0.z, ah[1][0], al[1][0]);
    split_tf32(x1.z, ah[1][1], al[1][1]);
    split_tf32(x0.w, ah[1][2], al[1][2]);
    split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float4 y = *reinterpret_cast<const float4*>(b0 + 8 * n * D + col);
      uint32_t bh[4], bl[4];
      split_tf32(y.x, bh[0], bl[0]);
      split_tf32(y.y, bh[1], bl[1]);
      split_tf32(y.z, bh[2], bl[2]);
      split_tf32(y.w, bh[3], bl[3]);
      mma_3xtf32(c, n, ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma_3xtf32(c, n, ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// acc (16 x D, accumulator layout) += X . T: X (16 x 8 NB) in accumulator
// layout (ds, p_eff^T or ds^T), T the tile's first 8 NB rows (8 NB x D).
// k-step j holds rows 8j .. 8j + 7, column t of A (row t of B) row 8j + 2t and
// column t + 4 row 8j + 2t + 1, which is where the accumulator has them.
template <int D, int NB>
__device__ __forceinline__ void tf_mma_nn(float (&acc)[D / 2], const float (&x)[NB * 4],
                                          const float* tile) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  // element (8j + 2t, 8n + g) sits at piece (2n + g / 4) ^ 2t of its row, and
  // (8j + 2t + 1, 8n + g) at (2n + g / 4) ^ 2t ^ 4: in floats,
  // 32 (n / 4) + 8 ((n % 4) ^ t) (even row) or ^ (t ^ 2) (odd row), + g's own
  int pc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) pc[m] = 8 * (m ^ t) + 4 * (g / 4) + (g % 4);
  const float* r0 = tile + 2 * t * D;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(x[4 * j + 0], ah[0], al[0]);  // (g, key 2t)
    split_tf32(x[4 * j + 2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32(x[4 * j + 1], ah[2], al[2]);  // (g, key 2t + 1)
    split_tf32(x[4 * j + 3], ah[3], al[3]);  // (g + 8, key 2t + 1)
    const float* re = r0 + 8 * j * D;
    const float* ro = re + D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int cn = 32 * (n / 4);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(re[cn + pc[n % 4]], bh0, bl0);
      split_tf32(ro[cn + pc[(n % 4) ^ 2]], bh1, bl1);
      mma_3xtf32(acc, n, ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTfThreads, D == 64 ? kTfMinBlocks : 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int sq, int sk, int causal, float scale,
                         float rate, float keep, uint32_t seed) {
  constexpr int NS = kTfStages, BN = kTfKeys, NB = BN / 8;
  constexpr int kRowsF = kTfRows * D;  // floats of the block's Q (or dO) tile
  constexpr int kTileF = BN * D;       // floats of one K (or V) tile
  extern __shared__ __align__(16) float tf_smem[];
  // [Q][dO][NS stages: K | V]
  float* qs = tf_smem;
  float* dos = qs + kRowsF;
  float* ring = dos + kRowsF;

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int q0 = blockIdx.x * kTfRows;  // the block's first row
  const int w0 = q0 + 16 * warp;        // this warp's first row
  const int off = sk - sq;
  const int row[2] = {w0 + g, w0 + g + 8};
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;
  int k_end = sk;  // the block's keys; a warp stops at its own diagonal
  if (causal) k_end = min(sk, max(0, q0 + kTfRows + off));
  int w_end = sk;
  if (causal) w_end = min(sk, max(0, w0 + 16 + off));

  // Q and dO, then the first K/V tile: one group
  issue_rows_tf<D>(smem_u32(qs), q + ((size_t)bh * sq + q0) * D, kTfRows);
  issue_rows_tf<D>(smem_u32(dos), dout + ((size_t)bh * sq + q0) * D, kTfRows);
  // tile i into stage i % NS, as one committed group (empty past the block's keys)
  auto issue_tile = [&](int i) {
    if (i * BN < k_end) {
      float* st = ring + (i % NS) * 2 * kTileF;
      issue_rows_tf<D>(smem_u32(st), kb + (size_t)i * BN * D, BN);
      issue_rows_tf<D>(smem_u32(st + kTileF), vb + (size_t)i * BN * D, BN);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue_tile(i);

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = lse[(size_t)bh * sq + row[h]];
    row_delta[h] = delta[(size_t)bh * sq + row[h]];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int k0 = 0, it = 0; k0 < k_end; k0 += BN, ++it) {
    const float* ks = ring + (it % NS) * 2 * kTileF;
    const float* vs = ks + kTileF;
    cp_async_wait<NS - 2>();  // tile it has landed
    // every thread's copies are in, and every warp is done with tile it - 1,
    // whose stage the next issue refills
    __syncthreads();
    issue_tile(it + NS - 1);  // loads while tile it is computed

    if (k0 < w_end) {  // warp-uniform
      float s[NB * 4], dp[NB * 4];
      tf_mma_nt<D, NB>(s, qs, 16 * warp, ks);    // S = Q.K^T
      tf_mma_nt<D, NB>(dp, dos, 16 * warp, vs);  // dP = dO.V^T
      if (causal && k0 + BN - 1 > w0 + off)
        dq_ds<NB, true>(s, dp, row, row_lse, row_delta, k0, off, scale, rate, keep, seed, bh);
      else
        dq_ds<NB, false>(s, dp, row, row_lse, row_delta, k0, off, scale, rate, keep, seed, bh);
      tf_mma_nn<D, NB>(acc, s, ks);  // dQ += dS.K
    }
  }
  // no copy may still be in flight when the block ends: with no visible key
  // (k_end 0) the loop never waited for Q's group
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* drow = dq + ((size_t)bh * sq + row[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n + 2 * t) =
          make_float2(acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kTfThreads, D == 64 ? kTfMinBlocks : 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                          int causal, float scale, float rate, float keep, uint32_t seed) {
  constexpr int NS = kTfStages, BQ = tf32_dkv_q_tile<D>(), NB = BQ / 8;
  constexpr int kRowsF = kTfRows * D;             // floats of the block's K (or V) tile
  constexpr int kTileF = BQ * D;                  // floats of one Q (or dO) tile
  constexpr int kStageF = 2 * kTileF + 2 * BQ;    // Q | dO | lse | delta
  extern __shared__ __align__(16) float tf_smem[];
  // [K][V][NS stages]
  float* ks = tf_smem;
  float* vs = ks + kRowsF;
  float* ring = vs + kRowsF;

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int k0 = blockIdx.x * kTfRows;  // the block's first key
  const int kw0 = k0 + 16 * warp;       // this warp's first key
  const int off = sk - sq;
  const int key[2] = {kw0 + g, kw0 + g + 8};
  const float* qb = q + (size_t)bh * sq * D;
  const float* db = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;
  // the first q tile whose last row can see the block's (the warp's) first key
  int q_begin = 0, w_begin = 0;
  if (causal) {
    q_begin = max(0, (k0 - off) / BQ * BQ);
    w_begin = max(0, (kw0 - off) / BQ * BQ);
  }

  // K and V, then the first Q/dO tile: one group
  issue_rows_tf<D>(smem_u32(ks), k + ((size_t)bh * sk + k0) * D, kTfRows);
  issue_rows_tf<D>(smem_u32(vs), v + ((size_t)bh * sk + k0) * D, kTfRows);
  // tile i (queries q_begin + i * BQ ..) into stage i % NS with its lse and
  // delta rows, as one committed group (empty past the last query)
  auto issue_tile = [&](int i) {
    const int r0 = q_begin + i * BQ;
    if (r0 < sq) {
      float* st = ring + (i % NS) * kStageF;
      issue_rows_tf<D>(smem_u32(st), qb + (size_t)r0 * D, BQ);
      issue_rows_tf<D>(smem_u32(st + kTileF), db + (size_t)r0 * D, BQ);
      for (int idx = threadIdx.x; idx < BQ / 2; idx += blockDim.x) {
        const int which = idx / (BQ / 4), piece = idx % (BQ / 4);  // 4 floats a piece
        cp_async16(smem_u32(st + 2 * kTileF + which * BQ + 4 * piece),
                   (which ? deb : lb) + r0 + 4 * piece);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue_tile(i);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = q_begin, it = 0; q0 < sq; q0 += BQ, ++it) {
    const float* qs = ring + (it % NS) * kStageF;
    const float* dos = qs + kTileF;
    const float* lse_s = qs + 2 * kTileF;
    const float* delta_s = lse_s + BQ;
    cp_async_wait<NS - 2>();  // tile it has landed
    __syncthreads();          // as in dQ: tile it is in, tile it - 1 is done
    issue_tile(it + NS - 1);  // loads while tile it is computed

    if (q0 >= w_begin) {  // warp-uniform
      float s[NB * 4], dp[NB * 4];
      tf_mma_nt<D, NB>(s, ks, 16 * warp, qs);    // S^T = K.Q^T
      tf_mma_nt<D, NB>(dp, vs, 16 * warp, dos);  // dP^T = V.dO^T
      // the tile's first query cannot see the warp's last key
      if (causal && q0 + off < kw0 + 15)
        dkv_ds<NB, true>(s, dp, key, lse_s, delta_s, q0, off, scale, rate, keep, seed, bh);
      else
        dkv_ds<NB, false>(s, dp, key, lse_s, delta_s, q0, off, scale, rate, keep, seed, bh);
      tf_mma_nn<D, NB>(dv_acc, s, dos);  // dV += P_eff^T.dO
      tf_mma_nn<D, NB>(dk_acc, dp, qs);  // dK += dS^T.Q
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = ((size_t)bh * sk + key[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk + r + 8 * n + 2 * t) =
          make_float2(dk_acc[4 * n + 2 * h] * scale, dk_acc[4 * n + 2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + r + 8 * n + 2 * t) =
          make_float2(dv_acc[4 * n + 2 * h], dv_acc[4 * n + 2 * h + 1]);
    }
  }
}

constexpr size_t tile_bytes(int d) { return sizeof(float) * kTile * (d + 1); }
constexpr size_t p_bytes() { return sizeof(float) * kTile * kPLd; }

// launch `kernel` on grid (n_tiles, bh) with `smem` bytes of dynamic shared
// memory; an attribute refusal is cleared so the next launch does not see it
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int n_tiles, int bh, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
  }
  kernel<<<dim3(n_tiles, bh), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

bool bad_shape(int bh, int sq, int sk, int d) {
  return bh < 1 || bh > 65535 || sq < kTile || sk < kTile || sq % kTile || sk % kTile ||
         (d != 64 && d != 128);
}

constexpr size_t mma_tile_bytes(int d, int rows) { return sizeof(bf16) * rows * (d + 8); }

template <int D, int NWG, int BN>
cudaError_t fwd_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                      int bh, int sq, int sk, int causal, float scale, float rate, float keep,
                      uint32_t seed, cudaStream_t s) {
  if (sk % BN) return cudaErrorInvalidValue;  // whole key tiles only
  const size_t smem = 2 * (NWG * 64 + 2 * 2 * BN) * (size_t)D + 1024;
  return launch(flash_fwd_wgmma_kernel<D, NWG, BN>, (sq + 64 * NWG - 1) / (64 * NWG), bh,
                128 * NWG, smem, s, q, k, v, out, lse, sq, sk, causal, scale, rate, keep, seed);
}

// float32 inputs take the FMA kernels, bfloat16 inputs the tensor-core ones:
// the wgmma redesign, or the first design when `first_design` is set
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                int sq, int sk, int causal, float scale, float rate, float keep, uint32_t seed,
                int first_design, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    if (first_design)
      return launch(flash_fwd_mma_kernel<D>, sq / kMmaRows, bh, kMmaThreads,
                    2 * mma_tile_bytes(D, kTile), s, qp, kp, vp, op, lse, sq, sk, causal,
                    scale, rate, keep, seed);
    // two warpgroups per block; 64-key tiles at D 64, 128-key tiles at D 128
    // (the faster of the two on an H100 at each head dim)
    return fwd_wgmma<D, 2, D == 64 ? 64 : 128>(qp, kp, vp, op, lse, bh, sq, sk, causal, scale,
                                                rate, keep, seed, s);
  } else {
    return launch(flash_fwd_kernel<D>, sq / kTile, bh, kThreads,
                  3 * tile_bytes(D) + p_bytes(), s, static_cast<const float*>(q),
                  static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<float*>(out), lse, sq, sk, causal, scale, rate, keep, seed);
  }
}

// the backward's bfloat16 inputs take the wgmma redesign, float32 inputs the
// 3xTF32 kernels; `first_design` launches the first design of either (the
// mma.sync kernels for bfloat16, the FMA kernels for float32)
template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                   int causal, float scale, float rate, float keep, uint32_t seed,
                   int first_design, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    const bf16* dp = static_cast<const bf16*>(dout);
    bf16* out = static_cast<bf16*>(dq);
    if (first_design)
      return launch(flash_bwd_dq_mma_kernel<D>, sq / kMmaRows, bh, kMmaThreads,
                    2 * mma_tile_bytes(D, kMmaRows) + 2 * mma_tile_bytes(D, kTile), s, qp, kp,
                    vp, dp, lse, delta, out, sq, sk, causal, scale, rate, keep, seed);
    constexpr int rows = 64 * kBwdWarpgroups;
    // Q and dO of each warpgroup, the stages of K and V, and the alignment slack
    const size_t smem = 2 * (2 * rows + kBwdStages * 2 * kBwdKeys) * (size_t)D + 1024;
    return launch(flash_bwd_dq_wgmma_kernel<D>, (sq + rows - 1) / rows, bh, 128 * kBwdWarpgroups,
                  smem, s, qp, kp, vp, dp, lse, delta, out, sq, sk, causal, scale, rate, keep,
                  seed);
  } else {
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    const float* dp = static_cast<const float*>(dout);
    float* out = static_cast<float*>(dq);
    if (first_design)
      return launch(flash_bwd_dq_kernel<D>, sq / kTile, bh, kThreads,
                    4 * tile_bytes(D) + p_bytes(), s, qp, kp, vp, dp, lse, delta, out, sq, sk,
                    causal, scale, rate, keep, seed);
    // Q and dO, and the stages of K and V
    const size_t smem = sizeof(float) * (2 * kTfRows + kTfStages * 2 * kTfKeys) * (size_t)D;
    return launch(flash_bwd_dq_tf32_kernel<D>, sq / kTfRows, bh, kTfThreads, smem, s, qp, kp,
                  vp, dp, lse, delta, out, sq, sk, causal, scale, rate, keep, seed);
  }
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int bh, int sq,
                    int sk, int causal, float scale, float rate, float keep, uint32_t seed,
                    int first_design, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    const bf16* dp = static_cast<const bf16*>(dout);
    bf16* dkp = static_cast<bf16*>(dk);
    bf16* dvp = static_cast<bf16*>(dv);
    if (first_design) {
      constexpr int nq = mma_dkv_q_tile<D>();
      return launch(flash_bwd_dkv_mma_kernel<D>, sk / kMmaRows, bh, kMmaThreads,
                    2 * mma_tile_bytes(D, kMmaRows) + 2 * mma_tile_bytes(D, nq) +
                        2 * sizeof(float) * nq,
                    s, qp, kp, vp, dp, lse, delta, dkp, dvp, sq, sk, causal, scale, rate, keep,
                    seed);
    }
    constexpr int rows = 64 * kBwdWarpgroups;
    // K and V of each warpgroup, the stages of Q and dO (each with its lse
    // and delta rows on 1024 bytes), and the alignment slack
    const size_t smem = 2 * (2 * rows + kBwdStages * 2 * wgmma_dkv_q_tile<D>()) * (size_t)D +
                        (kBwdStages + 1) * 1024;
    return launch(flash_bwd_dkv_wgmma_kernel<D>, (sk + rows - 1) / rows, bh,
                  128 * kBwdWarpgroups, smem, s, qp, kp, vp, dp, lse, delta, dkp, dvp, sq, sk,
                  causal, scale, rate, keep, seed);
  } else {
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    const float* dp = static_cast<const float*>(dout);
    float* dkp = static_cast<float*>(dk);
    float* dvp = static_cast<float*>(dv);
    if (first_design)
      return launch(flash_bwd_dkv_kernel<D>, sk / kTile, bh, kThreads,
                    4 * tile_bytes(D) + 2 * p_bytes() + 2 * sizeof(float) * kTile, s, qp, kp,
                    vp, dp, lse, delta, dkp, dvp, sq, sk, causal, scale, rate, keep, seed);
    // K and V, and the stages of Q and dO with their lse and delta rows
    constexpr int nq = tf32_dkv_q_tile<D>();
    const size_t smem =
        sizeof(float) * (2 * kTfRows * (size_t)D + kTfStages * (2 * nq * (size_t)D + 2 * nq));
    return launch(flash_bwd_dkv_tf32_kernel<D>, sk / kTfRows, bh, kTfThreads, smem, s, qp, kp,
                  vp, dp, lse, delta, dkp, dvp, sq, sk, causal, scale, rate, keep, seed);
  }
}

// dispatch on (bfloat16?, head dim) to the template instance
#define FF_DISPATCH(FN, ...)                                                             \
  if (bf16_in) {                                                                         \
    return static_cast<int>(d == 64 ? FN<bf16, 64>(__VA_ARGS__) : FN<bf16, 128>(__VA_ARGS__)); \
  }                                                                                      \
  return static_cast<int>(d == 64 ? FN<float, 64>(__VA_ARGS__) : FN<float, 128>(__VA_ARGS__))

}  // namespace

// q (bh, sq, d), k/v (bh, sk, d), out like q, lse float32 (bh, sq); sq and
// sk multiples of 64, d 64 or 128; all contiguous, in one dtype.
// `first_design` launches a kernel's first design in place of its redesign (for
// timing the two side by side): the bfloat16 kernels' mma.sync designs in place
// of wgmma, and the float32 backward's FMA kernels in place of 3xTF32; the
// float32 forward has one design and ignores it.
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                            int bh, int sq, int sk, int d, int causal, float scale, float rate,
                            float keep, unsigned int seed, int bf16_in, int first_design,
                            void* stream) {
  if (bad_shape(bh, sq, sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(fwd, q, k, v, out, static_cast<float*>(lse), bh, sq, sk, causal, scale, rate,
              keep, seed, first_design, s);
}

extern "C" int ff_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int sq,
                               int sk, int d, int causal, float scale, float rate, float keep,
                               unsigned int seed, int bf16_in, int first_design,
                               void* stream) {
  if (bad_shape(bh, sq, sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(bwd_dq, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, bh, sq, sk, causal, scale, rate, keep, seed,
              first_design, s);
}

extern "C" int ff_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int causal, float scale, float rate,
                                float keep, unsigned int seed, int bf16_in,
                                int first_design, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(bwd_dkv, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dk, dv, bh, sq, sk, causal, scale, rate, keep,
              seed, first_design, s);
}

extern "C" const char* ff_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
