// Paged attention over a block-table-indexed K/V pool, for sm_90a.
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas/paged_attention.py:_kernel
// (launched by _paged_call), for float32 and bfloat16 pools and, with
// quantized=True there, for int8 and float8 e4m3 pools.  It computes, for
// every lane b, head h and query row g (row g of lane b sits at position
// positions[b] + g):
//
//   out[b, g, h] = softmax_k( (q[b, g, h] . K[k]) * scale ) @ V,
//   over the lane's positions k <= positions[b] + g,
//
// where position k lives in page block_tables[b, k / BS] at offset k % BS.
// A quantized pool stores K[k] = sk[k] * Kq[k] and V[k] = sv[k] * Vq[k]:
// 1-byte elements and one float32 scale per position, the scale rows
// sk, sv (num_blocks, BS) indexed by the same physical block as the page.
//
// What bounds it on the card: the bytes of the live K/V pages.  A decode
// step (G = 1) does 4*D flops per K/V position it reads (2*D*4 bytes in
// float32), far below the H100's ~20 flop/byte balance point, so the kernel
// is memory-bound.  What the design does about that: each block reads only
// the pages its rows can see (page index 0 .. last, last = the page of the
// block's last row, clamped to the table), once each, straight from the pool
// through the block table; no dense (B, H, SV, D) gather ever exists.  Pages
// past `last` are never read, so block 0 (the allocator's trash block, which
// idle lanes map) contributes only through positions the causal mask admits.
//
// Design: grid (B, H, ceil(G / ROWS)); one block of four warps per (lane,
// head, row group), looping over the lane's pages 0..last in order.  Each
// warp carries up to kRowsPerWarp query rows with a float32 online softmax
// (running max m, running sum l, accumulator acc in registers).  Pages stream
// through a ring of kStages shared-memory slots filled with cp.async, so the
// loads of the next pages are in flight while the current one is computed
// (one page at a time would leave the block waiting on memory latency for
// every page).  Lane j scores key j of the page with a mul+sum over D (the
// JAX kernel's contraction, walked in a per-lane rotated order so the lanes
// hit different shared-memory banks), times scale, masked to -FLT_MAX where
// k_pos > row_pos; the warp then folds the page into its rows' carries.
// wgmma, TMA and split-K over pages are later work.
//
// Quantized pools (TKV int8_t or __nv_fp8_e4m3): a page's two scale rows
// ride the page's ring slot, fetched through the same block-table entry
// with 4-byte cp.async copies (any BS).  Each stored element widens exactly
// to float32 (int8 by conversion, e4m3 through the f16 conversion), and the
// scales are folded in rather than multiplied into every element: the score
// is s_k = (q . Kq[k]) * sk[k] * scale, and the probability that weights
// Vq[k] is p_k * sv[k] (the running sum l takes p_k itself).  That is the
// JAX kernel's function (dequantize, then the same mul+sum) with one
// multiply per key instead of one per element; the results differ from
// the plain version by float32 rounding only.  The 1-byte pages are 4x
// fewer bytes than float32 ones, but the per-element dependent chain of
// shared-memory reads stays, so the kernel stays far from its bound.
//
// Plain C interface (built by nvcc into a shared library and loaded with
// ctypes): ff_paged_attention returns the cudaGetLastError() code after the
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxDPerLane = 8;  // D <= 256
constexpr int kStages = 4;       // pages in flight per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  // e4m3 -> f16 is exact, and so is f16 -> f32
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte global -> shared copy that does not pass through registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// 4-byte copy, for the scale rows (a row of BS floats need not be 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most kStages - 1 committed groups are still in flight
__device__ __forceinline__ void cp_async_wait_page() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

template <typename TKV>
__host__ __device__ constexpr bool is_quantized() {
  return sizeof(TKV) == 1;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(32 * kWarps)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                       const TKV* __restrict__ pool_v, const float* __restrict__ scale_k,
                       const float* __restrict__ scale_v, const int* __restrict__ positions,
                       const int* __restrict__ block_tables, TQ* __restrict__ out, int G, int H,
                       int D, int BS, int MB, int rows_per_warp, float scale) {
  constexpr bool kQuant = is_quantized<TKV>();
  // the score loop's start element advances by kRot per lane; for 1-byte
  // elements that is one 4-byte word, so neighbouring lanes read different
  // shared-memory banks (at most two lanes share one)
  constexpr int kRot = kQuant ? 4 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows_per_block = kWarps * rows_per_warp;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * rows_per_block;
  const int g_end = min(G, g0 + rows_per_block);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int page_elems = BS * D;

  TKV* kbuf = reinterpret_cast<TKV*>(smem_raw);          // [kStages][BS][D]
  TKV* vbuf = kbuf + kStages * page_elems;                // [kStages][BS][D]
  // the pages end on a 16-byte boundary (BS * D * sizeof(TKV) is a multiple
  // of 16, checked by the wrapper); quantized pools keep their scale rows next
  float* skbuf = reinterpret_cast<float*>(vbuf + kStages * page_elems);  // [kStages][BS]
  float* svbuf = skbuf + (kQuant ? kStages * BS : 0);                    // [kStages][BS]
  float* qs = svbuf + (kQuant ? kStages * BS : 0);        // [rows_per_block][D]
  float* pw = qs + rows_per_block * D + warp * BS;        // this warp's [BS] scores

  const int pos0 = positions[b];
  // the last page any row of this block can see; later pages are never read
  const int last = min((pos0 + g_end - 1) / BS, MB - 1);
  const int* table = block_tables + (size_t)b * MB;
  const int chunks = page_elems * (int)sizeof(TKV) / 16;

  // start the copy of `page` into ring slot `slot`; always commit a group
  // (empty past `last`) so the wait below counts pages uniformly
  auto issue = [&](int page, int slot) {
    if (page <= last) {
      const size_t base = ((size_t)table[page] * H + h) * page_elems;
      const unsigned char* gk = reinterpret_cast<const unsigned char*>(pool_k + base);
      const unsigned char* gv = reinterpret_cast<const unsigned char*>(pool_v + base);
      unsigned char* sk = reinterpret_cast<unsigned char*>(kbuf + slot * page_elems);
      unsigned char* sv = reinterpret_cast<unsigned char*>(vbuf + slot * page_elems);
      for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
        cp_async16(sk + 16 * c, gk + 16 * c);
        cp_async16(sv + 16 * c, gv + 16 * c);
      }
      if constexpr (kQuant) {
        // the page's scale rows: the same physical block, the same group
        const size_t row = (size_t)table[page] * BS;
        for (int j = threadIdx.x; j < BS; j += blockDim.x) {
          cp_async4(skbuf + slot * BS + j, scale_k + row + j);
          cp_async4(svbuf + slot * BS + j, scale_v + row + j);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s, s);

  for (int idx = threadIdx.x; idx < (g_end - g0) * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    qs[idx] = to_f32(q[(((size_t)b * G + g0 + r) * H + h) * D + d]);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int page = 0; page <= last; ++page) {
    // refill the slot the previous iteration consumed, then wait for this page
    issue(page + kStages - 1, (page + kStages - 1) % kStages);
    cp_async_wait_page();
    __syncthreads();
    const TKV* ks = kbuf + (page % kStages) * page_elems;
    const TKV* vs = vbuf + (page % kStages) * page_elems;
    const float* sks = skbuf + (page % kStages) * BS;  // read only when kQuant
    const float* svs = svbuf + (page % kStages) * BS;

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = g0 + warp * rows_per_warp + r;
      if (r >= rows_per_warp || g >= g_end) continue;  // uniform across the warp
      const float* qr = qs + (g - g0) * D;
      const int row_pos = pos0 + g;

      float m_new = m[r];
      for (int j0 = 0; j0 < BS; j0 += 32) {
        const int j = j0 + lane;
        float s = -INFINITY;
        if (j < BS) {
          const TKV* kj = ks + j * D;
          float dot = 0.f;
          int d = (j * kRot) % D;  // rotated start: neighbouring lanes read different banks
          for (int t = 0; t < D; ++t) {
            dot = fmaf(qr[d], to_f32(kj[d]), dot);
            d = (d + 1 == D) ? 0 : d + 1;
          }
          if constexpr (kQuant) dot *= sks[j];  // the key's scale, folded in
          s = (page * BS + j <= row_pos) ? dot * scale : -FLT_MAX;
          pw[j] = s;
        }
        m_new = fmaxf(m_new, warp_max(s));
      }
      __syncwarp();
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
      for (int j = lane; j < BS; j += 32) {
        const float p = expf(pw[j] - m_new);
        pw[j] = kQuant ? p * svs[j] : p;  // V's scale folded into its weight
        psum += p;
      }
      psum = warp_sum(psum);
      __syncwarp();
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          float a = acc[r][i] * alpha;
          for (int j = 0; j < BS; ++j) a = fmaf(pw[j], to_f32(vs[j * D + d]), a);
          acc[r][i] = a;
        }
      }
      __syncwarp();  // pw is reused by the warp's next row
    }
    __syncthreads();  // the slot is consumed before the next iteration refills it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = g0 + warp * rows_per_warp + r;
    if (r >= rows_per_warp || g >= g_end) continue;
    TQ* o = out + (((size_t)b * G + g) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store(o + d, acc[r][i] / l[r]);
    }
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* scale_k,
                   const void* scale_v, const void* positions, const void* block_tables,
                   void* out, int B, int G, int H, int D, int BS, int MB, float scale,
                   cudaStream_t stream) {
  const int rpw_need = (G + kWarps - 1) / kWarps;
  const int rows_per_warp = rpw_need < kRowsPerWarp ? rpw_need : kRowsPerWarp;
  const int rows_per_block = kWarps * rows_per_warp;
  // a ring of kStages K and V pages (with their scale rows when quantized),
  // the block's float32 query rows and one float32 score row per warp; past
  // the card's limit the attribute call below fails and its error goes back
  // to the caller
  const size_t scale_rows = is_quantized<TKV>() ? 2 * kStages * (size_t)BS : 0;
  const size_t smem = sizeof(TKV) * 2 * kStages * (size_t)BS * D +
                      sizeof(float) * (scale_rows + (size_t)rows_per_block * D +
                                       (size_t)kWarps * BS);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch's check would return it
      return err;
    }
  }
  dim3 grid(B, H, (G + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), static_cast<const float*>(scale_k),
      static_cast<const float*>(scale_v), static_cast<const int*>(positions),
      static_cast<const int*>(block_tables), static_cast<TQ*>(out), G, H, D, BS, MB,
      rows_per_warp, scale);
  return cudaGetLastError();
}

}  // namespace

// Pool formats: 0 float32, 1 bfloat16, 2 int8, 3 float8 e4m3 (the last two
// with their scale rows, null otherwise).  q is float32 or bfloat16 over any
// of them, except a bfloat16 q over a float32 pool, which the wrapper
// refuses as well.
extern "C" int ff_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                                  const void* scale_k, const void* scale_v,
                                  const void* positions, const void* block_tables, void* out,
                                  int B, int G, int H, int D, int BS, int MB, float scale,
                                  int q_bf16, int kv_format, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = kv_format == 2 || kv_format == 3;
  if (kv_format < 0 || kv_format > 3 || (q_bf16 && kv_format == 0) ||
      quant != (scale_k != nullptr && scale_v != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define FF_LAUNCH(TQ, TKV)                                                                  \
  launch<TQ, TKV>(q, pool_k, pool_v, scale_k, scale_v, positions, block_tables, out, B, G, H, \
                  D, BS, MB, scale, s)
  cudaError_t err;
  if (q_bf16) {
    switch (kv_format) {
      case 1: err = FF_LAUNCH(__nv_bfloat16, __nv_bfloat16); break;
      case 2: err = FF_LAUNCH(__nv_bfloat16, int8_t); break;
      default: err = FF_LAUNCH(__nv_bfloat16, __nv_fp8_e4m3); break;
    }
  } else {
    switch (kv_format) {
      case 0: err = FF_LAUNCH(float, float); break;
      case 1: err = FF_LAUNCH(float, __nv_bfloat16); break;
      case 2: err = FF_LAUNCH(float, int8_t); break;
      default: err = FF_LAUNCH(float, __nv_fp8_e4m3); break;
    }
  }
#undef FF_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
