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
// What bounds it on the card.  The least work is the K/V of the visible
// positions (1 or 2-4 bytes an element) and 4*D flops per visible (row, key)
// pair: a decode step (G = 1) is bound by bytes, and so is a prefill chunk
// (G = 32) with its products on the tensor cores (at the serve shapes a
// float32 pool's chunk moves 25 MB, 0.0080 ms at 3.35 TB/s, against 0.39
// GFLOP, 0.0024 ms at 3xTF32's rate; an int8 pool's 6.3 MB, 0.0019 ms).
// None of the paths comes near that: they are bound by latency (the chain
// position -> block table -> page -> merge) and by how many blocks and bytes
// are in flight, and the single pass by a dependent chain of shared-memory
// reads per element as well.
//
// Three paths, chosen by the wrapper (ops/cuda/paged_attention.py route):
//
// * Decode, split over pages (every pool format at G = 1, D 64 or 128, any
//   BS): a block scores its split's keys straight from the pool in
//   registers, the lanes of a group of 4-16 sharing a key, and the last
//   split of a lane to finish merges them all; see the section "Decode path
//   at G = 1" below.  Measured at the serve shapes on an H100 80GB HBM3 at
//   700 W (tools/torch_paged_decode_sweep.py, chip_smoke.py; device time,
//   q float32): see PERF.md section 6.
// * Row groups, split over pages (every pool format at G >= SPLIT_MIN_ROWS
//   = 2, D 64, BS dividing 64: the prefill chunk at G 32 and the speculative
//   verify at G 4): the lane's rows score 64-key tiles on the tensor cores,
//   and the lane's pages are split over several blocks whose partials a
//   combine pass merges (flash-decoding), so that the grid fills the card;
//   see the section "Row-group path at G >= SPLIT_MIN_ROWS" below.  int8,
//   e4m3 and bfloat16 pages run bfloat16 products; float32 pages run 3xTF32
//   products.  Measured at the serve shapes on an H100 80GB HBM3 at 700 W
//   (tools/torch_kernel_designs.py, device time, q float32), G 32 / G 4
//   against the single pass: float32 pools 0.033 / 0.039 ms against 0.34 /
//   0.079, bfloat16 pools 0.032 / 0.028 against 0.37 / 0.085, int8 pools
//   0.028 / 0.027 against 0.48 / 0.12; kSplitTiles = 2 tiles per split
//   (over int8 pools 1 and 4 were slower).
// * Single pass (every pool format at any G that neither split path takes:
//   a head dim they do not take, or G >= 2 with a BS that does not divide
//   64): grid (B, H, ceil(G / ROWS)), one block of four
//   warps per (lane, head, row group), looping over the lane's pages 0..last
//   in order.  Each warp carries up to kRowsPerWarp query rows with a
//   float32 online softmax (running max m, running sum l, accumulator acc in
//   registers).  Pages stream through a ring of kStages shared-memory slots
//   filled with cp.async.  Lane j scores key j of the page with a mul+sum over
//   D (walked in a per-lane rotated order so the lanes hit different banks),
//   times scale, masked to -FLT_MAX where k_pos > row_pos; the warp then
//   folds the page into its rows' carries.  Each block reads only the pages
//   its rows can see (last = the page of its last row, clamped to the table),
//   once each, straight from the pool through the block table; no dense
//   (B, H, SV, D) gather exists, and block 0 (the trash block idle lanes map)
//   contributes only through positions the mask admits.  It was the decode
//   step's path before the decode path (0.078 ms over float32 pools, 0.12
//   over int8, at the serve shapes).
//
// Either way a wrapper call is one launch in the wrapper's counts (LAUNCHES,
// LAUNCHES_BY_POOL, and LAUNCHES_BY_ROUTE under "single", "split" or
// "decode"): the row-group path's split and combine kernels are one call, so
// a serve run's count stays 12 x (steps + prefill dispatches).

// Quantized pools (TKV int8_t or __nv_fp8_e4m3): a page's two scale rows
// ride the page's copies, fetched through the same block-table entry with
// 4-byte cp.async copies (any BS; the decode path loads a key's two scales
// beside its 16-byte pieces).  Each stored element widens exactly (to
// float32 in the single pass and the decode path, to bfloat16 in the
// row-group path: an int8 or e4m3 value is a bfloat16 value), and the
// scales are folded in rather than
// multiplied into every element: the score is s_k = (q . Kq[k]) * sk[k] *
// scale, and the probability that weights Vq[k] is p_k * sv[k] (the running
// sum l takes p_k itself).  That is the JAX kernel's function (dequantize,
// then the same mul+sum) with one multiply per key instead of one per
// element; the results differ from the plain version by float32 rounding.

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
#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// Row-group path at G >= SPLIT_MIN_ROWS (the wrapper's threshold): key
// tiles on the tensor cores, split over pages.  (The header note above
// describes the single pass; this section is the row-group path, for every
// pool format.)
//
// Grid (B, H, row groups x splits); a block owns up to 64 rows of one lane
// and head (one warp per 16 rows) and the key tiles [split x kSplitTiles,
// (split + 1) x kSplitTiles) of the lane, a tile being 64 keys = 64 / BS
// pages gathered through the block table.  The entry point computes the
// number of splits from kTileKeys and kSplitTiles, so the wrapper holds no
// copy of either that could disagree with the kernel; it only passes the
// size of the workspace it allocated, which the entry point checks.  A
// split that starts past the block's last visible page returns at once; the
// combine kernel knows it from the positions.  Keys of a tile past the
// block's last visible page are never read: they enter shared memory as 0.
//
// int8, e4m3 and bfloat16 pools (paged_split_kernel).  Per tile: the raw K
// and V pages (1 or 2 bytes an element) and, for the 1-byte pools, their
// scale rows go into a ring of two stages with cp.async (the next tile
// loads while this one is computed); the block then brings the stage to
// bfloat16 in shared memory, K as [key][D] and V transposed as [d][key]: a
// 1-byte element widens exactly (an int8 or e4m3 value is a bfloat16
// value), a bfloat16 element is copied.  Each warp then scores its 16 rows
// against the 64 keys with mma.sync m16n8k16 (bfloat16 in, float32
// accumulate): a float32 q is split into three bfloat16 parts whose sum is
// q exactly, so the three products accumulate the float32 dot product up
// to float32 rounding; a bfloat16 q is one part.  The score is (q . K) * sk
// * scale (no sk over a bfloat16 pool), masked to -FLT_MAX past the row (on
// tiles that cross a row's position only), with a base-2 online softmax
// over the split's tiles.  The weight of V[k] is w = p * sv[k] (p over a
// bfloat16 pool) in float32, split into three bfloat16 parts the same way,
// and P.V is three more products.
//
// float32 pools (paged_split_tf32_kernel, float32 q only).  A float32 page
// is no bfloat16 value, so every product is 3xTF32, as in the float32
// flash backward (csrc/flash_attention.cu; the helpers below are copies of
// its tf_swz, split_tf32, mma_tf32, mma_3xtf32, tf_mma_nt and tf_mma_nn,
// since a library is built from, and hashed over, its one source): each
// operand x is split as its fragment loads into hi = x rounded to TF32 and
// lo = x - hi, and a . b is lo_a . hi_b + hi_a . lo_b + hi_a . hi_b on
// mma.sync.m16n8k8.tf32 with float32 accumulation.  The block's q rows and
// each tile's K and V stay float32 in shared memory, rows of D floats whose
// 16-byte pieces are permuted by tf_swz(row), which serves both the
// 16-byte row loads of S = q . K^T and the 4-byte column loads of P . V
// without bank conflicts; the tiles come through the same two-stage
// cp.async ring.  The softmax is the other kernel's.  The tensor core
// rounds each mma's sum mostly toward zero (tools/torch_tf32_probe.py), but
// a split accumulates at most kSplitTiles x 64 keys before the combine's
// FMAs take over: at the serve shapes the results land within 1.8e-6 of the
// plain version (chip_smoke.py; its float32 gate is 2e-5).
//
// Either kernel writes the split's (m, l, acc) to a float32 workspace; the
// combine kernel merges the live splits of every row in float32 FMAs:
// M = max m_s, L = sum l_s 2^(m_s - M), out = sum acc_s 2^(m_s - M) / L.
constexpr int kTileKeys = 64;   // keys per tile
constexpr int kSplitTiles = 2;  // tiles per split (1 and 4 measured slower)
constexpr int kGroupRows = 64;  // rows per block: 4 warps x 16
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the low byte of v as a stored int8 or e4m3 element, widened exactly
template <typename TKV>
__device__ __forceinline__ float byte_to_f32(uint32_t v);
template <>
__device__ __forceinline__ float byte_to_f32<int8_t>(uint32_t v) {
  return static_cast<float>(static_cast<int8_t>(v & 0xffu));
}
template <>
__device__ __forceinline__ float byte_to_f32<__nv_fp8_e4m3>(uint32_t v) {
  return __half2float(
      __half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v & 0xffu), __NV_E4M3)));
}

// x as P bfloat16 parts (hi, mid, lo) whose sum is x (exactly for P = 3)
template <int P>
__device__ __forceinline__ void split_bf16(float x, bf16 (&part)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    part[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(part[i]);
  }
}
// the parts of two floats, packed pairwise (low half = lo)
template <int P>
__device__ __forceinline__ void split_pair(float lo, float hi, uint32_t (&out)[P]) {
  bf16 a[P], b[P];
  split_bf16<P>(lo, a);
  split_bf16<P>(hi, b);
#pragma unroll
  for (int i = 0; i < P; ++i) out[i] = pack_bf16(a[i], b[i]);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment (k = kc .. kc+15, n = n0 .. n0+7) for B[k][n] = m[n][k], m
// row-major bfloat16 with row stride ld
__device__ __forceinline__ void load_b_t(uint32_t& b0, uint32_t& b1, const bf16* m, int ld,
                                         int n0, int kc) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bf16* r = m + (n0 + g) * ld + kc + 2 * t;
  b0 = ld32(r);
  b1 = ld32(r + 8);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// shared memory of one paged_split_kernel block: the raw ring (with the
// scale rows of a 1-byte pool), then the bfloat16 tile
template <typename TKV, int D>
constexpr size_t split_smem_bytes() {
  constexpr size_t scales = is_quantized<TKV>() ? 2 * sizeof(float) * kTileKeys : 0;
  return 2 * (2 * sizeof(TKV) * (size_t)kTileKeys * D + scales) +
         sizeof(bf16) * ((size_t)kTileKeys * (D + 8) + (size_t)D * (kTileKeys + 8));
}

// The last page the rows [g0, g0 + rows) of a lane at pos0 can see; the
// splits that hold pages 0 .. last, of pps pages each, are last / pps + 1.
__device__ __forceinline__ int group_last_page(int pos0, int g_end, int BS, int MB) {
  return min((pos0 + g_end - 1) / BS, MB - 1);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(128)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                   const TKV* __restrict__ pool_v, const float* __restrict__ scale_k,
                   const float* __restrict__ scale_v, const int* __restrict__ positions,
                   const int* __restrict__ block_tables, float* __restrict__ part, int G, int H,
                   int BS, int MB, int splits, float scale_log2) {
  constexpr bool kQuant = is_quantized<TKV>();  // else a bfloat16 pool
  constexpr int QP = sizeof(TQ) == 4 ? 3 : 1;  // bfloat16 parts of q
  constexpr int KD = D / 16, ND = D / 8, NK = kTileKeys / 8;
  constexpr int LDK = D + 8, LDV = kTileKeys + 8;  // padded rows: no bank conflicts
  constexpr int kRawBytes = kTileKeys * D * (int)sizeof(TKV);  // one raw K (or V) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw = smem_raw;  // [2 stages][K tile | V tile]
  // [2][sk 64 | sv 64], 1-byte pools only
  float* raw_sc = reinterpret_cast<float*>(raw + 2 * 2 * kRawBytes);
  bf16* kb = reinterpret_cast<bf16*>(raw_sc + (kQuant ? 2 * 2 * kTileKeys : 0));  // [64][LDK]
  bf16* vt = kb + kTileKeys * LDK;                                                 // [D][LDV]
  __shared__ float sks[kTileKeys], svs[kTileKeys];

  const int b = blockIdx.x, h = blockIdx.y;
  const int rg = blockIdx.z / splits, split = blockIdx.z % splits;
  const int g0 = rg * kGroupRows;
  const int g_end = min(G, g0 + kGroupRows);
  const int pos0 = positions[b];
  const int last = group_last_page(pos0, g_end, BS, MB);
  const int tp = kTileKeys / BS;
  const int tile0 = split * kSplitTiles;
  const int tile_end = min(tile0 + kSplitTiles, last / tp + 1);
  if (tile0 >= tile_end) return;  // nothing here is visible to the block's rows
  const int* table = block_tables + (size_t)b * MB;
  const int nthr = blockDim.x;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int page_bytes = BS * D * (int)sizeof(TKV);
  const int key_end = (last + 1) * BS;  // keys at or past this are in no visible page

  auto issue = [&](int tile, int st) {
    if (tile < tile_end) {
      unsigned char* rk = raw + st * 2 * kRawBytes;
      unsigned char* rv = rk + kRawBytes;
      float* rs = raw_sc + st * 2 * kTileKeys;
      const int chunks = page_bytes / 16;
      for (int c = threadIdx.x; c < tp * chunks; c += nthr) {
        const int i = c / chunks, page = tile * tp + i;
        if (page <= last) {
          const size_t base = ((size_t)table[page] * H + h) * page_bytes + 16 * (c % chunks);
          cp_async16(rk + i * page_bytes + 16 * (c % chunks),
                     reinterpret_cast<const unsigned char*>(pool_k) + base);
          cp_async16(rv + i * page_bytes + 16 * (c % chunks),
                     reinterpret_cast<const unsigned char*>(pool_v) + base);
        }
      }
      if constexpr (kQuant) {
        for (int j = threadIdx.x; j < kTileKeys; j += nthr) {
          const int page = tile * tp + j / BS;
          if (page <= last) {
            const size_t row = (size_t)table[page] * BS + j % BS;
            cp_async4(rs + j, scale_k + row);
            cp_async4(rs + kTileKeys + j, scale_v + row);
          }
        }
      }
    }
    cp_async_commit();
  };
  issue(tile0, 0);

  // this thread's rows, and its A fragments of q split into QP parts
  const int r0 = g0 + warp * 16 + g, r1 = r0 + 8;
  const bool warp_live = g0 + warp * 16 < g_end;
  uint32_t qa[QP][KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0;
      const int col = 16 * kk + 2 * t + ((e & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (row < g_end) {
        const TQ* qr = q + (((size_t)b * G + row) * H + h) * D + col;
        x0 = to_f32(qr[0]);
        x1 = to_f32(qr[1]);
      }
      uint32_t pr[QP];
      split_pair<QP>(x0, x1, pr);
#pragma unroll
      for (int i = 0; i < QP; ++i) qa[i][kk][e] = pr[i];
    }

  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int st = (tile - tile0) & 1;
    issue(tile + 1, st ^ 1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    // widen (1-byte pools) or copy (bfloat16 pools) the stage into kb / vt;
    // keys of pages past `last` read as 0
    const unsigned char* rk = raw + st * 2 * kRawBytes;
    const int live_keys = min(kTileKeys, key_end - tile * kTileKeys);
    for (int c = threadIdx.x; c < kTileKeys * (D / 8); c += nthr) {
      const int key = c % kTileKeys, d0 = 8 * (c / kTileKeys);
      if constexpr (!kQuant) {
        uint4 k8 = make_uint4(0u, 0u, 0u, 0u), v8 = make_uint4(0u, 0u, 0u, 0u);
        if (key < live_keys) {
          const bf16* sk = reinterpret_cast<const bf16*>(rk) + key * D + d0;
          k8 = *reinterpret_cast<const uint4*>(sk);
          v8 = *reinterpret_cast<const uint4*>(sk + kTileKeys * D);
        }
        *reinterpret_cast<uint4*>(kb + key * LDK + d0) = k8;
        const bf16* v = reinterpret_cast<const bf16*>(&v8);
#pragma unroll
        for (int i = 0; i < 8; ++i) vt[(d0 + i) * LDV + key] = v[i];
      } else {
        uint2 k8 = make_uint2(0u, 0u), v8 = make_uint2(0u, 0u);
        if (key < live_keys) {
          k8 = *reinterpret_cast<const uint2*>(rk + key * D + d0);
          v8 = *reinterpret_cast<const uint2*>(rk + kRawBytes + key * D + d0);
        }
        uint32_t kw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t kx = i < 2 ? k8.x : k8.y, vx = i < 2 ? v8.x : v8.y;
          const int sh = 16 * (i & 1);
          kw[i] = pack_bf16(__float2bfloat16_rn(byte_to_f32<TKV>(kx >> sh)),
                            __float2bfloat16_rn(byte_to_f32<TKV>(kx >> (sh + 8))));
          vt[(d0 + 2 * i) * LDV + key] = __float2bfloat16_rn(byte_to_f32<TKV>(vx >> sh));
          vt[(d0 + 2 * i + 1) * LDV + key] = __float2bfloat16_rn(byte_to_f32<TKV>(vx >> (sh + 8)));
        }
        *reinterpret_cast<uint4*>(kb + key * LDK + d0) = make_uint4(kw[0], kw[1], kw[2], kw[3]);
      }
    }
    if constexpr (kQuant) {
      for (int j = threadIdx.x; j < kTileKeys; j += nthr) {
        const bool live = j < live_keys;
        sks[j] = live ? raw_sc[st * 2 * kTileKeys + j] : 0.f;
        svs[j] = live ? raw_sc[st * 2 * kTileKeys + kTileKeys + j] : 0.f;
      }
    }
    __syncthreads();

    if (warp_live) {
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t b0, b1;
          load_b_t(b0, b1, kb, LDK, 8 * j, 16 * kk);
#pragma unroll
          for (int i = 0; i < QP; ++i) mma16816(s[j], qa[i][kk], b0, b1);
        }
      }
      const int key0 = tile * kTileKeys;
      // every key of the tile visible to every row of the warp: no mask
      const bool full = key0 + kTileKeys <= min(key_end, pos0 + g0 + warp * 16 + 1);
      const int rpos[2] = {pos0 + r0, pos0 + r1};
      float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          const bool vis = full || (key0 + kj <= rpos[e / 2] && key0 + kj < key_end);
          const float sc = kQuant ? sks[kj] * scale_log2 : scale_log2;
          s[j][e] = vis ? s[j][e] * sc : -FLT_MAX;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2f(m[r] - m_new[r]);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int kj = 8 * j + 2 * t + (e & 1);
          const float p = s[j][e] == -FLT_MAX ? 0.f : exp2f(s[j][e] - m_new[r]);
          psum[r] += p;
          s[j][e] = kQuant ? p * svs[kj] : p;  // V's scale folded into its weight
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
        m[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk) {
        uint32_t a[3][4], pr[3];
        split_pair<3>(s[2 * kk][0], s[2 * kk][1], pr);
#pragma unroll
        for (int i = 0; i < 3; ++i) a[i][0] = pr[i];
        split_pair<3>(s[2 * kk][2], s[2 * kk][3], pr);
#pragma unroll
        for (int i = 0; i < 3; ++i) a[i][1] = pr[i];
        split_pair<3>(s[2 * kk + 1][0], s[2 * kk + 1][1], pr);
#pragma unroll
        for (int i = 0; i < 3; ++i) a[i][2] = pr[i];
        split_pair<3>(s[2 * kk + 1][2], s[2 * kk + 1][3], pr);
#pragma unroll
        for (int i = 0; i < 3; ++i) a[i][3] = pr[i];
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          load_b_t(b0, b1, vt, LDV, 8 * n, 16 * kk);
#pragma unroll
          for (int i = 0; i < 3; ++i) mma16816(o[n], a[i], b0, b1);
        }
      }
    }
    __syncthreads();  // kb / vt and the stage are consumed before they are refilled
  }

  // the split's partials: acc [B][H][splits][G][D], then (m, l) [B][H][splits][G][2]
  if (!warp_live) return;
  const size_t lane_split = ((size_t)b * H + h) * splits + split;
  float* acc = part + lane_split * G * D;
  float* ml = part + (size_t)gridDim.x * H * splits * G * D + lane_split * G * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= g_end) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(acc + (size_t)row * D + 8 * n + 2 * t) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
    if (t == 0) *reinterpret_cast<float2*>(ml + 2 * row) = make_float2(m[r], l[r]);
  }
}

// --- 3xTF32 helpers, copied from csrc/flash_attention.cu ---------------------

// the permutation of row r's 16-byte pieces (within each 128 bytes)
__device__ __forceinline__ int tf_swz(int r) { return (r & 6) ^ ((r & 1) << 2); }

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
// layout, T the tile's first 8 NB rows (8 NB x D).  k-step j holds rows
// 8j .. 8j + 7, column t of A (row t of B) row 8j + 2t and column t + 4 row
// 8j + 2t + 1, which is where the accumulator has them.
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

// shared memory of one paged_split_tf32_kernel block of `warps` warps: the
// ring of two stages of a K and a V tile, then the block's q rows
template <int D>
constexpr size_t split_tf32_smem_bytes(int warps) {
  return sizeof(float) * (2 * 2 * (size_t)kTileKeys * D + 16 * (size_t)warps * D);
}

// The row-group path over float32 pools (see the section note above); the
// signature is paged_split_kernel's, the scale rows unused.
template <int D>
__global__ void __launch_bounds__(128)
paged_split_tf32_kernel(const float* __restrict__ q, const float* __restrict__ pool_k,
                        const float* __restrict__ pool_v, const float* __restrict__,
                        const float* __restrict__, const int* __restrict__ positions,
                        const int* __restrict__ block_tables, float* __restrict__ part, int G,
                        int H, int BS, int MB, int splits, float scale_log2) {
  constexpr int NK = kTileKeys / 8, kChunks = D / 4;  // 16-byte pieces a row
  constexpr int kTileF = kTileKeys * D;                // floats of one K (or V) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [2 stages][K tile | V tile]
  float* qs = ring + 2 * 2 * kTileF;                 // [16 x warps][D]

  const int b = blockIdx.x, h = blockIdx.y;
  const int rg = blockIdx.z / splits, split = blockIdx.z % splits;
  const int g0 = rg * kGroupRows;
  const int g_end = min(G, g0 + kGroupRows);
  const int pos0 = positions[b];
  const int last = group_last_page(pos0, g_end, BS, MB);
  const int tp = kTileKeys / BS;
  const int tile0 = split * kSplitTiles;
  const int tile_end = min(tile0 + kSplitTiles, last / tp + 1);
  if (tile0 >= tile_end) return;  // nothing here is visible to the block's rows
  const int* table = block_tables + (size_t)b * MB;
  const int nthr = blockDim.x;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int key_end = (last + 1) * BS;  // keys at or past this are in no visible page
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // the block's q rows (0 past g_end); they ride the first tile's group
  for (int c = threadIdx.x; c < 16 * (nthr / 32) * kChunks; c += nthr) {
    const int r = c / kChunks, piece = c % kChunks;
    float* dst = qs + r * D + ((piece ^ tf_swz(r)) << 2);
    if (g0 + r < g_end)
      cp_async16(dst, q + (((size_t)b * G + g0 + r) * H + h) * D + 4 * piece);
    else
      *reinterpret_cast<float4*>(dst) = zero;
  }
  // tile `tile` into stage st, key r of the tile at row r; keys of pages
  // past `last` are zeros, never read from the pool
  auto issue = [&](int tile, int st) {
    if (tile < tile_end) {
      float* ks = ring + st * 2 * kTileF;
      float* vs = ks + kTileF;
      for (int c = threadIdx.x; c < kTileKeys * kChunks; c += nthr) {
        const int r = c / kChunks, piece = c % kChunks;
        const int dst = r * D + ((piece ^ tf_swz(r)) << 2);
        const int page = tile * tp + r / BS;
        if (page <= last) {
          const size_t src = (((size_t)table[page] * H + h) * BS + r % BS) * D + 4 * piece;
          cp_async16(ks + dst, pool_k + src);
          cp_async16(vs + dst, pool_v + src);
        } else {
          *reinterpret_cast<float4*>(ks + dst) = zero;
          *reinterpret_cast<float4*>(vs + dst) = zero;
        }
      }
    }
    cp_async_commit();
  };
  issue(tile0, 0);

  const int r0 = g0 + warp * 16 + g, r1 = r0 + 8;
  const bool warp_live = g0 + warp * 16 < g_end;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int st = (tile - tile0) & 1;
    issue(tile + 1, st ^ 1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    if (warp_live) {
      const float* ks = ring + st * 2 * kTileF;
      float s[NK * 4];
      tf_mma_nt<D, NK>(s, qs, 16 * warp, ks);  // S = q . K^T
      const int key0 = tile * kTileKeys;
      // every key of the tile visible to every row of the warp: no mask
      const bool full = key0 + kTileKeys <= min(key_end, pos0 + g0 + warp * 16 + 1);
      const int rpos[2] = {pos0 + r0, pos0 + r1};
      float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          const bool vis = full || (key0 + kj <= rpos[e / 2] && key0 + kj < key_end);
          s[4 * j + e] = vis ? s[4 * j + e] * scale_log2 : -FLT_MAX;
          mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
        }
      float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2f(m[r] - m_new[r]);
      }
#pragma unroll
      for (int i = 0; i < NK * 4; ++i) {
        const int r = (i % 4) / 2;
        s[i] = s[i] == -FLT_MAX ? 0.f : exp2f(s[i] - m_new[r]);
        psum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
        m[r] = m_new[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i % 4) / 2];
      tf_mma_nn<D, NK>(o, s, ks + kTileF);  // o += P . V
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // the split's partials, laid out as paged_split_kernel's
  if (!warp_live) return;
  const size_t lane_split = ((size_t)b * H + h) * splits + split;
  float* acc = part + lane_split * G * D;
  float* ml = part + (size_t)gridDim.x * H * splits * G * D + lane_split * G * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= g_end) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc + (size_t)row * D + 8 * n + 2 * t) =
          make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
    if (t == 0) *reinterpret_cast<float2*>(ml + 2 * row) = make_float2(m[r], l[r]);
  }
}

// Merge the live splits (of `pps` pages each) of row `row`, column d of lane
// b, head h in float32 FMAs: M = max m_s over the splits with l_s > 0,
// out = sum acc_s 2^(m_s - M) / sum l_s 2^(m_s - M).  The row-group path's
// combine kernel and the decode kernel's last block of a (lane, head) run this
// one body.  Its loads go through L2 only (the decode kernel reads partials
// that other blocks of the same launch wrote) and are unrolled, so that a
// thread's loads are in flight together.
template <typename TQ>
__device__ __forceinline__ void combine_splits(const float* part, const int* __restrict__ positions,
                                               TQ* __restrict__ out, int b, int h, int row, int d,
                                               int B, int G, int H, int D, int BS, int MB,
                                               int splits, int pps) {
  const int g_end = min(G, (row / kGroupRows + 1) * kGroupRows);
  const int last = group_last_page(positions[b], g_end, BS, MB);
  const int n = last / pps + 1;
  const size_t lane = ((size_t)b * H + h) * splits;
  const float* acc = part + lane * G * D + (size_t)row * D + d;
  const float* ml = part + (size_t)B * H * splits * G * D + lane * G * 2 + 2 * row;
  float mx = -FLT_MAX;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(ml + (size_t)s * G * 2));
    if (v.y > 0.f) mx = fmaxf(mx, v.x);
  }
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(ml + (size_t)s * G * 2));
    const float a = __ldcg(acc + (size_t)s * G * D);  // a split of this row's is written
    if (v.y > 0.f) {
      const float w = exp2f(v.x - mx);
      den += v.y * w;
      num += a * w;
    }
  }
  store(out + (((size_t)b * G + row) * H + h) * D + d, num / den);
}

// the row-group path's combine: one thread per output element
template <typename TQ>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const float* __restrict__ part, const int* __restrict__ positions,
                     TQ* __restrict__ out, int G, int H, int D, int BS, int MB, int splits,
                     int pps) {
  const int idx = blockIdx.z * blockDim.x + threadIdx.x;
  if (idx >= G * D) return;
  combine_splits<TQ>(part, positions, out, blockIdx.x, blockIdx.y, idx / D, idx % D, gridDim.x,
                     G, H, D, BS, MB, splits, pps);
}

// ---------------------------------------------------------------------------
// Decode path at G = 1: one query row per lane, split over pages, no tensor
// cores.  (The header note above describes the single pass; this section is
// the decode path, for every pool format, at D 64 and 128 and any BS.)
//
// What bounds it.  A decode step reads every visible key and value of its
// lane once and does 4 x D flops a key: far below the card's balance point,
// so bytes bound it (at the serve shapes a float32 pool's step moves 25 MB,
// 7.5 us at 3.35 TB/s; an int8 pool's 6.3 MB).  The single pass gives each
// (lane, head) one block that walks all of the lane's pages in order, three
// of its four warps idle at G = 1, and scores a key as D dependent FMAs on
// shared-memory reads: a latency chain, with too few blocks and too few
// bytes in flight to come near the bound.
//
// The design.  Grid (B, H, splits): each block takes kDecodeKeys keys' worth
// of whole pages of one lane and head (decode_split_pages(BS) pages; a split
// that starts past the lane's last visible page returns at once), so that at
// the serve shapes (8 lanes x 12 heads, 512 positions, BS 16) 864 blocks
// share the card's 132 SMs.  A key's row of D elements is spread over a
// group of lanes that each load 16 bytes straight from the pool into
// registers (16 lanes a float32 key at D 64, 8 a bfloat16 key, 4 an int8 or
// e4m3 key), so one warp-wide load covers 32 / group keys; each lane issues
// the loads of all its keys of the split (K and V, up to 8 of each) before it
// uses any, which keeps 16-32 KB of loads in flight a block.  The group sums
// its dot products with shuffles, and each lane keeps the weighted sum of V
// for its own 16-byte slice of D over its group's keys.  A 1-byte element
// is widened 4 at a time (int8: __byte_perm into a float's mantissa, one
// FADD each; e4m3: paired f16x2 conversions), a bfloat16 element by a shift.
// The online softmax is base 2 in float32; the scales fold in as the other
// paths fold them (the score takes sk[k], the weight of Vq[k] is p * sv[k],
// l takes p).  Only visible keys are read: the split's keys stop at the
// lane's position, so no poisoned page and no key past it enters a sum.
// The four warps take interleaved keys and merge through shared memory at
// the end of the split; the split's (acc, m, l) go to the workspace laid out
// as the row-group path's at G = 1.  The last of a lane's live splits to
// finish (a per-(lane, head) count, bumped atomically after a fence) then
// merges them all with the row-group path's combine (combine_splits) and
// sets the count back to 0.  A second kernel, as the row-group path
// launches, took 4.7 us of device time at the serve shapes on an H100, and
// left out it saved 6-7 us a call (tools/torch_paged_decode_sweep.py).
constexpr int kDecodeWarps = 4;
constexpr int kDecodeKeys = 64;  // keys a split aims at, in whole pages
// 16-byte loads of K (and of V) a lane issues before it uses them, and the
// blocks an SM should hold at D 64 (__launch_bounds__; half as many at D
// 128): at most 64 registers a thread, so that the serve shapes' 864 blocks
// run in one wave (8 an SM, not 4-6 at 77-106 registers).  On an H100 that
// was faster over every pool format than 8 loads without the cap
// (tools/torch_paged_decode_sweep.py).
constexpr int kDecodeLoads = 4;
constexpr int kDecodeMinBlocks = 8;

// pages a decode split holds at page size BS
__host__ __device__ constexpr int decode_split_pages(int BS) {
  return BS >= kDecodeKeys ? 1 : kDecodeKeys / BS;
}

// the 16 bytes r as E = 16 / sizeof(TKV) stored elements, widened exactly to float32
template <typename TKV>
__device__ __forceinline__ void widen16(const uint4& r, float (&f)[16 / sizeof(TKV)]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (std::is_same<TKV, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (std::is_same<TKV, int8_t>::value) {
    // byte b of x = w ^ 0x80808080 is v + 128; 2^23 + (v + 128) - (2^23 + 128) = v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650u | j)) - 8388736.0f;
    }
  } else {  // e4m3: two at a time to f16x2 (exact), then to float32 (exact)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * j)), __NV_E4M3);
        const float2 x = __half22float2(__half2(h));
        f[4 * i + 2 * j] = x.x;
        f[4 * i + 2 * j + 1] = x.y;
      }
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(32 * kDecodeWarps,
                                  D == 64 ? kDecodeMinBlocks : kDecodeMinBlocks / 2)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                    const TKV* __restrict__ pool_v, const float* __restrict__ scale_k,
                    const float* __restrict__ scale_v, const int* __restrict__ positions,
                    const int* __restrict__ block_tables, float* part,
                    int* __restrict__ counts, TQ* __restrict__ out, int H, int BS, int MB,
                    int splits, int pps, float scale_log2) {
  constexpr bool kQuant = is_quantized<TKV>();
  constexpr int E = 16 / (int)sizeof(TKV);  // elements a 16-byte load holds
  constexpr int LK = D / E;                 // lanes a key
  constexpr int KPL = 32 / LK;              // keys a warp-wide load
  static_assert(LK >= 1 && LK <= 32 && (LK & (LK - 1)) == 0, "a key's lanes: a power of 2");
  // loads a lane issues before it uses them: a split's kDecodeKeys keys in
  // one batch where that takes at most kDecodeLoads of K (and of V)
  constexpr int NL = kDecodeKeys / kDecodeWarps / KPL > kDecodeLoads ? kDecodeLoads
                     : kDecodeKeys / kDecodeWarps / KPL < 1 ? 1
                     : kDecodeKeys / kDecodeWarps / KPL;
  __shared__ __align__(16) float merge_acc[kDecodeWarps][D];
  __shared__ float merge_ml[kDecodeWarps][2];
  __shared__ bool merges_lane;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int pos = positions[b];
  const int last = group_last_page(pos, 1, BS, MB);
  if (split * pps > last) return;  // nothing here is visible to the lane
  const int key0 = split * pps * BS;
  // the split's visible keys: its pages up to the lane's position
  const int key_end = min((split + 1) * pps * BS, min(pos + 1, MB * BS));
  const int* table = block_tables + (size_t)b * MB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kq = lane / LK, c = lane % LK;  // the key of the load, the lane's slice of D

  float qv[E];
  const TQ* qr = q + ((size_t)b * H + h) * D + c * E;
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = to_f32(qr[e]);

  float m = -FLT_MAX, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const int units = (key_end - key0 + KPL - 1) / KPL;  // warp-wide loads of the split
  for (int u0 = warp; u0 < units; u0 += kDecodeWarps * NL) {
    uint4 kr[NL], vr[NL];
    float ks[NL], vs[NL];  // the keys' scales (1-byte pools)
    bool live[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int key = key0 + (u0 + kDecodeWarps * i) * KPL + kq;
      live[i] = key < key_end;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      ks[i] = vs[i] = 0.f;
      if (live[i]) {
        const int page = key / BS, slot = key - page * BS;
        const int blk = table[page];
        const size_t at = (((size_t)blk * H + h) * BS + slot) * D + c * E;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(pool_k + at));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(pool_v + at));
        if constexpr (kQuant) {
          ks[i] = __ldg(scale_k + (size_t)blk * BS + slot);
          vs[i] = __ldg(scale_v + (size_t)blk * BS + slot);
        }
      }
    }
    float s[NL], mx = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float kf[E];
      widen16<TKV>(kr[i], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kf[e], dot);
#pragma unroll
      for (int o = LK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if constexpr (kQuant) dot *= ks[i];  // the key's scale, folded in
      s[i] = live[i] ? dot * scale_log2 : -FLT_MAX;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int o = LK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const float p = s[i] == -FLT_MAX ? 0.f : exp2f(s[i] - m_new);
      psum += p;
      const float w = kQuant ? p * vs[i] : p;  // V's scale folded into its weight
      float vf[E];
      widen16<TKV>(vr[i], vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
    }
    // the lanes of a key group hold one sum; add the groups'
#pragma unroll
    for (int o = LK; o < 32; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
  }
  // the warp's weighted sum of V: add the key groups' slices of D
#pragma unroll
  for (int o = LK; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < LK) {
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(&merge_acc[warp][c * E + e]) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  }
  if (lane == 0) {
    merge_ml[warp][0] = m;
    merge_ml[warp][1] = l;
  }
  __syncthreads();
  // merge the warps (a warp that saw no key has l = 0 and weight 0) and
  // write the split's partials, laid out as the row-group path's at G = 1
  float mw = -FLT_MAX;
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) mw = fmaxf(mw, merge_ml[w][0]);
  const size_t lane_split = ((size_t)b * H + h) * splits + split;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) num += merge_acc[w][d] * exp2f(merge_ml[w][0] - mw);
    part[lane_split * D + d] = num;
  }
  if (threadIdx.x == 0) {
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) den += merge_ml[w][1] * exp2f(merge_ml[w][0] - mw);
    float* ml = part + (size_t)gridDim.x * H * splits * D + lane_split * 2;
    *reinterpret_cast<float2*>(ml) = make_float2(mw, den);
  }
  // the last of the lane's live splits to finish merges them all; it sets
  // the (lane, head)'s count back to 0 for the next call
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  int* count = counts + (size_t)b * H + h;
  if (threadIdx.x == 0) merges_lane = atomicAdd(count, 1) == last / pps;
  __syncthreads();
  if (!merges_lane) return;
  __threadfence();  // every split's partials, as counted, before they are read
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    combine_splits<TQ>(part, positions, out, b, h, 0, d, gridDim.x, 1, H, D, BS, MB, splits, pps);
  if (threadIdx.x == 0) *count = 0;
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_split(const void* q, const void* pool_k, const void* pool_v,
                         const void* scale_k, const void* scale_v, const void* positions,
                         const void* block_tables, void* out, void* part, int B, int G, int H,
                         int BS, int MB, int splits, float scale, cudaStream_t stream) {
  const int groups = (G + kGroupRows - 1) / kGroupRows;
  const int warps = ((G < kGroupRows ? G : kGroupRows) + 15) / 16;
  auto run = [&](auto kernel, size_t smem) {
    if (smem > 48 * 1024) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
      }
    }
    kernel<<<dim3(B, H, groups * splits), 32 * warps, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
        static_cast<const TKV*>(pool_v), static_cast<const float*>(scale_k),
        static_cast<const float*>(scale_v), static_cast<const int*>(positions),
        static_cast<const int*>(block_tables), static_cast<float*>(part), G, H, BS, MB, splits,
        scale * kLog2e);
    return cudaGetLastError();
  };
  cudaError_t err;
  if constexpr (std::is_same<TKV, float>::value)
    err = run(paged_split_tf32_kernel<D>, split_tf32_smem_bytes<D>(warps));
  else
    err = run(paged_split_kernel<TQ, TKV, D>, split_smem_bytes<TKV, D>());
  if (err != cudaSuccess) return err;
  paged_combine_kernel<TQ><<<dim3(B, H, (G * D + 127) / 128), 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(positions),
      static_cast<TQ*>(out), G, H, D, BS, MB, splits, kSplitTiles * (kTileKeys / BS));
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_decode(const void* q, const void* pool_k, const void* pool_v,
                          const void* scale_k, const void* scale_v, const void* positions,
                          const void* block_tables, void* out, void* part, void* counts, int B,
                          int H, int BS, int MB, int splits, float scale, cudaStream_t stream) {
  paged_decode_kernel<TQ, TKV, D><<<dim3(B, H, splits), 32 * kDecodeWarps, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), static_cast<const float*>(scale_k),
      static_cast<const float*>(scale_v), static_cast<const int*>(positions),
      static_cast<const int*>(block_tables), static_cast<float*>(part), static_cast<int*>(counts),
      static_cast<TQ*>(out), H, BS, MB, splits, decode_split_pages(BS), scale * kLog2e);
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

// The row-group path (see its section above): every pool format, as
// ff_paged_attention takes them, at D 64 (at D 128 the float32-q
// instantiation of paged_split_kernel needs more than 255 registers) and a
// BS dividing 64.  `part` is a float32 workspace of `part_floats` values;
// the launch needs B x H x splits x G x (D + 2) of them, splits =
// ceil(MB / (kSplitTiles x kTileKeys / BS)), and refuses a smaller one.
extern "C" int ff_paged_attention_split(const void* q, const void* pool_k, const void* pool_v,
                                        const void* scale_k, const void* scale_v,
                                        const void* positions, const void* block_tables,
                                        void* out, void* part, long long part_floats, int B,
                                        int G, int H, int D, int BS, int MB, float scale,
                                        int q_bf16, int kv_format, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = kv_format == 2 || kv_format == 3;
  if (kv_format < 0 || kv_format > 3 || (q_bf16 && kv_format == 0) ||
      quant != (scale_k != nullptr && scale_v != nullptr) || D != 64 || BS < 1 ||
      kTileKeys % BS || MB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pages = kSplitTiles * (kTileKeys / BS);
  const int splits = (MB + pages - 1) / pages;
  if ((long long)B * H * splits * G * (D + 2) > part_floats)
    return static_cast<int>(cudaErrorInvalidValue);
#define FF_SPLIT(TQ, TKV)                                                                   \
  launch_split<TQ, TKV, 64>(q, pool_k, pool_v, scale_k, scale_v, positions, block_tables, out, \
                            part, B, G, H, BS, MB, splits, scale, s)
  cudaError_t err;
  if (q_bf16) {
    switch (kv_format) {
      case 1: err = FF_SPLIT(__nv_bfloat16, __nv_bfloat16); break;
      case 2: err = FF_SPLIT(__nv_bfloat16, int8_t); break;
      default: err = FF_SPLIT(__nv_bfloat16, __nv_fp8_e4m3); break;
    }
  } else {
    switch (kv_format) {
      case 0: err = FF_SPLIT(float, float); break;
      case 1: err = FF_SPLIT(float, __nv_bfloat16); break;
      case 2: err = FF_SPLIT(float, int8_t); break;
      default: err = FF_SPLIT(float, __nv_fp8_e4m3); break;
    }
  }
#undef FF_SPLIT
  return static_cast<int>(err);
}

// The decode path (see its section above): G = 1, every pool format, as
// ff_paged_attention takes them, at D 64 or 128 and any BS.  `part` is a
// float32 workspace of `part_floats` values; the launch needs B x H x splits
// x (D + 2) of them, splits = ceil(MB / decode_split_pages(BS)), and refuses
// a smaller one.  `counts` is B x H int32 counts, 0 before the launch and 0
// again after it (the kernel sets each back): calls that share it run one at
// a time, on one stream.
extern "C" int ff_paged_attention_decode(const void* q, const void* pool_k, const void* pool_v,
                                         const void* scale_k, const void* scale_v,
                                         const void* positions, const void* block_tables,
                                         void* out, void* part, long long part_floats,
                                         void* counts, int B, int H, int D, int BS, int MB,
                                         float scale, int q_bf16, int kv_format, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = kv_format == 2 || kv_format == 3;
  if (kv_format < 0 || kv_format > 3 || (q_bf16 && kv_format == 0) ||
      quant != (scale_k != nullptr && scale_v != nullptr) || (D != 64 && D != 128) || BS < 1 ||
      MB < 1 || counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pages = decode_split_pages(BS);
  const int splits = (MB + pages - 1) / pages;
  if ((long long)B * H * splits * (D + 2) > part_floats || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define FF_DECODE(TQ, TKV)                                                               \
  (D == 64 ? launch_decode<TQ, TKV, 64>(q, pool_k, pool_v, scale_k, scale_v, positions,    \
                                        block_tables, out, part, counts, B, H, BS, MB, \
                                        splits, scale, s)                               \
           : launch_decode<TQ, TKV, 128>(q, pool_k, pool_v, scale_k, scale_v, positions,   \
                                         block_tables, out, part, counts, B, H, BS, MB, \
                                         splits, scale, s))
  cudaError_t err;
  if (q_bf16) {
    switch (kv_format) {
      case 1: err = FF_DECODE(__nv_bfloat16, __nv_bfloat16); break;
      case 2: err = FF_DECODE(__nv_bfloat16, int8_t); break;
      default: err = FF_DECODE(__nv_bfloat16, __nv_fp8_e4m3); break;
    }
  } else {
    switch (kv_format) {
      case 0: err = FF_DECODE(float, float); break;
      case 1: err = FF_DECODE(float, __nv_bfloat16); break;
      case 2: err = FF_DECODE(float, int8_t); break;
      default: err = FF_DECODE(float, __nv_fp8_e4m3); break;
    }
  }
#undef FF_DECODE
  return static_cast<int>(err);
}
