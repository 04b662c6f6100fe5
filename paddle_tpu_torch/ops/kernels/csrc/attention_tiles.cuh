// Tiles of the bf16 tensor-core attention kernels (sm_90a): the flash
// forward and backward and the varlen forward and backward share them.
//
// A block is two warpgroups (256 threads). It keeps kRows rows of one
// operand resident in shared memory (64 a warpgroup) and streams kCols-row
// tiles of the other side through a ring of kStages stages filled by
// 16-byte cp.async. Every tile sits in the 128-byte swizzled layout that
// wgmma's descriptors name (common.cuh). Products: S = A B^T [64 x kCols]
// with both operands in shared memory (product_nt), and acc += X T with X
// from the registers of such an S and T streamed MN-major (product_acc).
// Accumulator layout of a warpgroup's 64 rows (common.cuh): lane 4g + t of
// warp w holds rows 16w + g and 16w + g + 8; element 4j + e is row
// 16w + g + 8 (e / 2), column 8j + 2t + e % 2.
#pragma once

#include <limits.h>

#include <initializer_list>

#include "common.cuh"

namespace pt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 2 warpgroups, 64 resident rows each
constexpr int kRows = 128;     // resident tile
constexpr int kCols = 64;      // streamed tile
constexpr int kStages = 2;     // ring of streamed tiles
constexpr int kAcc = kCols / 2;  // S accumulator floats a thread

// Element offset of (r, c) in a [ROWS][D] bf16 tile in the 128-byte
// swizzled layout (common.cuh): 64-column slabs of ROWS x 128 bytes.
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (ROWS * 64) + r * 64 + ((((c >> 3) ^ r) & 7) << 3) +
         (c & 7);
}

// ROWS x D rows of a contiguous [*, D] matrix into a swizzled tile by
// 16-byte cp.async, coalesced: thread i copies chunks i, i + 256, ...
template <int D, int ROWS>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* src) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    pt::cp_async16(dst + swz<ROWS>(r, c),
                   src + static_cast<int64_t>(r) * D + c);
  }
}

// As load_async, but rows at or past `rows` are filled with zeros (the
// ragged end of a matrix): nothing is read there.
template <int D, int ROWS>
__device__ __forceinline__ void load_async_upto(bf16* dst, const bf16* src,
                                                int rows) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool in = r < rows;
    pt::cp_async16_zfill(dst + swz<ROWS>(r, c),
                         src + (in ? static_cast<int64_t>(r) * D + c : 0),
                         in);
  }
}

// kCols floats by the kCols / 4 threads from t0, 16 bytes each.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int t0) {
  const int i = threadIdx.x - t0;
  if (i >= 0 && i < kCols / 4) pt::cp_async16(dst + 4 * i, src + 4 * i);
}

// kCols 4-byte values of a vector whose values end at n (n may be < 0)
// by the kCols threads from t0: in range by cp.async, past the end `fill`
// stored plainly (visible, as the copies, after the next barrier).
template <typename T>
__device__ __forceinline__ void load_col_async(T* dst, const T* src, int n,
                                               T fill, int t0) {
  static_assert(sizeof(T) == 4, "4-byte values");
  const int i = threadIdx.x - t0;
  if (i < 0 || i >= kCols) return;
  if (i < n)
    pt::cp_async4(dst + i, src + i);
  else
    dst[i] = fill;
}

// The varlen kernels' exact tile skip. A block keeps kRows rows of one
// side; the range [lo, hi] of their non-negative segment ids (lo > hi when
// there are none) bounds the ids a streamed tile of the other side must
// hold to have a valid pair with any of them.

// [lo, hi] of the non-negative ids among ids[0, min(n, kRows)), thread i
// reading id i; sRange is 8 ints of scratch. Ends with a barrier.
__device__ __forceinline__ void id_range(const int* ids, int n, int* sRange,
                                         int& lo, int& hi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int id = tid < kRows && tid < n ? ids[tid] : -1;
  int l = id >= 0 ? id : INT_MAX, h = id;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l = min(l, __shfl_xor_sync(0xffffffffu, l, off));
    h = max(h, __shfl_xor_sync(0xffffffffu, h, off));
  }
  if (lane == 0 && warp < kRows / 32) {
    sRange[warp] = l;
    sRange[4 + warp] = h;
  }
  __syncthreads();
  lo = min(min(sRange[0], sRange[1]), min(sRange[2], sRange[3]));
  hi = max(max(sRange[4], sRange[5]), max(sRange[6], sRange[7]));
}

// One bit a streamed tile, in words of 32 tiles over [0, n_tiles): bit j
// set when j lies in [j_lo, j_hi) (j_hi <= n_tiles) and tile j, ids
// [j kCols, (j + 1) kCols) of ids[0, total), holds an id in [lo, hi]. One
// tile a thread (16-byte loads where the tile is whole and aligned), one
// word a warp; the caller ends it with a barrier.
__device__ __forceinline__ void mark_tiles(uint32_t* bits, const int* ids,
                                           int total, int n_tiles, int j_lo,
                                           int j_hi, int lo, int hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto in_range = [&](int s) { return s >= lo && s <= hi; };
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int j = base + threadIdx.x;
    bool hit = false;
    if (j >= j_lo && j < j_hi) {
      const int c0 = j * kCols, n = min(kCols, total - c0);
      if (n == kCols && reinterpret_cast<uintptr_t>(ids + c0) % 16 == 0) {
        const int4* s4 = reinterpret_cast<const int4*>(ids + c0);
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) {
          const int4 s = s4[c];
          hit |= in_range(s.x) || in_range(s.y) || in_range(s.z) ||
                 in_range(s.w);
        }
      } else {
        for (int c = 0; c < n; ++c) hit |= in_range(ids[c0 + c]);
      }
    }
    const uint32_t word = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) bits[(base >> 5) + warp] = word;
  }
}

// Bytes of the bits for n_tiles tiles: words in groups of 8 (kThreads
// tiles), as mark_tiles writes them.
__host__ __device__ __forceinline__ int tile_bits_bytes(int n_tiles) {
  return pt::ceil_div(n_tiles, kThreads) * 8 * 4;
}

// The first tile in [j, end) whose bit equals `want`, or end.
__device__ __forceinline__ int next_tile(const uint32_t* bits, int j, int end,
                                         bool want) {
  for (int w = j >> 5; (w << 5) < end; ++w) {
    uint32_t word = want ? bits[w] : ~bits[w];
    if (w == (j >> 5)) word &= 0xffffffffu << (j & 31);
    if (word) {
      const int r = (w << 5) + __ffs(word) - 1;
      return r < end ? r : end;
    }
  }
  return end;
}

// acc[64 x kCols] = A . B^T over D: A the warpgroup's 64 rows r0.. of a
// resident [kRows][D] tile, B a streamed [kCols][D] tile; both K-major, so
// k-step kk is 32 bytes into slab kk / 4 (the swizzle is applied to the
// address, so the start may sit inside an atom). REBASE (the forwards,
// short of registers): each k-step's descriptors are one base each plus
// (kk / 4) slabs and 32 (kk % 4) bytes in the start field (16-byte units),
// and the bases are opaque to the compiler, so it does not hoist the
// resident tile's D / 16 descriptors out of the tile loop as live
// registers.
template <int D, bool REBASE = false>
__device__ __forceinline__ void product_nt(float (&acc)[kAcc], const bf16* a,
                                           const bf16* b, int r0) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  if constexpr (REBASE) {
    uint64_t da = pt::sw128_desc(a + swz<kRows>(r0, 0), 16, 1024);
    uint64_t db = pt::sw128_desc(b, 16, 1024);
    pt::opaque(da);
    pt::opaque(db);
    pt::fence_regs(acc);
    pt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      pt::wgmma_ss_m64n64(acc, da + (kk >> 2) * kRows * 8 + (kk & 3) * 2,
                          db + (kk >> 2) * kCols * 8 + (kk & 3) * 2);
  } else {
    pt::fence_regs(acc);
    pt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16;
      pt::wgmma_ss_m64n64(acc,
                          pt::sw128_desc(a + swz<kRows>(r0, c), 16, 1024),
                          pt::sw128_desc(b + swz<kCols>(0, c), 16, 1024));
    }
  }
}

// acc[64 x D] += X[64 x kCols] . T[kCols x D]: X from the accumulator
// registers of a product_nt (n-tiles 2kk, 2kk + 1 rounded to bf16 are the
// A operand of k-step kk), T a streamed [kCols][D] tile, MN-major: k-step
// kk starts at row 16 kk, slabs kCols * 128 bytes apart.
template <int D>
__device__ __forceinline__ void product_acc(float (&acc)[D / 2],
                                            const float (&x)[kAcc],
                                            const bf16* t) {
  pt::fence_regs(acc);
  pt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk) {
    const uint32_t a[4] = {pt::pack_bf16(x[8 * kk], x[8 * kk + 1]),
                           pt::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]),
                           pt::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]),
                           pt::pack_bf16(x[8 * kk + 6], x[8 * kk + 7])};
    const uint64_t desc =
        pt::sw128_desc(t + swz<kCols>(16 * kk, 0), kCols * 128, 1024);
    if constexpr (D == 128)
      pt::wgmma_rs_m64n128_tb(acc, a, desc);
    else
      pt::wgmma_rs_m64n64_tb(acc, a, desc);
  }
}

// Commit the products started since the last wgmma_fence and wait for them.
template <int N>
__device__ __forceinline__ void finish(float (&a)[N]) {
  pt::wgmma_commit();
  pt::wgmma_wait<0>();
  pt::fence_regs(a);
}
template <int N, int M>
__device__ __forceinline__ void finish(float (&a)[N], float (&b)[M]) {
  pt::wgmma_commit();
  pt::wgmma_wait<0>();
  pt::fence_regs(a);
  pt::fence_regs(b);
}

// rows r_lo, r_lo + 8 of a [*, D] matrix from the accumulator layout, bf16
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int64_t r_lo,
                                           const float (&acc)[D / 2], int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + r_lo * D + c) =
        pt::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(out + (r_lo + 8) * D + c) =
        pt::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// As store_rows, writing only the rows below r_end (a ragged end).
template <int D>
__device__ __forceinline__ void store_rows_upto(bf16* out, int64_t r_lo,
                                                const float (&acc)[D / 2],
                                                int t, int64_t r_end) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < r_end)
      *reinterpret_cast<uint32_t*>(out + r_lo * D + c) =
          pt::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r_lo + 8 < r_end)
      *reinterpret_cast<uint32_t*>(out + (r_lo + 8) * D + c) =
          pt::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Reduce a row statistic over the 4 lanes t that share a row.
__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Every non-null pointer 16-byte aligned (the bf16 kernels' cp.async).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace tc
}  // namespace pt
