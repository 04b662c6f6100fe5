// Varlen (packed, segment-id) flash-attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/varlen_attention.py::_vfa_kernel. Inputs
// q [B, H, Tq, D], k/v [B, HKV, Tk, D] (HKV divides H: query head h reads
// KV head h / (H / HKV), so GQA needs no repeated copy of K and V),
// segment ids [B, Tq] / [B, Tk] int32 with -1 = padding. Outputs O
// [B, H, Tq, D] in the input dtype and LSE [B, H, Tq] f32 (plain layout;
// the TPU's 8-sublane copy is gone).
//
// Masking follows _vfa_kernel exactly: a key is valid when
// segq == segk, segq >= 0 and, if causal, packed row >= packed col; masked
// logits are _MASK_MIN = -1e30 (not -inf), m starts at _MASK_MIN and l is
// clamped at 1e-30, so a row with no valid key returns a finite uniform
// average of V over the keys its TPU kernel visited. Which keys those are
// is given by key_end(): all Tk keys when not causal, else up to the end
// of the TPU kernel's causal bound, min(Tk, ceil((qblock + 1) * bq / bk) * bk)
// for the TPU block sizes bq, bk the wrapper passes. Keys at or past that
// bound are excluded outright (p = 0).
//
// Bound: at the packed-training shape (B=1, H=16, T=16,384 in 12
// documents, D=128, bf16, causal) the function does 4*D operations a
// within-segment causal pair a head, ~0.16 TFLOP (0.16 ms at 989 TFLOP/s),
// and moves ~0.27 GB (~80 us): operations bound. At the serving
// fresh-prefill shape (T=256, HQ=16, HKV=8) it moves ~3.2 MB (~1 us) and
// does ~0.27 GFLOP: launch and latency bound.
//
// bf16 (both paths): the design of the flash forward
// (flash_attention_fwd.cu): grid (B * H, ceil(Tq / 128)), two warpgroups,
// 128 queries of Q resident in a swizzled tile, 64-key K/V tiles (and their
// segment ids) through a 2-stage cp.async ring, S = Q K^T and O += P V by
// wgmma, the online softmax on the accumulator layout with the masks
// selected into the logits (the causal and key_end masks only on the tiles
// that reach them), exp as 2^x on the MUFU. One block an SM (165 registers
// at D = 128; held to 128 it spills and runs slower). Ragged Tq and Tk: the
// rows of a tile past the end are filled with zeros by cp.async's zero-fill
// form and masked, so any length works. Causal blocks take the last query
// tile first.
//
// Exact tile skip. A block first takes the range [lo, hi] of its
// non-negative query segment ids and marks the key tiles (up to its causal
// diagonal) that hold an id in that range; it visits only those. A tile
// left out holds no valid key for any row of the block, so for a row that
// ends with at least one valid key the skip changes no bit: an unvisited
// masked tile after the row's first valid key would add p = exp(-1e30 - m)
// = 0 with alpha = 1, and unvisited masked tiles before it would be wiped
// by alpha = exp(-1e30 - m) = 0 exactly when that key arrives. A row with
// no valid key (m still -1e30 at the end: padding rows, id -1, or a query
// segment whose keys carry another id) does depend on the route: its
// uniform average must cover every key of [0, key_end). So a block that
// ends its visit with any such row goes on to visit every tile it left
// out, the skipped ones and those past its diagonal up to key_end: to a row
// with a valid key each adds exactly 0 (as above), to a row with none each
// key adds p = exp(-1e30 - -1e30) = 1. (exp(x - m) is 2^((x - m) log2(e))
// on the MUFU: 2^0 is 1 and 2^x below x = -126 is 0, both exactly.)
// key_end is uniform over a 128-row block because the wrapper's bq is a
// multiple of 128 or at least Tq (the launch refuses anything else), so one
// decision serves the whole block.
//
// f32 (the card-vs-CPU packed parity): the CUDA-core kernel of PR 1: grid
// (ceil(Tq / 64), H, B), 256 threads, the 64-row Q tile in shared memory as
// f32, 64-key K/V tiles, each thread 4 query rows by 4 (S) or D/16 (O)
// columns, row statistics by warp shuffles; no tile skip: causal blocks
// stop at their diagonal tile and go on to key_end only when a row of the
// block has no valid key yet.
#include <limits.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

constexpr float kMaskMin = -1e30f;  // ops/pallas/flash_attention.py:58

__device__ __forceinline__ int key_end(int q0, int Tk, int causal,
                                       int bound_bq, int bound_bk) {
  if (!causal) return Tk;
  const int end = pt::ceil_div((q0 / bound_bq + 1) * bound_bq, bound_bk) *
                  bound_bk;
  return end < Tk ? end : Tk;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // 16 row groups x 4 rows = kBlockQ
constexpr int kColGroups = 16;     // threads sharing one row group

template <int D>
struct Smem {
  static constexpr int kQStride = D + 1;  // +1 word: no bank conflicts
  static constexpr int kKStride = D + 1;
  static constexpr int kPStride = kBlockK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBlockQ * kQStride;
  static constexpr int kV = kK + kBlockK * kKStride;
  static constexpr int kP = kV + kBlockK * D;
  static constexpr int kFloats = kP + kBlockQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) +
                                   kBlockK * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
varlen_fwd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ segq,
                      const int* __restrict__ segk, float* __restrict__ o,
                      float* __restrict__ lse, int H, int HKV, int Tq,
                      int Tk, int causal, int bound_bq, int bound_bk,
                      float scale) {
  using S = Smem<D>;
  constexpr int kOCols = D / kColGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sQ = sm + S::kQ;
  float* sK = sm + S::kK;
  float* sV = sm + S::kV;
  float* sP = sm + S::kP;
  int* sSegK = reinterpret_cast<int*>(sm + S::kFloats);

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid % kColGroups;  // columns tx, tx+16, ...
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / HKV);
  const float* qb = q + (static_cast<int64_t>(b) * H + h) * Tq * D;
  const float* kb = k + (static_cast<int64_t>(b) * HKV + kvh) * Tk * D;
  const float* vb = v + (static_cast<int64_t>(b) * HKV + kvh) * Tk * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    sQ[r * S::kQStride + d] =
        q0 + r < Tq ? qb[static_cast<int64_t>(q0 + r) * D + d] : 0.f;
  }

  int row[kRowsPerThread], seg_row[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kOCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    row[i] = q0 + ty * kRowsPerThread + i;
    seg_row[i] = row[i] < Tq ? segq[static_cast<int64_t>(b) * Tq + row[i]]
                             : -1;
    m[i] = kMaskMin;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.f;
  }

  const int kend = key_end(q0, Tk, causal, bound_bq, bound_bk);
  const int n_tiles = pt::ceil_div(kend, kBlockK);
  int j_end = n_tiles;
  if (causal) {
    const int through_diag = pt::ceil_div(q0 + kBlockQ, kBlockK);
    if (through_diag < j_end) j_end = through_diag;
  }

  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const bool in = k0 + c < Tk;
      const int64_t off = static_cast<int64_t>(k0 + c) * D + d;
      sK[c * S::kKStride + d] = in ? kb[off] : 0.f;
      sV[c * D + d] = in ? vb[off] : 0.f;
    }
    for (int c = tid; c < kBlockK; c += kThreads)
      sSegK[c] = k0 + c < Tk ? segk[static_cast<int64_t>(b) * Tk + k0 + c]
                             : -2;
    __syncthreads();

    float s[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = sQ[(ty * kRowsPerThread + i) * S::kQStride + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = sK[(tx + kColGroups * jj) * S::kKStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = tx + kColGroups * jj;
        const int col = k0 + cl;
        float val;
        if (col >= kend) {
          val = -INFINITY;  // past the visited range: excluded
        } else {
          const bool valid = seg_row[i] == sSegK[cl] && seg_row[i] >= 0 &&
                             (!causal || row[i] >= col);
          val = valid ? s[i][jj] * scale : kMaskMin;
        }
        s[i][jj] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        rs += p;
        sP[(ty * kRowsPerThread + i) * S::kPStride + tx + kColGroups * jj] =
            p;
      }
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = sP[(ty * kRowsPerThread + i) * S::kPStride + kk];
#pragma unroll
      for (int c = 0; c < kOCols; ++c) {
        const float vv = sV[kk * D + tx + kColGroups * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }

    if (j + 1 == j_end && j_end < n_tiles) {
      // past the diagonal tile: a row with no valid key so far averages V
      // over every key its TPU kernel visited, so only then does the block
      // go on to that bound (j_end and n_tiles are block-uniform)
      int unfilled = 0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        unfilled |= row[i] < Tq && m[i] == kMaskMin;
      if (__syncthreads_or(unfilled)) j_end = n_tiles;
    }
  }

  float* ob = o + (static_cast<int64_t>(b) * H + h) * Tq * D;
  float* lb = lse + (static_cast<int64_t>(b) * H + h) * Tq;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (row[i] >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOCols; ++c)
      ob[static_cast<int64_t>(row[i]) * D + tx + kColGroups * c] =
          acc[i][c] / l_safe;
    if (tx == 0) lb[row[i]] = m[i] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* segq, const void* segk, void* o,
                       void* lse, int B, int H, int HKV, int Tq, int Tk,
                       int causal, int bound_bq, int bound_bk, float scale,
                       cudaStream_t stream) {
  auto kernel = varlen_fwd_f32_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Tq, kBlockQ), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(segq),
      static_cast<const int*>(segk), static_cast<float*>(o),
      static_cast<float*>(lse), H, HKV, Tq, Tk, causal, bound_bq, bound_bk,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel with the exact tile skip
// ---------------------------------------------------------------------------
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

// the shared tile helpers (attention_tiles.cuh)
using pt::tc::bf16;
using pt::tc::finish;
using pt::tc::id_range;
using pt::tc::kAcc;
using pt::tc::kCols;
using pt::tc::kRows;
using pt::tc::kStages;
using pt::tc::kThreads;
using pt::tc::load_async_upto;
using pt::tc::mark_tiles;
using pt::tc::next_tile;
using pt::tc::product_acc;
using pt::tc::product_nt;
using pt::tc::row_max4;
using pt::tc::row_sum4;
using pt::tc::store_rows_upto;

// Shared memory: the resident Q tile, then kStages stages (a K and a V
// tile and kCols int segment ids), every tile on a 1024-byte boundary (the
// swizzle atom), then the block's segment range (8 ints), then one bit a
// key tile (which tiles the skip visits), in words of 32 tiles.
template <int D>
struct Smem {
  static constexpr int kRes = kRows * D;    // elements of the Q tile
  static constexpr int kStr = kCols * D;    // elements of a K or V tile
  static constexpr int kStageBytes =
      (2 * kStr * 2 + kCols * 4 + 1023) / 1024 * 1024;
  static constexpr int kRange = kRes * 2 + kStages * kStageBytes;
  static constexpr int kBits = kRange + 8 * 4;
  // bytes for Tk keys
  static size_t bytes(int Tk) {
    return kBits + pt::tc::tile_bits_bytes(pt::ceil_div(Tk, kCols));
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
varlen_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ segq,
                  const int* __restrict__ segk, bf16* __restrict__ o,
                  float* __restrict__ lse, int H, int HKV, int Tq, int Tk,
                  int causal, int bound_bq, int bound_bk, float scale) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + S::kRes * 2;
  int* sRange = reinterpret_cast<int*>(smem_raw + S::kRange);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem_raw + S::kBits);

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 7) * 64;   // the warpgroup's rows of sQ
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / HKV);
  const int n_qt = pt::ceil_div(Tq, kRows);
  const int q0 = (causal ? n_qt - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int64_t qoff = static_cast<int64_t>(bh) * Tq;
  const int64_t koff = (static_cast<int64_t>(b) * HKV + kvh) * Tk;
  const int* sq = segq + static_cast<int64_t>(b) * Tq;
  const int* sk = segk + static_cast<int64_t>(b) * Tk;
  const int kend = key_end(q0, Tk, causal, bound_bq, bound_bk);
  const int n_tiles = pt::ceil_div(kend, kCols);
  const int j_diag =
      causal ? min(n_tiles, pt::ceil_div(q0 + kRows, kCols)) : n_tiles;

  load_async_upto<D, kRows>(sQ, q + (qoff + q0) * D, Tq - q0);

  // [lo, hi] of the block's non-negative query ids (lo > hi: none); bit
  // j: key tile j (below the diagonal) holds an id in [lo, hi]
  int lo, hi;
  id_range(sq + q0, Tq - q0, sRange, lo, hi);
  mark_tiles(sBits, sk, Tk, n_tiles, 0, j_diag, lo, hi);
  __syncthreads();

  auto stage_k = [&](int slot) {
    return reinterpret_cast<bf16*>(ring + slot * S::kStageBytes);
  };
  auto load_stage = [&](int slot, int j) {
    bf16* sK = stage_k(slot);
    bf16* sV = sK + S::kStr;
    int* sSeg = reinterpret_cast<int*>(sV + S::kStr);
    const int k0 = j * kCols;
    load_async_upto<D, kCols>(sK, k + (koff + k0) * D, Tk - k0);
    load_async_upto<D, kCols>(sV, v + (koff + k0) * D, Tk - k0);
    if (tid < kCols) sSeg[tid] = k0 + tid < Tk ? sk[k0 + tid] : -2;
  };

  // this lane's queries: row_lo and row_lo + 8 (past Tq: id -1, not stored)
  const int row_lo = q0 + r0 + ((tid >> 5) & 3) * 16 + g;
  const int row_hi = row_lo + 8;
  const int seg_lo = row_lo < Tq ? sq[row_lo] : -1;
  const int seg_hi = row_hi < Tq ? sq[row_hi] : -1;
  float m_lo = kMaskMin, m_hi = kMaskMin, l_lo = 0.f, l_hi = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // pass 0 visits the marked tiles; pass 1, only for a block with a row
  // that found no valid key, every other tile up to key_end
  for (int pass = 0; pass < 2; ++pass) {
    const bool want = pass == 0;
    const int end = pass == 0 ? j_diag : n_tiles;
    int j = next_tile(sBits, 0, end, want);
    if (j < end) load_stage(0, j);
    pt::cp_async_commit();
    for (int n = 0; j < end; ++n) {
      const int nj = next_tile(sBits, j + 1, end, want);
      pt::cp_async_wait<0>();
      pt::fence_proxy_async();
      __syncthreads();  // tile j has landed; the tile before it is consumed
      if (nj < end) load_stage((n + 1) % kStages, nj);
      pt::cp_async_commit();

      const int k0 = j * kCols;
      const bf16* sK = stage_k(n % kStages);
      const bf16* sV = sK + S::kStr;
      const int* sSeg = reinterpret_cast<const int*>(sV + S::kStr);

      float s[kAcc];  // S [64 queries x 64 keys], then P
      product_nt<D, true>(s, sQ, sK, r0);
      finish(s);

      // logits, the masks selected in (element 4jj + e: row lo + 8 (e / 2),
      // column 8jj + 2t + e % 2): the segment match everywhere, then the
      // causal and key_end masks only on the tiles that reach them
#pragma unroll
      for (int jj = 0; jj < kAcc / 4; ++jj) {
        const int2 sg =
            *reinterpret_cast<const int2*>(sSeg + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int seg = e < 2 ? seg_lo : seg_hi;
          const bool valid = seg == (e & 1 ? sg.y : sg.x) && seg >= 0;
          s[4 * jj + e] = valid ? s[4 * jj + e] * scale : kMaskMin;
        }
      }
      if ((causal && k0 + kCols > q0) || k0 + kCols > kend) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int e = i & 3;
          const int key = k0 + (i >> 2) * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (causal && row < key) s[i] = kMaskMin;
          if (key >= kend) s[i] = -INFINITY;  // past the range: excluded
        }
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        if (i & 2)
          mx_hi = fmaxf(mx_hi, s[i]);
        else
          mx_lo = fmaxf(mx_lo, s[i]);
      }
      const float mn_lo = fmaxf(m_lo, row_max4(mx_lo));
      const float mn_hi = fmaxf(m_hi, row_max4(mx_hi));
      const float al_lo = pt::exp2_approx((m_lo - mn_lo) * kLog2e);
      const float al_hi = pt::exp2_approx((m_hi - mn_hi) * kLog2e);
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int e = i & 3;
        s[i] = pt::exp2_approx((s[i] - (e < 2 ? mn_lo : mn_hi)) * kLog2e);
        if (e < 2)
          rs_lo += s[i];
        else
          rs_hi += s[i];
      }
      l_lo = l_lo * al_lo + rs_lo;
      l_hi = l_hi * al_hi + rs_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al_hi : al_lo;
      product_acc<D>(acc, s, sV);  // O += P V
      finish(acc);
      j = nj;
    }
    pt::cp_async_wait<0>();
    if (pass == 0) {
      const bool dead = (row_lo < Tq && m_lo == kMaskMin) ||
                        (row_hi < Tq && m_hi == kMaskMin);
      if (!__syncthreads_or(dead)) break;
    }
  }

  const float lt_lo = fmaxf(row_sum4(l_lo), 1e-30f);
  const float lt_hi = fmaxf(row_sum4(l_hi), 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] /= (i & 2) ? lt_hi : lt_lo;
  store_rows_upto<D>(o, qoff + row_lo, acc, t, qoff + Tq);
  if (t == 0) {
    if (row_lo < Tq) lse[qoff + row_lo] = m_lo + logf(lt_lo);
    if (row_hi < Tq) lse[qoff + row_hi] = m_hi + logf(lt_hi);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* segq, const void* segk, void* o, void* lse,
                   int B, int H, int HKV, int Tq, int Tk, int causal,
                   int bound_bq, int bound_bk, float scale,
                   cudaStream_t stream) {
  // key_end must be uniform over a 128-row block
  if (bound_bq % kRows != 0 && bound_bq < Tq) return cudaErrorInvalidValue;
  auto kernel = varlen_fwd_kernel<D>;
  const size_t smem = Smem<D>::bytes(Tk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, pt::ceil_div(Tq, kRows));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(segq),
      static_cast<const int*>(segk), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, HKV, Tq, Tk, causal, bound_bq, bound_bk,
      scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// All tensors contiguous; D in {64, 128}; Tq, Tk > 0; HKV divides H;
// bound_bq, bound_bk > 0 and multiples of 64 (checked by the wrapper).
extern "C" int pt_varlen_attention_fwd(
    const void* q, const void* k, const void* v, const void* segq,
    const void* segk, void* o, void* lse, int B, int H, int HKV, int Tq,
    int Tk, int D, int causal, int bound_bq, int bound_bk, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBFloat16 && !pt::tc::aligned16({q, k, v, o}))
    return cudaErrorInvalidValue;
#define PT_VARLEN_LAUNCH(F, DD)                                          \
  return F<DD>(q, k, v, segq, segk, o, lse, B, H, HKV, Tq, Tk, causal,   \
               bound_bq, bound_bk, scale, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_VARLEN_LAUNCH(tc::launch, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_VARLEN_LAUNCH(tc::launch, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_VARLEN_LAUNCH(launch_f32, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_VARLEN_LAUNCH(launch_f32, 64);
#undef PT_VARLEN_LAUNCH
  return cudaErrorInvalidValue;
}
