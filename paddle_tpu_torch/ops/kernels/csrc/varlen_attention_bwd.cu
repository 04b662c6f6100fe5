// Varlen (packed, segment-id) flash-attention backward for Hopper (sm_90a):
// dK/dV, then dQ.
//
// Replace paddle_tpu/ops/pallas/varlen_attention.py::_vfa_bwd_dkv_kernel and
// ::_vfa_bwd_dq_kernel. Inputs q, dO [B, H, Tq, D], k, v [B, H, Tk, D]
// contiguous (H == HKV: the TPU kernels reshape k and v to [B*H, Tk, D]),
// segment ids seg_q [B, Tq] and seg_k [B, Tk] int32 (-1 = padding), and the
// forward's LSE and delta = rowsum(dO * O) as [B, H, Tq] f32. Both kernels
// recompute P = exp(S * scale - lse) where the pair is valid (seg_k ==
// seg_q, seg_k >= 0, and row >= col on packed positions when causal) and
// take P = 0 exactly elsewhere, as the TPU kernels' where(valid, ., 0)
// does: a padding row, a padding key and a row with no valid key get zero
// gradient, whatever their LSE (a dead row's LSE is finite, -1e30 +
// log(n), and never enters a valid P). dS = P * (dP - delta) * scale; P is
// rounded to dO's dtype before dV += P^T dO and dS to Q's (K's) dtype
// before dK += dS^T Q (dQ += dS K), as the TPU kernels do.
//
// Bound: at the packed-training shape (B=1, H=16, T=16,384 in 12
// documents, D=128, bf16, causal) the within-segment causal pairs are
// ~14.5% of the causal triangle; dK/dV does 8*D operations a pair a head
// (S, dP, dV, dK) and dQ 6*D (S, dP, dQ): 0.32 and 0.24 ms at 989 TFLOP/s,
// against ~30 MB moved each (~9 us): operations bound.
//
// bf16: the design of the flash backward (flash_attention_bwd.cu) plus the
// varlen forward's exact tile skip (varlen_attention.cu). dK/dV: grid
// (B * H, ceil(Tk / 128)), two warpgroups; K and V for the block's 128
// keys resident as 128-byte-swizzled tiles; 64-query tiles of Q, dO, LSE,
// delta and their segment ids through the 2-stage cp.async ring; S^T and
// dP^T by wgmma from shared memory; P^T and dS^T formed in registers,
// rounded to bf16 and fed as the register A operand of dV += P^T dO and dK
// += dS^T Q (B MN-major). dQ: grid (B * H, ceil(Tq / 128)); Q and dO
// resident; 64-key tiles of K, V and their ids streamed up to the block's
// causal diagonal; dQ += dS K from registers. The exponential is 2^x on
// the MUFU for every element, then a select on `valid` (never a multiply
// by a 0/1 mask: an invalid pair's exp may be inf). Any Tq and Tk: the
// rows of a tile past the end are filled with zeros by cp.async's
// zero-fill form, carry id -1 (so no pair of theirs is valid), and are not
// stored. One block an SM, as the flash backward.
//
// Exact tile skip. A block takes the range [lo, hi] of its 128 rows'
// non-negative ids and first marks, one bit a tile, the streamed tiles
// (inside its causal bound) that hold an id in that range; the ring then
// visits only those. A tile left out holds no valid pair with any of the
// block's rows, so its P and dS are exactly 0 and it adds nothing: the
// skip changes no bit. Unlike the forward, a dead row needs no second pass
// (its P is 0 on every key). The ids need not be sorted. No block writes
// another's rows: no atomics, the same bits every run.
//
// f32 (the card-vs-CPU packed parity; tensor cores would round to TF32):
// CUDA-core kernels. dK/dV: grid (ceil(Tk / 64), H, B), 256
// threads; a block owns one 64-key tile (K, V in shared memory as f32, dK
// and dV accumulated in f32 registers, 4 keys x D/16 columns a thread) and
// loops over the 64-row Q tiles from the causal lower bound k0 / 64. dQ:
// grid (ceil(Tq / 64), H, B); a block owns one 64-row Q tile and loops
// over KV tiles up to its diagonal. Tile skip: a block keeps the range of
// its own tile's non-negative ids and skips a tile of the other side none
// of whose ids falls in it (one __syncthreads_or over the 64 ids, which is
// also the loop's barrier).
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int kTile = 64;          // query and key tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // 16 row groups x 4 rows = kTile
constexpr int kColGroups = 16;     // threads sharing one row group

template <int D>
struct Smem {
  static constexpr int kStride = D + 1;  // +1 word: no bank conflicts
  static constexpr int kTStride = kTile + 1;
  static constexpr int kA = 0;                        // K (dkv) / Q (dq)
  static constexpr int kB = kA + kTile * kStride;     // V (dkv) / dO (dq)
  static constexpr int kC = kB + kTile * kStride;     // Q (dkv) / K (dq)
  static constexpr int kD = kC + kTile * kStride;     // dO (dkv) / V (dq)
  static constexpr int kP = kD + kTile * kStride;     // p_used^T (dkv)
  static constexpr int kS = kP + kTile * kTStride;    // dS^T (dkv) / dS (dq)
  static constexpr int kVec = kS + kTile * kTStride;  // lse (dkv)
  static constexpr int kVec2 = kVec + kTile;          // delta (dkv)
  static constexpr int kSeg = kVec2 + kTile;          // segment ids (int)
  static constexpr int kFloats = kSeg + kTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// rows [r0, r0 + 64) of a [rows, D] matrix into shared memory as f32
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * Smem<D>::kStride + d] =
        r0 + r < rows ? src[static_cast<int64_t>(r0 + r) * D + d] : 0.f;
  }
}

// The 64 segment ids of a tile (-1 past the end) into shared memory, then
// the range [lo, hi] of its non-negative ids (lo > hi when it has none),
// computed by every thread from shared memory. Ends with a barrier.
__device__ __forceinline__ void tile_segments(int* sSeg, const int* seg,
                                              int r0, int rows, int* lo,
                                              int* hi) {
  if (threadIdx.x < kTile)
    sSeg[threadIdx.x] = r0 + threadIdx.x < rows ? seg[r0 + threadIdx.x] : -1;
  __syncthreads();
  int l = INT_MAX, h = -1;
  for (int c = 0; c < kTile; ++c) {
    const int s = sSeg[c];
    if (s >= 0) {
      l = min(l, s);
      h = max(h, s);
    }
  }
  *lo = l;
  *hi = h;
  __syncthreads();
}

// Segment id of row r0 + threadIdx.x of the other side's tile (-1 past the
// end or for threads past the tile), and whether any of the tile's ids lies
// in [lo, hi]. The __syncthreads_or is the barrier that ends the previous
// tile's use of shared memory.
__device__ __forceinline__ bool tile_overlaps(const int* seg, int r0,
                                              int rows, int lo, int hi,
                                              int* my_seg) {
  const int s = (threadIdx.x < kTile && r0 + threadIdx.x < rows)
                    ? seg[r0 + threadIdx.x]
                    : -1;
  *my_seg = s;
  return __syncthreads_or(s >= 0 && s >= lo && s <= hi) != 0;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dkv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const int* __restrict__ segq,
                          const int* __restrict__ segk,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Sq, int Sk, int causal, float scale) {
  using S = Smem<D>;
  constexpr int kOCols = D / kColGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sK = sm + S::kA;
  float* sV = sm + S::kB;
  float* sQ = sm + S::kC;
  float* sDO = sm + S::kD;
  float* sP = sm + S::kP;    // [key][query]
  float* sDS = sm + S::kS;   // [key][query]
  float* sLse = sm + S::kVec;
  float* sDelta = sm + S::kVec2;
  int* sSeg = reinterpret_cast<int*>(sm + S::kSeg);

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;  // key rows ty*4 .. ty*4+3
  const int tx = tid % kColGroups;  // query columns / D columns tx + 16*c
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int64_t qoff = static_cast<int64_t>(bh) * Sq;
  const int64_t koff = static_cast<int64_t>(bh) * Sk;
  const int* segq_b = segq + static_cast<int64_t>(b) * Sq;
  const int* segk_b = segk + static_cast<int64_t>(b) * Sk;

  int lo, hi;
  tile_segments(sSeg, segk_b, k0, Sk, &lo, &hi);
  int key[kRowsPerThread], key_seg[kRowsPerThread];
  float acc_dk[kRowsPerThread][kOCols], acc_dv[kRowsPerThread][kOCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    key[i] = k0 + ty * kRowsPerThread + i;
    key_seg[i] = sSeg[ty * kRowsPerThread + i];  // -1 past Sk
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;
  }
  load_tile<D>(sK, k + koff * D, k0, Sk);
  load_tile<D>(sV, v + koff * D, k0, Sk);

  const int n_q = pt::ceil_div(Sq, kTile);
  const int i_begin = causal ? k0 / kTile : 0;
  for (int it = i_begin; it < n_q; ++it) {
    const int q0 = it * kTile;
    int my_seg;
    // also the barrier: the previous tile's Q, dO, P, dS and ids (and, on
    // the first pass, the key ids read above) are consumed
    if (!tile_overlaps(segq_b, q0, Sq, lo, hi, &my_seg)) continue;
    if (tid < kTile) sSeg[tid] = my_seg;
    load_tile<D>(sQ, q + qoff * D, q0, Sq);
    load_tile<D>(sDO, dout + qoff * D, q0, Sq);
    for (int c = tid; c < kTile; c += kThreads) {
      const bool in = q0 + c < Sq;
      sLse[c] = in ? lse[qoff + q0 + c] : 0.f;
      sDelta[c] = in ? delta[qoff + q0 + c] : 0.f;
    }
    __syncthreads();

    // S^T[key][query] = K . Q and dP^T[key][query] = V . dO, one pass
    float st[kRowsPerThread][4], dpt[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) st[i][jj] = dpt[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRowsPerThread], vv[kRowsPerThread], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        kv[i] = sK[(ty * kRowsPerThread + i) * S::kStride + d];
        vv[i] = sV[(ty * kRowsPerThread + i) * S::kStride + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        qv[jj] = sQ[(tx + kColGroups * jj) * S::kStride + d];
        ov[jj] = sDO[(tx + kColGroups * jj) * S::kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          st[i][jj] = fmaf(kv[i], qv[jj], st[i][jj]);
          dpt[i][jj] = fmaf(vv[i], ov[jj], dpt[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = tx + kColGroups * jj;
        const int qi = q0 + cl;
        float p = 0.f, ds = 0.f;
        // sSeg is -1 past Sq and key_seg -1 past Sk: both never valid
        if (key_seg[i] >= 0 && key_seg[i] == sSeg[cl] &&
            !(causal && qi < key[i])) {
          p = expf(st[i][jj] * scale - sLse[cl]);
          ds = p * (dpt[i][jj] - sDelta[cl]) * scale;
        }
        const int r = ty * kRowsPerThread + i;
        sP[r * S::kTStride + cl] = p;
        sDS[r * S::kTStride + cl] = ds;
      }
    __syncthreads();

    // dV[key] += sum_q P^T[key][q] dO[q]; dK[key] += sum_q dS^T Q[q]
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[kRowsPerThread], sv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        pv[i] = sP[(ty * kRowsPerThread + i) * S::kTStride + qq];
        sv[i] = sDS[(ty * kRowsPerThread + i) * S::kTStride + qq];
      }
#pragma unroll
      for (int c = 0; c < kOCols; ++c) {
        const float ov = sDO[qq * S::kStride + tx + kColGroups * c];
        const float qv = sQ[qq * S::kStride + tx + kColGroups * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          acc_dv[i][c] = fmaf(pv[i], ov, acc_dv[i][c]);
          acc_dk[i][c] = fmaf(sv[i], qv, acc_dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (key[i] >= Sk) continue;
    const int64_t base = (koff + key[i]) * D;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) {
      dk[base + tx + kColGroups * c] = acc_dk[i][c];
      dv[base + tx + kColGroups * c] = acc_dv[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dq_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const int* __restrict__ segq,
                         const int* __restrict__ segk,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int Sq, int Sk,
                         int causal, float scale) {
  using S = Smem<D>;
  constexpr int kOCols = D / kColGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sQ = sm + S::kA;
  float* sDO = sm + S::kB;
  float* sK = sm + S::kC;
  float* sV = sm + S::kD;
  float* sDS = sm + S::kS;    // [query][key]
  int* sSeg = reinterpret_cast<int*>(sm + S::kSeg);

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;  // query rows ty*4 .. ty*4+3
  const int tx = tid % kColGroups;  // key columns / D columns tx + 16*c
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int64_t qoff = static_cast<int64_t>(bh) * Sq;
  const int64_t koff = static_cast<int64_t>(bh) * Sk;
  const int* segq_b = segq + static_cast<int64_t>(b) * Sq;
  const int* segk_b = segk + static_cast<int64_t>(b) * Sk;

  int lo, hi;
  tile_segments(sSeg, segq_b, q0, Sq, &lo, &hi);
  int row[kRowsPerThread], row_seg[kRowsPerThread];
  float row_lse[kRowsPerThread], row_delta[kRowsPerThread];
  float acc[kRowsPerThread][kOCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    row[i] = q0 + ty * kRowsPerThread + i;
    row_seg[i] = sSeg[ty * kRowsPerThread + i];  // -1 past Sq
    const bool in = row[i] < Sq;
    row_lse[i] = in ? lse[qoff + row[i]] : 0.f;
    row_delta[i] = in ? delta[qoff + row[i]] : 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.f;
  }
  load_tile<D>(sQ, q + qoff * D, q0, Sq);
  load_tile<D>(sDO, dout + qoff * D, q0, Sq);

  int j_end = pt::ceil_div(Sk, kTile);
  if (causal) {
    const int through_diag = pt::ceil_div(q0 + kTile, kTile);
    if (through_diag < j_end) j_end = through_diag;
  }
  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * kTile;
    int my_seg;
    // also the barrier: the previous tile's K, V, dS and ids (and, on the
    // first pass, the row ids read above) are consumed
    if (!tile_overlaps(segk_b, k0, Sk, lo, hi, &my_seg)) continue;
    if (tid < kTile) sSeg[tid] = my_seg;
    load_tile<D>(sK, k + koff * D, k0, Sk);
    load_tile<D>(sV, v + koff * D, k0, Sk);
    __syncthreads();

    // S[query][key] = Q . K and dP[query][key] = dO . V, one pass over D
    float s[kRowsPerThread][4], dp[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], ov[kRowsPerThread], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        qv[i] = sQ[(ty * kRowsPerThread + i) * S::kStride + d];
        ov[i] = sDO[(ty * kRowsPerThread + i) * S::kStride + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kv[jj] = sK[(tx + kColGroups * jj) * S::kStride + d];
        vv[jj] = sV[(tx + kColGroups * jj) * S::kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
          dp[i][jj] = fmaf(ov[i], vv[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = tx + kColGroups * jj;
        float ds = 0.f;
        // row_seg is -1 past Sq and sSeg -1 past Sk: both never valid
        if (row_seg[i] >= 0 && row_seg[i] == sSeg[cl] &&
            !(causal && row[i] < k0 + cl)) {
          const float p = expf(s[i][jj] * scale - row_lse[i]);
          ds = p * (dp[i][jj] - row_delta[i]) * scale;
        }
        sDS[(ty * kRowsPerThread + i) * S::kTStride + cl] =
            ds;
      }
    __syncthreads();

    // dQ[q] += sum_k dS[q][k] K[k]
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        sv[i] = sDS[(ty * kRowsPerThread + i) * S::kTStride + kk];
#pragma unroll
      for (int c = 0; c < kOCols; ++c) {
        const float kv = sK[kk * S::kStride + tx + kColGroups * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (row[i] >= Sq) continue;
    const int64_t base = (qoff + row[i]) * D;
#pragma unroll
    for (int c = 0; c < kOCols; ++c)
      dq[base + tx + kColGroups * c] = acc[i][c];
  }
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* segq, const void* segk,
                       const void* lse, const void* delta, void* dk,
                       void* dv, int B, int H, int Sq, int Sk, int causal,
                       float scale, cudaStream_t stream) {
  auto kernel = varlen_bwd_dkv_f32_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sk, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                      const void* dout, const void* segq, const void* segk,
                      const void* lse, const void* delta, void* dq, int B,
                      int H, int Sq, int Sk, int causal, float scale,
                      cudaStream_t stream) {
  auto kernel = varlen_bwd_dq_f32_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sq, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels with the exact tile skip
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
using pt::tc::load_col_async;
using pt::tc::mark_tiles;
using pt::tc::next_tile;
using pt::tc::product_acc;
using pt::tc::product_nt;
using pt::tc::store_rows_upto;

// Shared memory: the two resident tiles, then kStages stages, each two
// streamed tiles and VECS vectors of kCols 4-byte values (dK/dV: LSE,
// delta and the query ids; dQ: the key ids), every tile on a 1024-byte
// boundary (the swizzle atom), then the block's id range (8 ints), then
// one bit a streamed tile.
template <int D, int VECS>
struct Smem {
  static constexpr int kRes = kRows * D;    // elements of a resident tile
  static constexpr int kStr = kCols * D;    // elements of a streamed tile
  static constexpr int kStageBytes =
      (2 * kStr * 2 + VECS * kCols * 4 + 1023) / 1024 * 1024;
  static constexpr int kRange = 2 * kRes * 2 + kStages * kStageBytes;
  static constexpr int kBits = kRange + 8 * 4;
  // bytes for T rows on the streamed side
  static size_t bytes(int T) {
    return kBits + pt::tc::tile_bits_bytes(pt::ceil_div(T, kCols));
  }
};

// dK/dV. grid (B * H, ceil(Tk / 128)): a block owns 128 keys (K, V
// resident, zero past Tk; warpgroup w keys 64w..64w+63) and streams the
// 64-query tiles (Q, dO, LSE, delta, query ids; zero and id -1 past Tq)
// that its skip marked, from the causal lower bound. Per tile a warpgroup
// forms S^T and dP^T [64 keys x 64 queries] on the tensor cores, turns
// them into P^T and dS^T in registers (exp for every element, then the
// select on `valid`), and feeds them as the A operand of dV += P^T dO and
// dK += dS^T Q (dO and Q MN-major). Key block 0 has the most query tiles
// under causal: blockIdx.y = 0 starts first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
varlen_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const int* __restrict__ segq,
                      const int* __restrict__ segk,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int Tq, int Tk,
                      int causal, float scale) {
  using S = Smem<D, 3>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + S::kRes;
  unsigned char* ring = smem_raw + 2 * S::kRes * 2;
  int* sRange = reinterpret_cast<int*>(smem_raw + S::kRange);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem_raw + S::kBits);

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 7) * 64;   // the warpgroup's rows of sK, sV
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * kRows;
  const int64_t qoff = static_cast<int64_t>(bh) * Tq;
  const int64_t koff = static_cast<int64_t>(bh) * Tk;
  const int* sq = segq + static_cast<int64_t>(b) * Tq;
  const int* sk = segk + static_cast<int64_t>(b) * Tk;
  const int n_qt = pt::ceil_div(Tq, kCols);
  // under causal the query tiles before k0 hold no row >= a key of the
  // block
  const int i_begin = causal ? min(k0 / kCols, n_qt) : 0;

  load_async_upto<D, kRows>(sK, k + (koff + k0) * D, Tk - k0);
  load_async_upto<D, kRows>(sV, v + (koff + k0) * D, Tk - k0);

  // [lo, hi] of the block's non-negative key ids; bit i: query tile i
  // (from i_begin) holds an id in [lo, hi]
  int lo, hi;
  id_range(sk + k0, Tk - k0, sRange, lo, hi);
  mark_tiles(sBits, sq, Tq, n_qt, i_begin, n_qt, lo, hi);
  __syncthreads();

  auto stage_q = [&](int slot) {
    return reinterpret_cast<bf16*>(ring + slot * S::kStageBytes);
  };
  auto load_stage = [&](int slot, int it) {
    bf16* sQ = stage_q(slot);
    bf16* sDO = sQ + S::kStr;
    float* vec = reinterpret_cast<float*>(sDO + S::kStr);
    const int q0 = it * kCols, n = Tq - q0;
    load_async_upto<D, kCols>(sQ, q + (qoff + q0) * D, n);
    load_async_upto<D, kCols>(sDO, dout + (qoff + q0) * D, n);
    load_col_async(vec, lse + qoff + q0, n, 0.f, 0);
    load_col_async(vec + kCols, delta + qoff + q0, n, 0.f, kCols);
    load_col_async(reinterpret_cast<int*>(vec + 2 * kCols), sq + q0, n, -1,
                   2 * kCols);
  };

  // this lane's keys: key_lo and key_lo + 8 (past Tk: id -1, not stored)
  const int key_lo = k0 + r0 + ((tid >> 5) & 3) * 16 + g;
  const int key_hi = key_lo + 8;
  const int seg_lo = key_lo < Tk ? sk[key_lo] : -1;
  const int seg_hi = key_hi < Tk ? sk[key_hi] : -1;
  const float scale_log2 = scale * kLog2e;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  int it = next_tile(sBits, i_begin, n_qt, true);
  if (it < n_qt) load_stage(0, it);
  pt::cp_async_commit();
  for (int n = 0; it < n_qt; ++n) {
    const int nit = next_tile(sBits, it + 1, n_qt, true);
    pt::cp_async_wait<0>();
    pt::fence_proxy_async();
    __syncthreads();  // tile it has landed; the tile before it is consumed
    if (nit < n_qt) load_stage((n + 1) % kStages, nit);
    pt::cp_async_commit();

    // A warpgroup none of whose pairs is valid in this tile runs it all
    // the same, selected to zero: a branch on the warpgroup index would
    // serialize the wgmma pipeline.
    const int q0 = it * kCols;
    const bf16* sQ = stage_q(n % kStages);
    const bf16* sDO = sQ + S::kStr;
    const float* sLse = reinterpret_cast<const float*>(sDO + S::kStr);
    const float* sDelta = sLse + kCols;
    const int* sSeg = reinterpret_cast<const int*>(sDelta + kCols);

    float st[kAcc], dpt[kAcc];  // S^T, dP^T [64 keys x 64 queries]
    product_nt<D>(st, sK, sQ, r0);
    product_nt<D>(dpt, sV, sDO, r0);
    finish(st, dpt);

    // st <- P^T, dpt <- dS^T (element 4jj + e: key lo + 8 (e / 2), query
    // column 8jj + 2t + e % 2). exp(x) as 2^(x log2(e)) for every element,
    // then the select: an invalid pair's exponential may be inf, and the
    // select still gives an exact 0. The causal compare is made only on
    // the tiles that reach the block's diagonal (a second instantiation of
    // the loop): elsewhere every query follows every key of the block.
    auto grads = [&](auto diag) {
#pragma unroll
      for (int jj = 0; jj < kAcc / 4; ++jj) {
        const int c0 = 8 * jj + 2 * t;
        const int2 id = *reinterpret_cast<const int2*>(sSeg + c0);
        const float2 ls = *reinterpret_cast<const float2*>(sLse + c0);
        const float2 dl = *reinterpret_cast<const float2*>(sDelta + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const int seg = e < 2 ? seg_lo : seg_hi;
          const int key = e < 2 ? key_lo : key_hi;
          const int qi = q0 + c0 + (e & 1);
          const bool valid = seg >= 0 && seg == (e & 1 ? id.y : id.x) &&
                             !(decltype(diag)::value && qi < key);
          const float p = pt::exp2_approx(st[i] * scale_log2 -
                                          (e & 1 ? ls.y : ls.x) * kLog2e);
          st[i] = valid ? p : 0.f;
          dpt[i] =
              valid ? p * (dpt[i] - (e & 1 ? dl.y : dl.x)) * scale : 0.f;
        }
      }
    };
    if (causal && q0 < k0 + kRows)
      grads(std::true_type{});
    else
      grads(std::false_type{});
    product_acc<D>(acc_dv, st, sDO);   // dV += P^T dO
    product_acc<D>(acc_dk, dpt, sQ);   // dK += dS^T Q
    finish(acc_dv, acc_dk);
    it = nit;
  }
  pt::cp_async_wait<0>();

  store_rows_upto<D>(dk, koff + key_lo, acc_dk, t, koff + Tk);
  store_rows_upto<D>(dv, koff + key_lo, acc_dv, t, koff + Tk);
}

// dQ. grid (B * H, ceil(Tq / 128)): a block owns 128 queries (Q, dO
// resident, zero past Tq; warpgroup w rows 64w..64w+63) and streams the
// 64-key tiles (K, V and the key ids; zero and id -1 past Tk) that its
// skip marked, up to its causal diagonal. Per tile a warpgroup forms S and
// dP [64 queries x 64 keys], turns them into dS in registers and feeds it
// as the A operand of dQ += dS K (K MN-major). Under causal the last query
// block has the most key tiles: blockIdx.y = 0 takes it.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
varlen_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const int* __restrict__ segq,
                     const int* __restrict__ segk,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int H, int Tq, int Tk, int causal, float scale) {
  using S = Smem<D, 1>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + S::kRes;
  unsigned char* ring = smem_raw + 2 * S::kRes * 2;
  int* sRange = reinterpret_cast<int*>(smem_raw + S::kRange);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem_raw + S::kBits);

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 7) * 64;   // the warpgroup's rows of sQ, sDO
  const int bh = blockIdx.x, b = bh / H;
  const int n_qb = pt::ceil_div(Tq, kRows);
  const int q0 = (causal ? n_qb - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int64_t qoff = static_cast<int64_t>(bh) * Tq;
  const int64_t koff = static_cast<int64_t>(bh) * Tk;
  const int* sq = segq + static_cast<int64_t>(b) * Tq;
  const int* sk = segk + static_cast<int64_t>(b) * Tk;
  const int n_kt = pt::ceil_div(Tk, kCols);
  const int j_end =
      causal ? min(n_kt, pt::ceil_div(q0 + kRows, kCols)) : n_kt;

  load_async_upto<D, kRows>(sQ, q + (qoff + q0) * D, Tq - q0);
  load_async_upto<D, kRows>(sDO, dout + (qoff + q0) * D, Tq - q0);

  // [lo, hi] of the block's non-negative query ids; bit j: key tile j
  // (below the diagonal) holds an id in [lo, hi]
  int lo, hi;
  id_range(sq + q0, Tq - q0, sRange, lo, hi);
  mark_tiles(sBits, sk, Tk, n_kt, 0, j_end, lo, hi);
  __syncthreads();

  auto stage_k = [&](int slot) {
    return reinterpret_cast<bf16*>(ring + slot * S::kStageBytes);
  };
  auto load_stage = [&](int slot, int j) {
    bf16* sK = stage_k(slot);
    bf16* sV = sK + S::kStr;
    int* sSeg = reinterpret_cast<int*>(sV + S::kStr);
    const int k0 = j * kCols, n = Tk - k0;
    load_async_upto<D, kCols>(sK, k + (koff + k0) * D, n);
    load_async_upto<D, kCols>(sV, v + (koff + k0) * D, n);
    load_col_async(sSeg, sk + k0, n, -1, 0);
  };

  // this lane's queries: row_lo and row_lo + 8 (past Tq: id -1, not
  // stored)
  const int row_lo = q0 + r0 + ((tid >> 5) & 3) * 16 + g;
  const int row_hi = row_lo + 8;
  const bool in_lo = row_lo < Tq, in_hi = row_hi < Tq;
  const int seg_lo = in_lo ? sq[row_lo] : -1;
  const int seg_hi = in_hi ? sq[row_hi] : -1;
  const float lse_lo = in_lo ? lse[qoff + row_lo] * kLog2e : 0.f;
  const float lse_hi = in_hi ? lse[qoff + row_hi] * kLog2e : 0.f;
  const float dl_lo = in_lo ? delta[qoff + row_lo] : 0.f;
  const float dl_hi = in_hi ? delta[qoff + row_hi] : 0.f;
  const float scale_log2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  int j = next_tile(sBits, 0, j_end, true);
  if (j < j_end) load_stage(0, j);
  pt::cp_async_commit();
  for (int n = 0; j < j_end; ++n) {
    const int nj = next_tile(sBits, j + 1, j_end, true);
    pt::cp_async_wait<0>();
    pt::fence_proxy_async();
    __syncthreads();  // tile j has landed; the tile before it is consumed
    if (nj < j_end) load_stage((n + 1) % kStages, nj);
    pt::cp_async_commit();

    const int k0 = j * kCols;
    const bf16* sK = stage_k(n % kStages);
    const bf16* sV = sK + S::kStr;
    const int* sSeg = reinterpret_cast<const int*>(sV + S::kStr);

    float s[kAcc], dp[kAcc];  // S, dP [64 queries x 64 keys]
    product_nt<D>(s, sQ, sK, r0);
    product_nt<D>(dp, sDO, sV, r0);
    finish(s, dp);

    // s <- dS (element 4jj + e: row lo + 8 (e / 2), key column 8jj + 2t +
    // e % 2; exp for every element, then the select, as in dK/dV)
#pragma unroll
    for (int jj = 0; jj < kAcc / 4; ++jj) {
      const int c0 = 8 * jj + 2 * t;
      const int2 id = *reinterpret_cast<const int2*>(sSeg + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const int seg = e < 2 ? seg_lo : seg_hi;
        const int row = e < 2 ? row_lo : row_hi;
        const int key = k0 + c0 + (e & 1);
        const bool valid = seg >= 0 && seg == (e & 1 ? id.y : id.x) &&
                           !(causal && row < key);
        const float p = pt::exp2_approx(s[i] * scale_log2 -
                                        (e < 2 ? lse_lo : lse_hi));
        s[i] = valid ? p * (dp[i] - (e < 2 ? dl_lo : dl_hi)) * scale : 0.f;
      }
    }
    product_acc<D>(acc, s, sK);  // dQ += dS K
    finish(acc);
    j = nj;
  }
  pt::cp_async_wait<0>();

  store_rows_upto<D>(dq, qoff + row_lo, acc, t, qoff + Tq);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* segq, const void* segk,
                       const void* lse, const void* delta, void* dk,
                       void* dv, int B, int H, int Tq, int Tk, int causal,
                       float scale, cudaStream_t stream) {
  auto kernel = varlen_bwd_dkv_kernel<D>;
  const size_t smem = Smem<D, 3>::bytes(Tq);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, pt::ceil_div(Tk, kRows));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, Tk, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* segq, const void* segk,
                      const void* lse, const void* delta, void* dq, int B,
                      int H, int Tq, int Tk, int causal, float scale,
                      cudaStream_t stream) {
  auto kernel = varlen_bwd_dq_kernel<D>;
  const size_t smem = Smem<D, 1>::bytes(Tk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, pt::ceil_div(Tq, kRows));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// All tensors contiguous; D in {64, 128}; B, H, Tq, Tk > 0; seg_q [B, Tq],
// seg_k [B, Tk] int32; lse, delta [B, H, Tq] f32 (checked by the wrapper).
// bf16: q, k, v, dO, dK, dV 16-byte aligned (cp.async), else refused.
extern "C" int pt_varlen_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* segq, const void* segk, const void* lse, const void* delta,
    void* dk, void* dv, int B, int H, int Tq, int Tk, int D, int causal,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBFloat16 &&
      !pt::tc::aligned16({q, k, v, dout, dk, dv}))
    return cudaErrorInvalidValue;
#define PT_VB_DKV_LAUNCH(F, DD)                                          \
  return F<DD>(q, k, v, dout, segq, segk, lse, delta, dk, dv, B, H, Tq, \
               Tk, causal, scale, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_VB_DKV_LAUNCH(tc::launch_dkv, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_VB_DKV_LAUNCH(tc::launch_dkv, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_VB_DKV_LAUNCH(launch_dkv_f32, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_VB_DKV_LAUNCH(launch_dkv_f32, 64);
#undef PT_VB_DKV_LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" int pt_varlen_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* segq, const void* segk, const void* lse, const void* delta,
    void* dq, int B, int H, int Tq, int Tk, int D, int causal, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBFloat16 && !pt::tc::aligned16({q, k, v, dout, dq}))
    return cudaErrorInvalidValue;
#define PT_VB_DQ_LAUNCH(F, DD)                                          \
  return F<DD>(q, k, v, dout, segq, segk, lse, delta, dq, B, H, Tq, Tk, \
               causal, scale, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_VB_DQ_LAUNCH(tc::launch_dq, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_VB_DQ_LAUNCH(tc::launch_dq, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_VB_DQ_LAUNCH(launch_dq_f32, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_VB_DQ_LAUNCH(launch_dq_f32, 64);
#undef PT_VB_DQ_LAUNCH
  return cudaErrorInvalidValue;
}
