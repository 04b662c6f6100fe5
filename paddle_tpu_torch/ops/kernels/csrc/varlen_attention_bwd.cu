// Varlen (packed, segment-id) flash-attention backward for Hopper (sm_90a):
// dK/dV, then dQ.
//
// Replace paddle_tpu/ops/pallas/varlen_attention.py::_vfa_bwd_dkv_kernel and
// ::_vfa_bwd_dq_kernel. Inputs q, dO [B, H, Sq, D], k, v [B, H, Sk, D]
// contiguous (H == HKV: the TPU kernels reshape k and v to [B*H, Sk, D]),
// segment ids seg_q [B, Sq] and seg_k [B, Sk] int32 (-1 = padding), and the
// forward's LSE and delta = rowsum(dO * O) as [B, H, Sq] f32. Both kernels
// recompute P = exp(S * scale - lse) where the pair is valid (seg_k ==
// seg_q, seg_k >= 0, and row >= col on packed positions when causal) and
// take P = 0 exactly elsewhere, as the TPU kernels' where(valid, ., 0)
// does: a padding row, a padding key and a row with no valid key get zero
// gradient, whatever their LSE (this is not the flash backward's -1e30
// bias, under which a fully padded row keeps P = 1). dS = P * (dP - delta)
// * scale; P is rounded to dO's dtype before dV += P^T dO and dS to Q's (K's)
// dtype before dK += dS^T Q (dQ += dS K), as the TPU kernels do.
//
// Bound: at the packed-training shape (B=1, H=16, T=16384 packed from ~14
// documents, D=128, bf16, causal) the within-segment causal pairs are ~13%
// of the causal triangle; dK/dV does 8*D operations a pair a head (S, dP,
// dV, dK) and dQ 6*D (S, dP, dQ), each under 0.5 ms at 989 TFLOP/s, and
// each moves ~30 MB: operations bound. These kernels run their products on
// the CUDA cores in f32, far below the tensor cores' rate; wgmma and TMA are
// later work.
//
// Design, as csrc/flash_attention_bwd.cu. dK/dV: grid (ceil(Sk / 64), H,
// B), 256 threads; a block owns one 64-key tile (K, V in shared memory as
// f32, dK and dV accumulated in f32 registers, 4 keys x D/16 columns a
// thread) and loops over the 64-row Q tiles from the causal lower bound
// k0 / 64. dQ: grid (ceil(Sq / 64), H, B); a block owns one 64-row Q tile
// and loops over KV tiles up to its diagonal. No block writes another's
// rows: no atomics, the same bits every run. Tile skip (exact): a block
// keeps the range [lo, hi] of its own tile's non-negative segment ids; a
// tile of the other side none of whose segment ids falls in that range
// cannot hold a valid pair, so P is 0 on all of it and the block skips it
// (one __syncthreads_or over the 64 ids, which is also the loop's barrier).
// In a packed batch most causal tile pairs lie across documents.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * Smem<D>::kStride + d] =
        r0 + r < rows ? pt::to_float(src[static_cast<int64_t>(r0 + r) * D + d])
                      : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const int* __restrict__ segq,
                      const int* __restrict__ segk,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk, int causal,
                      float scale) {
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
  load_tile<T, D>(sK, k + koff * D, k0, Sk);
  load_tile<T, D>(sV, v + koff * D, k0, Sk);

  const int n_q = pt::ceil_div(Sq, kTile);
  const int i_begin = causal ? k0 / kTile : 0;
  for (int it = i_begin; it < n_q; ++it) {
    const int q0 = it * kTile;
    int my_seg;
    // also the barrier: the previous tile's Q, dO, P, dS and ids (and, on
    // the first pass, the key ids read above) are consumed
    if (!tile_overlaps(segq_b, q0, Sq, lo, hi, &my_seg)) continue;
    if (tid < kTile) sSeg[tid] = my_seg;
    load_tile<T, D>(sQ, q + qoff * D, q0, Sq);
    load_tile<T, D>(sDO, dout + qoff * D, q0, Sq);
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
        sP[r * S::kTStride + cl] = pt::round_to<T>(p);
        sDS[r * S::kTStride + cl] = pt::round_to<T>(ds);
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
      dk[base + tx + kColGroups * c] = pt::from_float<T>(acc_dk[i][c]);
      dv[base + tx + kColGroups * c] = pt::from_float<T>(acc_dv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const int* __restrict__ segq,
                     const int* __restrict__ segk,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int H, int Sq, int Sk, int causal, float scale) {
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
  load_tile<T, D>(sQ, q + qoff * D, q0, Sq);
  load_tile<T, D>(sDO, dout + qoff * D, q0, Sq);

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
    load_tile<T, D>(sK, k + koff * D, k0, Sk);
    load_tile<T, D>(sV, v + koff * D, k0, Sk);
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
            pt::round_to<T>(ds);
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
      dq[base + tx + kColGroups * c] = pt::from_float<T>(acc[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* segq, const void* segk,
                       const void* lse, const void* delta, void* dk,
                       void* dv, int B, int H, int Sq, int Sk, int causal,
                       float scale, cudaStream_t stream) {
  auto kernel = varlen_bwd_dkv_kernel<T, D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sk, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* segq, const void* segk,
                      const void* lse, const void* delta, void* dq, int B,
                      int H, int Sq, int Sk, int causal, float scale,
                      cudaStream_t stream) {
  auto kernel = varlen_bwd_dq_kernel<T, D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sq, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous; D in {64, 128}; B, H, Sq, Sk > 0; seg_q [B, Sq],
// seg_k [B, Sk] int32; lse, delta [B, H, Sq] f32 (checked by the wrapper).
extern "C" int pt_varlen_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* segq, const void* segk, const void* lse, const void* delta,
    void* dk, void* dv, int B, int H, int Sq, int Sk, int D, int causal,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_VB_DKV_LAUNCH(T, DD)                                            \
  return launch_dkv<T, DD>(q, k, v, dout, segq, segk, lse, delta, dk, dv, \
                           B, H, Sq, Sk, causal, scale, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_VB_DKV_LAUNCH(__nv_bfloat16, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_VB_DKV_LAUNCH(__nv_bfloat16, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_VB_DKV_LAUNCH(float, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_VB_DKV_LAUNCH(float, 64);
#undef PT_VB_DKV_LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" int pt_varlen_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* segq, const void* segk, const void* lse, const void* delta,
    void* dq, int B, int H, int Sq, int Sk, int D, int causal, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_VB_DQ_LAUNCH(T, DD)                                            \
  return launch_dq<T, DD>(q, k, v, dout, segq, segk, lse, delta, dq, B, H, \
                          Sq, Sk, causal, scale, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_VB_DQ_LAUNCH(__nv_bfloat16, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_VB_DQ_LAUNCH(__nv_bfloat16, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_VB_DQ_LAUNCH(float, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_VB_DQ_LAUNCH(float, 64);
#undef PT_VB_DQ_LAUNCH
  return cudaErrorInvalidValue;
}
