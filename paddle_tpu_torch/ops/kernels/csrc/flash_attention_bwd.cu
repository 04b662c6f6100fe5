// Flash-attention backward for Hopper (sm_90a): dK/dV, then dQ.
//
// Replace paddle_tpu/ops/pallas/flash_attention.py::_fa_bwd_dkv_kernel and
// ::_fa_bwd_dq_kernel. Inputs q, dO [B, H, Sq, D], k, v [B, H, Sk, D]
// contiguous, the optional key-padding bias [B, Sk] f32, and the forward's
// LSE and delta = rowsum(dO * O) as [B, H, Sq] f32 (plain layout). Both
// kernels recompute P = exp(S * scale + bias - lse), zero it where causal
// masks it, and regenerate the forward's dropout keep bits from the same
// hash (common.cuh); p_used = keep ? P / (1 - p) : 0, dP_eff = keep ?
// dP / (1 - p) : 0 and dS = P * (dP_eff - delta) * scale, with p_used
// rounded to dO's dtype and dS to Q's (K's) dtype before their products,
// as the TPU kernels do.
//
// Bound: at the training shape (B=4, H=16, S=4096, D=128, bf16, causal),
// dK/dV does 8*D operations a causal pair a head (four products: S, dP,
// dV, dK), ~0.56 TFLOP, and dQ 6*D (S, dP, dQ), ~0.42 TFLOP; each moves
// well under 1 GB. Both are operations bound (~0.57 and ~0.42 ms at 989
// TFLOP/s). Like the forward, these kernels run their products on the CUDA
// cores in f32, far below that rate; wgmma and TMA are later work.
//
// Design. dK/dV: grid (ceil(Sk / 64), H, B), 256 threads; a block owns one
// 64-key tile (K, V in shared memory as f32, dK and dV accumulated in f32
// registers, 4 keys x D/16 columns a thread) and loops over the 64-row Q
// tiles from the causal lower bound k0 / 64, forming S^T and dP^T
// [64 keys x 64 queries] in one pass over D. No block writes another's
// keys: no atomics, the same result every run. dQ: grid (ceil(Sq / 64), H,
// B); a block owns one 64-row Q tile (Q, dO in shared memory, dQ in
// registers) and loops over KV tiles up to its diagonal. Ragged lengths are
// masked in the kernels.
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
  static constexpr int kVec = kS + kTile * kTStride;  // lse / bias
  static constexpr int kVec2 = kVec + kTile;          // delta
  static constexpr int kFloats = kVec2 + kTile;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ kbias,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     float scale, int dropout, uint32_t seed, uint32_t thresh,
                     float inv_keep) {
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

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;  // key rows ty*4 .. ty*4+3
  const int tx = tid % kColGroups;  // query columns / D columns tx + 16*c
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int64_t qoff = static_cast<int64_t>(bh) * Sq;
  const int64_t koff = static_cast<int64_t>(bh) * Sk;

  load_tile<T, D>(sK, k + koff * D, k0, Sk);
  load_tile<T, D>(sV, v + koff * D, k0, Sk);

  int key[kRowsPerThread];
  float bias[kRowsPerThread];
  float acc_dk[kRowsPerThread][kOCols], acc_dv[kRowsPerThread][kOCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    key[i] = k0 + ty * kRowsPerThread + i;
    bias[i] = (kbias != nullptr && key[i] < Sk)
                  ? kbias[static_cast<int64_t>(b) * Sk + key[i]]
                  : 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;
  }

  const int n_q = pt::ceil_div(Sq, kTile);
  const int i_begin = causal ? k0 / kTile : 0;
  for (int it = i_begin; it < n_q; ++it) {
    const int q0 = it * kTile;
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
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
        float p = 0.f, p_used = 0.f, ds = 0.f;
        if (qi < Sq && key[i] < Sk && !(causal && qi < key[i])) {
          p = expf(st[i][jj] * scale + bias[i] - sLse[cl]);
          float dp = dpt[i][jj];
          p_used = p;
          if (dropout) {
            const bool keep = pt::dropout_keep(
                seed, static_cast<uint32_t>(bh), static_cast<uint32_t>(qi),
                static_cast<uint32_t>(key[i]), thresh);
            p_used = keep ? p * inv_keep : 0.f;
            dp = keep ? dp * inv_keep : 0.f;
          }
          ds = p * (dp - sDelta[cl]) * scale;
        }
        const int r = ty * kRowsPerThread + i;
        sP[r * S::kTStride + cl] = pt::round_to<T>(p_used);
        sDS[r * S::kTStride + cl] = pt::round_to<T>(ds);
      }
    __syncthreads();

    // dV[key] += sum_q p_used^T[key][q] dO[q]; dK[key] += sum_q dS^T Q[q]
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
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ kbias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, float scale,
                    int dropout, uint32_t seed, uint32_t thresh,
                    float inv_keep) {
  using S = Smem<D>;
  constexpr int kOCols = D / kColGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sQ = sm + S::kA;
  float* sDO = sm + S::kB;
  float* sK = sm + S::kC;
  float* sV = sm + S::kD;
  float* sDS = sm + S::kS;    // [query][key]
  float* sBias = sm + S::kVec;

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;  // query rows ty*4 .. ty*4+3
  const int tx = tid % kColGroups;  // key columns / D columns tx + 16*c
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int64_t qoff = static_cast<int64_t>(bh) * Sq;
  const int64_t koff = static_cast<int64_t>(bh) * Sk;

  load_tile<T, D>(sQ, q + qoff * D, q0, Sq);
  load_tile<T, D>(sDO, dout + qoff * D, q0, Sq);

  int row[kRowsPerThread];
  float row_lse[kRowsPerThread], row_delta[kRowsPerThread];
  float acc[kRowsPerThread][kOCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    row[i] = q0 + ty * kRowsPerThread + i;
    const bool in = row[i] < Sq;
    row_lse[i] = in ? lse[qoff + row[i]] : 0.f;
    row_delta[i] = in ? delta[qoff + row[i]] : 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.f;
  }

  int j_end = pt::ceil_div(Sk, kTile);
  if (causal) {
    const int through_diag = pt::ceil_div(q0 + kTile, kTile);
    if (through_diag < j_end) j_end = through_diag;
  }
  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's K, V, dS and bias are consumed
    load_tile<T, D>(sK, k + koff * D, k0, Sk);
    load_tile<T, D>(sV, v + koff * D, k0, Sk);
    for (int c = tid; c < kTile; c += kThreads)
      sBias[c] = (kbias != nullptr && k0 + c < Sk)
                     ? kbias[static_cast<int64_t>(b) * Sk + k0 + c]
                     : 0.f;
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
        const int ki = k0 + cl;
        float ds = 0.f;
        if (row[i] < Sq && ki < Sk && !(causal && row[i] < ki)) {
          const float p = expf(s[i][jj] * scale + sBias[cl] - row_lse[i]);
          float dpe = dp[i][jj];
          if (dropout)
            dpe = pt::dropout_keep(seed, static_cast<uint32_t>(bh),
                                   static_cast<uint32_t>(row[i]),
                                   static_cast<uint32_t>(ki), thresh)
                      ? dpe * inv_keep
                      : 0.f;
          ds = p * (dpe - row_delta[i]) * scale;
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
                       const void* dout, const void* kbias, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int causal, float scale, int dropout,
                       uint32_t seed, uint32_t thresh, float inv_keep,
                       cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sk, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(kbias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, causal, scale, dropout, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* kbias, const void* lse,
                      const void* delta, void* dq, int B, int H, int Sq,
                      int Sk, int causal, float scale, int dropout,
                      uint32_t seed, uint32_t thresh, float inv_keep,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sq, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(kbias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Sq, Sk,
      causal, scale, dropout, seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous; D in {64, 128}; Sq, Sk > 0; kbias [B, Sk] f32 or
// null; lse, delta [B, H, Sq] f32 (checked by the wrapper).
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kbias, const void* lse, const void* delta, void* dk,
    void* dv, int B, int H, int Sq, int Sk, int D, int causal, float scale,
    int dropout, uint32_t seed, uint32_t thresh, float inv_keep, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_FA_DKV_LAUNCH(T, DD)                                             \
  return launch_dkv<T, DD>(q, k, v, dout, kbias, lse, delta, dk, dv, B, H, \
                           Sq, Sk, causal, scale, dropout, seed, thresh,   \
                           inv_keep, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_FA_DKV_LAUNCH(__nv_bfloat16, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_FA_DKV_LAUNCH(__nv_bfloat16, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_FA_DKV_LAUNCH(float, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_FA_DKV_LAUNCH(float, 64);
#undef PT_FA_DKV_LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kbias, const void* lse, const void* delta, void* dq, int B,
    int H, int Sq, int Sk, int D, int causal, float scale, int dropout,
    uint32_t seed, uint32_t thresh, float inv_keep, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_FA_DQ_LAUNCH(T, DD)                                              \
  return launch_dq<T, DD>(q, k, v, dout, kbias, lse, delta, dq, B, H, Sq,  \
                          Sk, causal, scale, dropout, seed, thresh,        \
                          inv_keep, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_FA_DQ_LAUNCH(__nv_bfloat16, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_FA_DQ_LAUNCH(__nv_bfloat16, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_FA_DQ_LAUNCH(float, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_FA_DQ_LAUNCH(float, 64);
#undef PT_FA_DQ_LAUNCH
  return cudaErrorInvalidValue;
}
