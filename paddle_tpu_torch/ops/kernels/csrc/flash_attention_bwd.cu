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
// dV, dK), ~0.55 TFLOP, and dQ 6*D (S, dP, dQ), ~0.41 TFLOP; each moves
// well under 1 GB. Both are operations bound: 0.556 and 0.417 ms at 989
// TFLOP/s.
//
// bf16 (the training path): every product runs on the tensor cores as
// wgmma (sm_90a) with bf16 operands and f32 accumulators in registers.
// dK/dV: grid (B * H, Sk / 128), two warpgroups (256 threads); a block
// keeps its 128 keys of K and V resident in shared memory and streams
// 64-query tiles of Q, dO, LSE and delta through a ring of 2 stages filled
// by 16-byte cp.async, so the next tile's copy overlaps this tile's
// products. Warpgroup w owns keys 64w..64w+63: S^T = K Q^T and dP^T = V
// dO^T [64 x 64] are m64n64k16 products with both operands in shared
// memory; p_used^T and dS^T are formed in registers, rounded to bf16 and
// fed back as the register A operand of dV += p_used^T dO and dK += dS^T Q
// (m64nDk16), whose B operand is MN-major (the instruction's transpose
// bit). dQ: grid (B * H, Sq / 128); a block keeps 128 queries of Q and dO
// resident and streams 64-key tiles of K, V and the bias the same way, and
// dQ += dS K takes dS from registers. Tiles sit in shared memory in the
// 128-byte swizzled layout that wgmma's descriptors name (common.cuh). No
// block writes another block's rows: no atomics, the same bits every run.
// Causal blocks take the tile index so that the blocks with the most tiles
// start first. Shared memory 130 KiB a block at D = 128, 66 KiB at D = 64.
// The bf16 kernels take Sq and Sk multiples of 128 (Sq == Sk when causal)
// and 16-byte aligned tensors; the entry points refuse anything else with
// cudaErrorInvalidValue. ptxas -v (CUDA 12.8, sm_90a): dK/dV 255 registers
// at D = 128 and 201 at D = 64, dQ 191 and 165; no spills, no stack.
//
// f32 (the card-vs-CPU parity): the products run on the CUDA cores in f32
// (tensor cores would round them to TF32). dK/dV: grid (ceil(Sk / 64), H,
// B), 256 threads; a block owns one 64-key tile (K, V in shared memory as
// f32, dK and dV accumulated in f32 registers, 4 keys x D/16 columns a
// thread) and loops over the 64-row Q tiles from the causal lower bound
// k0 / 64, forming S^T and dP^T [64 keys x 64 queries] in one pass over D.
// dQ: grid (ceil(Sq / 64), H, B); a block owns one 64-row Q tile (Q, dO in
// shared memory, dQ in registers) and loops over KV tiles up to its
// diagonal. Ragged lengths are masked in the kernels.
#include <math.h>

#include "attention_tiles.cuh"

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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * Smem<D>::kStride + d] =
        r0 + r < rows ? src[static_cast<int64_t>(r0 + r) * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ kbias,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Sk, int causal, float scale,
                         int dropout, uint32_t seed, uint32_t thresh,
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

  load_tile<D>(sK, k + koff * D, k0, Sk);
  load_tile<D>(sV, v + koff * D, k0, Sk);

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
        sP[r * S::kTStride + cl] = p_used;
        sDS[r * S::kTStride + cl] = ds;
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
      dk[base + tx + kColGroups * c] = acc_dk[i][c];
      dv[base + tx + kColGroups * c] = acc_dv[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ kbias,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Sq, int Sk,
                        int causal, float scale, int dropout, uint32_t seed,
                        uint32_t thresh, float inv_keep) {
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

  load_tile<D>(sQ, q + qoff * D, q0, Sq);
  load_tile<D>(sDO, dout + qoff * D, q0, Sq);

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
    load_tile<D>(sK, k + koff * D, k0, Sk);
    load_tile<D>(sV, v + koff * D, k0, Sk);
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
        sDS[(ty * kRowsPerThread + i) * S::kTStride + cl] = ds;
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
                           const void* dout, const void* kbias,
                           const void* lse, const void* delta, void* dk,
                           void* dv, int B, int H, int Sq, int Sk, int causal,
                           float scale, int dropout, uint32_t seed,
                           uint32_t thresh, float inv_keep,
                           cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_f32_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sk, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(kbias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Sq, Sk, causal, scale, dropout, seed,
      thresh, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* kbias, const void* lse,
                          const void* delta, void* dq, int B, int H, int Sq,
                          int Sk, int causal, float scale, int dropout,
                          uint32_t seed, uint32_t thresh, float inv_keep,
                          cudaStream_t stream) {
  auto kernel = flash_bwd_dq_f32_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sq, kTile), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(kbias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, Sq, Sk,
      causal, scale, dropout, seed, thresh, inv_keep);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------
namespace tc {

// the shared tile helpers (attention_tiles.cuh)
using pt::tc::bf16;
using pt::tc::finish;
using pt::tc::kAcc;
using pt::tc::kCols;
using pt::tc::kRows;
using pt::tc::kStages;
using pt::tc::kThreads;
using pt::tc::load_async;
using pt::tc::load_vec_async;
using pt::tc::product_acc;
using pt::tc::product_nt;
using pt::tc::store_rows;

// Shared memory: the two resident tiles, then kStages stages, each two
// streamed tiles and two f32 vectors of kCols (lse and delta; the bias),
// every tile on a 1024-byte boundary (the swizzle atom).
template <int D>
struct Smem {
  static constexpr int kRes = kRows * D;    // elements of a resident tile
  static constexpr int kStr = kCols * D;    // elements of a streamed tile
  static constexpr int kStageBytes =
      (2 * kStr * 2 + 2 * kCols * 4 + 1023) / 1024 * 1024;
  static constexpr size_t kBytes = 2 * kRes * 2 + kStages * kStageBytes;
};

// dK/dV. grid (B * H, Sk / 128): a block owns 128 keys (K, V resident),
// warpgroup w keys 64w..64w+63, and streams 64-query tiles of Q, dO, LSE
// and delta from the causal lower bound. Per tile a warpgroup forms S^T and
// dP^T [64 keys x 64 queries] on the tensor cores, turns them into p_used^T
// and dS^T in registers, and feeds them as the A operand of dV +=
// p_used^T dO and dK += dS^T Q (dO and Q MN-major). Key tile 0 has the most
// query tiles under causal: blockIdx.y = 0 starts first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ kbias,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     float scale, int dropout, uint32_t seed, uint32_t thresh,
                     float inv_keep) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + S::kRes;
  unsigned char* ring = smem_raw + 2 * S::kRes * 2;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 7) * 64;   // the warpgroup's rows of sK, sV
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * kRows;
  const int64_t qoff = static_cast<int64_t>(bh) * Sq;
  const int64_t koff = static_cast<int64_t>(bh) * Sk;
  const int n_qt = Sq / kCols;
  const int i_begin = causal ? k0 / kCols : 0;

  auto stage_q = [&](int it) {
    return reinterpret_cast<bf16*>(ring + ((it - i_begin) % kStages) *
                                              S::kStageBytes);
  };
  auto load_stage = [&](int it) {
    bf16* sQ = stage_q(it);
    bf16* sDO = sQ + S::kStr;
    float* vec = reinterpret_cast<float*>(sDO + S::kStr);
    const int64_t r = qoff + static_cast<int64_t>(it) * kCols;
    load_async<D, kCols>(sQ, q + r * D);
    load_async<D, kCols>(sDO, dout + r * D);
    load_vec_async(vec, lse + r, 0);
    load_vec_async(vec + kCols, delta + r, kCols / 4);
  };

  load_async<D, kRows>(sK, k + (koff + k0) * D);
  load_async<D, kRows>(sV, v + (koff + k0) * D);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (i_begin + s < n_qt) load_stage(i_begin + s);
    pt::cp_async_commit();
  }

  // this lane's keys: key_lo and key_lo + 8
  const int key_lo = k0 + r0 + ((threadIdx.x >> 5) & 3) * 16 + g;
  const float bias_lo = kbias != nullptr ? kbias[b * Sk + key_lo] : 0.f;
  const float bias_hi = kbias != nullptr ? kbias[b * Sk + key_lo + 8] : 0.f;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int it = i_begin; it < n_qt; ++it) {
    pt::cp_async_wait<kStages - 2>();
    pt::fence_proxy_async();
    __syncthreads();  // tile it has landed; tile it - 1 is consumed
    if (it + kStages - 1 < n_qt) load_stage(it + kStages - 1);
    pt::cp_async_commit();

    // A warpgroup whose keys all follow the tile's last query (the upper
    // half of the diagonal tile) runs it all the same, masked to zero: a
    // branch on the warpgroup index would serialize the wgmma pipeline.
    const int q0 = it * kCols;
    const bf16* sQ = stage_q(it);
    const bf16* sDO = sQ + S::kStr;
    const float* sLse = reinterpret_cast<const float*>(sDO + S::kStr);
    const float* sDelta = sLse + kCols;

    float st[kAcc], dpt[kAcc];  // S^T, dP^T [64 keys x 64 queries]
    product_nt<D>(st, sK, sQ, r0);
    product_nt<D>(dpt, sV, sDO, r0);
    finish(st, dpt);

    // st <- p_used^T, dpt <- dS^T (element 4j + e: key lo + 8 (e / 2),
    // query column 8j + 2t + e % 2). The causal mask selects after exp
    // instead of branching around it: a branch per element serializes the
    // 32 exps of a thread (1.5x slower on the card).
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = i & 3;
      const int col = (i >> 2) * 8 + 2 * t + (e & 1);
      const int qi = q0 + col;
      const int ki = key_lo + ((e >> 1) << 3);
      const float ex =
          expf(st[i] * scale + (e < 2 ? bias_lo : bias_hi) - sLse[col]);
      const float p = causal && qi < ki ? 0.f : ex;
      float dp = dpt[i];
      float p_used = p;
      if (dropout) {
        const bool keep = pt::dropout_keep(
            seed, static_cast<uint32_t>(bh), static_cast<uint32_t>(qi),
            static_cast<uint32_t>(ki), thresh);
        p_used = keep ? p * inv_keep : 0.f;
        dp = keep ? dp * inv_keep : 0.f;
      }
      st[i] = p_used;
      dpt[i] = p * (dp - sDelta[col]) * scale;
    }
    product_acc<D>(acc_dv, st, sDO);   // dV += p_used^T dO
    product_acc<D>(acc_dk, dpt, sQ);   // dK += dS^T Q
    finish(acc_dv, acc_dk);
  }
  pt::cp_async_wait<0>();

  store_rows<D>(dk, koff + key_lo, acc_dk, t);
  store_rows<D>(dv, koff + key_lo, acc_dv, t);
}

// dQ. grid (B * H, Sq / 128): a block owns 128 queries (Q, dO resident;
// warpgroup w rows 64w..64w+63) and streams 64-key tiles of K, V and the
// bias up to its diagonal. Per tile a warpgroup forms S and dP [64 queries
// x 64 keys], turns them into dS in registers and feeds it as the A
// operand of dQ += dS K (K MN-major). Under causal the last query tile has
// the most key tiles: blockIdx.y = 0 takes it.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ kbias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, float scale,
                    int dropout, uint32_t seed, uint32_t thresh,
                    float inv_keep) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + S::kRes;
  unsigned char* ring = smem_raw + 2 * S::kRes * 2;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 7) * 64;   // the warpgroup's rows of sQ, sDO
  const int bh = blockIdx.x, b = bh / H;
  const int n_qt = Sq / kRows;
  const int q0 = (causal ? n_qt - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int64_t qoff = static_cast<int64_t>(bh) * Sq;
  const int64_t koff = static_cast<int64_t>(bh) * Sk;
  const int j_end = causal ? (q0 + kRows) / kCols : Sk / kCols;
  const bool has_bias = kbias != nullptr;

  auto stage_k = [&](int j) {
    return reinterpret_cast<bf16*>(ring + (j % kStages) * S::kStageBytes);
  };
  auto load_stage = [&](int j) {
    bf16* sK = stage_k(j);
    bf16* sV = sK + S::kStr;
    float* vec = reinterpret_cast<float*>(sV + S::kStr);
    const int64_t r = koff + static_cast<int64_t>(j) * kCols;
    load_async<D, kCols>(sK, k + r * D);
    load_async<D, kCols>(sV, v + r * D);
    if (has_bias) load_vec_async(vec, kbias + b * Sk + j * kCols, 0);
  };

  load_async<D, kRows>(sQ, q + (qoff + q0) * D);
  load_async<D, kRows>(sDO, dout + (qoff + q0) * D);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < j_end) load_stage(s);
    pt::cp_async_commit();
  }

  // this lane's queries: row_lo and row_lo + 8
  const int row_lo = q0 + r0 + ((threadIdx.x >> 5) & 3) * 16 + g;
  const float lse_lo = lse[qoff + row_lo], lse_hi = lse[qoff + row_lo + 8];
  const float dl_lo = delta[qoff + row_lo], dl_hi = delta[qoff + row_lo + 8];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < j_end; ++j) {
    pt::cp_async_wait<kStages - 2>();
    pt::fence_proxy_async();
    __syncthreads();  // tile j has landed; tile j - 1 is consumed
    if (j + kStages - 1 < j_end) load_stage(j + kStages - 1);
    pt::cp_async_commit();

    const int k0 = j * kCols;
    const bf16* sK = stage_k(j);
    const bf16* sV = sK + S::kStr;
    const float* sBias = reinterpret_cast<const float*>(sV + S::kStr);

    float s[kAcc], dp[kAcc];  // S, dP [64 queries x 64 keys]
    product_nt<D>(s, sQ, sK, r0);
    product_nt<D>(dp, sDO, sV, r0);
    finish(s, dp);

    // s <- dS (the causal mask selects after exp, as in dK/dV)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = i & 3;
      const int col = (i >> 2) * 8 + 2 * t + (e & 1);
      const int ki = k0 + col;
      const int qi = row_lo + ((e >> 1) << 3);
      const float ex = expf(s[i] * scale + (has_bias ? sBias[col] : 0.f) -
                            (e < 2 ? lse_lo : lse_hi));
      const float p = causal && qi < ki ? 0.f : ex;
      float dpe = dp[i];
      if (dropout)
        dpe = pt::dropout_keep(seed, static_cast<uint32_t>(bh),
                               static_cast<uint32_t>(qi),
                               static_cast<uint32_t>(ki), thresh)
                  ? dpe * inv_keep
                  : 0.f;
      s[i] = p * (dpe - (e < 2 ? dl_lo : dl_hi)) * scale;
    }
    product_acc<D>(acc, s, sK);  // dQ += dS K
    finish(acc);
  }
  pt::cp_async_wait<0>();

  store_rows<D>(dq, qoff + row_lo, acc, t);
}

// Shapes the bf16 kernels take: whole tiles, causal square.
inline bool shape_ok(int Sq, int Sk, int causal) {
  return Sq > 0 && Sk > 0 && Sq % kRows == 0 && Sk % kRows == 0 &&
         (!causal || Sq == Sk);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* kbias, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int causal, float scale, int dropout,
                       uint32_t seed, uint32_t thresh, float inv_keep,
                       cudaStream_t stream) {
  if (!shape_ok(Sq, Sk, causal)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, Sk / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(kbias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, causal, scale, dropout, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* kbias, const void* lse,
                      const void* delta, void* dq, int B, int H, int Sq,
                      int Sk, int causal, float scale, int dropout,
                      uint32_t seed, uint32_t thresh, float inv_keep,
                      cudaStream_t stream) {
  if (!shape_ok(Sq, Sk, causal)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, Sq / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(kbias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Sq, Sk,
      causal, scale, dropout, seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace tc


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
  if (dtype == pt::kBFloat16 &&
      !pt::tc::aligned16({q, k, v, dout, kbias, lse, delta, dk, dv}))
    return cudaErrorInvalidValue;
  if (dtype == pt::kBFloat16 && D == 128)
    return tc::launch_dkv<128>(q, k, v, dout, kbias, lse, delta, dk, dv, B,
                               H, Sq, Sk, causal, scale, dropout, seed,
                               thresh, inv_keep, s);
  if (dtype == pt::kBFloat16 && D == 64)
    return tc::launch_dkv<64>(q, k, v, dout, kbias, lse, delta, dk, dv, B, H,
                              Sq, Sk, causal, scale, dropout, seed, thresh,
                              inv_keep, s);
  if (dtype == pt::kFloat32 && D == 128)
    return launch_dkv_f32<128>(q, k, v, dout, kbias, lse, delta, dk, dv, B, H,
                               Sq, Sk, causal, scale, dropout, seed, thresh,
                               inv_keep, s);
  if (dtype == pt::kFloat32 && D == 64)
    return launch_dkv_f32<64>(q, k, v, dout, kbias, lse, delta, dk, dv, B, H,
                              Sq, Sk, causal, scale, dropout, seed, thresh,
                              inv_keep, s);
  return cudaErrorInvalidValue;
}

extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kbias, const void* lse, const void* delta, void* dq, int B,
    int H, int Sq, int Sk, int D, int causal, float scale, int dropout,
    uint32_t seed, uint32_t thresh, float inv_keep, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBFloat16 &&
      !pt::tc::aligned16({q, k, v, dout, kbias, lse, delta, dq}))
    return cudaErrorInvalidValue;
  if (dtype == pt::kBFloat16 && D == 128)
    return tc::launch_dq<128>(q, k, v, dout, kbias, lse, delta, dq, B, H, Sq,
                              Sk, causal, scale, dropout, seed, thresh,
                              inv_keep, s);
  if (dtype == pt::kBFloat16 && D == 64)
    return tc::launch_dq<64>(q, k, v, dout, kbias, lse, delta, dq, B, H, Sq,
                             Sk, causal, scale, dropout, seed, thresh,
                             inv_keep, s);
  if (dtype == pt::kFloat32 && D == 128)
    return launch_dq_f32<128>(q, k, v, dout, kbias, lse, delta, dq, B, H, Sq,
                              Sk, causal, scale, dropout, seed, thresh,
                              inv_keep, s);
  if (dtype == pt::kFloat32 && D == 64)
    return launch_dq_f32<64>(q, k, v, dout, kbias, lse, delta, dq, B, H, Sq,
                             Sk, causal, scale, dropout, seed, thresh,
                             inv_keep, s);
  return cudaErrorInvalidValue;
}
