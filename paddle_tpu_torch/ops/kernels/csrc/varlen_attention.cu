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
// Bound: at the serving fresh-prefill shape (T=256, HQ=16, HKV=8, D=128,
// bf16) the function moves ~3.2 MB (~0.95 us at 3.35 TB/s) and does
// ~0.27 GFLOP of causal work (~0.27 us at 989 TFLOP/s): bytes bound, and
// far below either bound this simple kernel is launch and latency bound.
//
// Design: grid (ceil(Tq / 64), H, B), 256 threads. A block keeps its 64-row
// Q tile in shared memory as f32 and streams 64-key K/V tiles through
// shared memory; each thread owns 4 query rows by 4 (S) or D/16 (O)
// columns, keeps the online-softmax m, l and the O accumulator in f32
// registers, and reduces row statistics across the 16 threads of a row by
// warp shuffles. The products run on the CUDA cores in f32; P is rounded
// to the input dtype before the PV product, as _vfa_kernel does. Causal
// blocks stop at their diagonal tile; only when a row of the block has no
// valid key yet does the block go on to the TPU kernel's bound, so that
// the row's uniform average matches. Ragged Tq and Tk are masked in the
// kernel: any length works. Tensor cores (wgmma), TMA and a pipelined
// K/V ring are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // 16 row groups x 4 rows = kBlockQ
constexpr int kColGroups = 16;     // threads sharing one row group
constexpr float kMaskMin = -1e30f;  // ops/pallas/flash_attention.py:58

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

__device__ __forceinline__ int key_end(int q0, int Tk, int causal,
                                       int bound_bq, int bound_bk) {
  if (!causal) return Tk;
  const int end = pt::ceil_div((q0 / bound_bq + 1) * bound_bq, bound_bk) *
                  bound_bk;
  return end < Tk ? end : Tk;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
varlen_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ segq,
                  const int* __restrict__ segk, T* __restrict__ o,
                  float* __restrict__ lse, int H, int HKV, int Tq, int Tk,
                  int causal, int bound_bq, int bound_bk, float scale) {
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
  const T* qb = q + (static_cast<int64_t>(b) * H + h) * Tq * D;
  const T* kb = k + (static_cast<int64_t>(b) * HKV + kvh) * Tk * D;
  const T* vb = v + (static_cast<int64_t>(b) * HKV + kvh) * Tk * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    sQ[r * S::kQStride + d] =
        q0 + r < Tq ? pt::to_float(qb[static_cast<int64_t>(q0 + r) * D + d])
                    : 0.f;
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
      sK[c * S::kKStride + d] = in ? pt::to_float(kb[off]) : 0.f;
      sV[c * D + d] = in ? pt::to_float(vb[off]) : 0.f;
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
            pt::round_to<T>(p);
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

  T* ob = o + (static_cast<int64_t>(b) * H + h) * Tq * D;
  float* lb = lse + (static_cast<int64_t>(b) * H + h) * Tq;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (row[i] >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOCols; ++c)
      ob[static_cast<int64_t>(row[i]) * D + tx + kColGroups * c] =
          pt::from_float<T>(acc[i][c] / l_safe);
    if (tx == 0) lb[row[i]] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* segq, const void* segk, void* o, void* lse,
                   int B, int H, int HKV, int Tq, int Tk, int causal,
                   int bound_bq, int bound_bk, float scale,
                   cudaStream_t stream) {
  auto kernel = varlen_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Tq, kBlockQ), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(segq),
      static_cast<const int*>(segk), static_cast<T*>(o),
      static_cast<float*>(lse), H, HKV, Tq, Tk, causal, bound_bq, bound_bk,
      scale);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous; D in {64, 128}; Tq, Tk > 0; HKV divides H;
// bound_bq, bound_bk > 0 and multiples of 64 (checked by the wrapper).
extern "C" int pt_varlen_attention_fwd(
    const void* q, const void* k, const void* v, const void* segq,
    const void* segk, void* o, void* lse, int B, int H, int HKV, int Tq,
    int Tk, int D, int causal, int bound_bq, int bound_bk, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_VARLEN_LAUNCH(T, DD)                                            \
  return launch<T, DD>(q, k, v, segq, segk, o, lse, B, H, HKV, Tq, Tk,   \
                       causal, bound_bq, bound_bk, scale, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_VARLEN_LAUNCH(__nv_bfloat16, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_VARLEN_LAUNCH(__nv_bfloat16, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_VARLEN_LAUNCH(float, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_VARLEN_LAUNCH(float, 64);
#undef PT_VARLEN_LAUNCH
  return cudaErrorInvalidValue;
}
