// Flash-attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fa_kernel. Inputs
// q [B, H, Sq, D], k/v [B, H, Sk, D] contiguous, an optional additive
// key-padding bias [B, Sk] f32 (already clamped to -1e30 by the wrapper).
// Outputs O [B, H, Sq, D] in the input dtype and LSE [B, H, Sq] f32 (plain
// layout; the TPU's 8-sublane copy is gone).
//
// Numerics follow _fa_kernel: the scale folds into the f32 logits, the bias
// is added before the causal mask, the causal mask is -inf and the running
// max starts at -inf, P is rounded to V's dtype before the PV product, the
// dropout keep bit is the hash of the global (q, k) position and
// bh = b * H + h (common.cuh), dropped probabilities still count in l, and
// O = acc / l * 1 / (1 - p). LSE = m + log(l) does not see dropout. A row
// whose visible keys are all padded sees logits of exactly -1e30 (the f32
// sum -1e30 + s rounds to -1e30), so it averages V uniformly over keys
// 0..row (causal) or over all keys, whatever the tiling.
//
// Bound: at the training shape (B=4, H=16, S=4096, D=128, bf16, causal) the
// function moves ~0.27 GB (q, k, v, O, LSE: ~80 us at 3.35 TB/s) and does
// 4*D operations a causal pair a head, ~0.28 TFLOP (~0.28 ms at 989
// TFLOP/s on the tensor cores): operations bound. This kernel runs its
// products on the CUDA cores in f32 (bf16 x bf16 products are exact in f32,
// so the sums are those of a bf16-in/f32-accumulate product), far below
// the tensor cores' rate: wgmma, TMA and warp specialisation are later work.
//
// Design: grid (ceil(Sq / 64), H, B), 256 threads. A block keeps its 64-row
// Q tile in shared memory as f32 and streams 64-key K/V tiles (and their
// bias) through shared memory; each thread owns 4 query rows by 4 (S) or
// D/16 (O) columns, keeps the online-softmax m, l and the O accumulator in
// f32 registers, and reduces row statistics across the 16 threads of a row
// by warp shuffles. Causal blocks stop at their diagonal tile. Nothing
// carries between blocks. Ragged Sq and Sk are masked in the kernel.
#include <math.h>

#include "common.cuh"

namespace {

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
  static constexpr int kBias = kP + kBlockQ * kPStride;
  static constexpr int kFloats = kBias + kBlockK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kbias,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                 int Sk, int causal, float scale, int dropout, uint32_t seed,
                 uint32_t thresh, float inv_keep) {
  using S = Smem<D>;
  constexpr int kOCols = D / kColGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sQ = sm + S::kQ;
  float* sK = sm + S::kK;
  float* sV = sm + S::kV;
  float* sP = sm + S::kP;
  float* sBias = sm + S::kBias;

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid % kColGroups;  // columns tx, tx+16, ...
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const T* qb = q + static_cast<int64_t>(bh) * Sq * D;
  const T* kb = k + static_cast<int64_t>(bh) * Sk * D;
  const T* vb = v + static_cast<int64_t>(bh) * Sk * D;
  const float* bb = kbias != nullptr ? kbias + static_cast<int64_t>(b) * Sk
                                     : nullptr;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    sQ[r * S::kQStride + d] =
        q0 + r < Sq ? pt::to_float(qb[static_cast<int64_t>(q0 + r) * D + d])
                    : 0.f;
  }

  int row[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kOCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    row[i] = q0 + ty * kRowsPerThread + i;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.f;
  }

  int j_end = pt::ceil_div(Sk, kBlockK);
  if (causal) {
    const int through_diag = pt::ceil_div(q0 + kBlockQ, kBlockK);
    if (through_diag < j_end) j_end = through_diag;
  }

  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's K, V, P and bias are consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const bool in = k0 + c < Sk;
      const int64_t off = static_cast<int64_t>(k0 + c) * D + d;
      sK[c * S::kKStride + d] = in ? pt::to_float(kb[off]) : 0.f;
      sV[c * D + d] = in ? pt::to_float(vb[off]) : 0.f;
    }
    for (int c = tid; c < kBlockK; c += kThreads)
      sBias[c] = (bb != nullptr && k0 + c < Sk) ? bb[k0 + c] : 0.f;
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
        float val = s[i][jj] * scale + sBias[cl];
        if (col >= Sk || (causal && row[i] < col)) val = -INFINITY;
        s[i][jj] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key yet keeps m = -inf: exponentiate
      // against 0 so that exp(-inf - -inf) never makes a NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = tx + kColGroups * jj;
        float p = expf(s[i][jj] - m_use);
        rs += p;
        if (dropout &&
            !pt::dropout_keep(seed, static_cast<uint32_t>(bh),
                              static_cast<uint32_t>(row[i]),
                              static_cast<uint32_t>(k0 + cl), thresh))
          p = 0.f;
        sP[(ty * kRowsPerThread + i) * S::kPStride + cl] = pt::round_to<T>(p);
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
  }

  T* ob = o + static_cast<int64_t>(bh) * Sq * D;
  float* lb = lse + static_cast<int64_t>(bh) * Sq;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (row[i] >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) {
      float out = acc[i][c] / l[i];
      if (dropout) out *= inv_keep;
      ob[static_cast<int64_t>(row[i]) * D + tx + kColGroups * c] =
          pt::from_float<T>(out);
    }
    if (tx == 0) lb[row[i]] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kbias, void* o, void* lse, int B, int H,
                   int Sq, int Sk, int causal, float scale, int dropout,
                   uint32_t seed, uint32_t thresh, float inv_keep,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sq, kBlockQ), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kbias),
      static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk, causal, scale,
      dropout, seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous; D in {64, 128}; Sq, Sk > 0; kbias [B, Sk] f32 or
// null (checked by the wrapper). dropout != 0 applies the hash keep mask
// with threshold thresh and scales O by inv_keep.
extern "C" int pt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kbias, void* o,
    void* lse, int B, int H, int Sq, int Sk, int D, int causal, float scale,
    int dropout, uint32_t seed, uint32_t thresh, float inv_keep, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_FA_FWD_LAUNCH(T, DD)                                              \
  return launch<T, DD>(q, k, v, kbias, o, lse, B, H, Sq, Sk, causal, scale, \
                       dropout, seed, thresh, inv_keep, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_FA_FWD_LAUNCH(__nv_bfloat16, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_FA_FWD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_FA_FWD_LAUNCH(float, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_FA_FWD_LAUNCH(float, 64);
#undef PT_FA_FWD_LAUNCH
  return cudaErrorInvalidValue;
}
