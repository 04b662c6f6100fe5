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
// TFLOP/s on the tensor cores): operations bound.
//
// bf16 (the training path): both products run on the tensor cores as
// wgmma (sm_90a), bf16 operands and f32 accumulators in registers, with the
// tile helpers of attention_tiles.cuh. Grid (B * H, Sq / 128), two
// warpgroups (256 threads): a block keeps 128 queries of Q resident in
// shared memory (warpgroup w rows 64w..64w+63) and streams 64-key tiles of
// K, V and the bias through a ring of 2 stages filled by 16-byte cp.async,
// so the next tile's copy overlaps this tile's products. Per tile a
// warpgroup forms S [64 x 64] = Q K^T from two swizzled shared-memory
// operands, takes the online softmax on the accumulator layout (a lane
// holds rows g and g + 8 and 16 columns of each, so a row's max and sum
// reduce over the 4 lanes of a quad, and each lane keeps its own share of
// l until the end), rescales its O accumulator, rounds P to bf16 in
// registers and feeds it as the A operand of O += P V (V MN-major). exp is
// 2^x on the MUFU (ex2.approx); the causal -inf is selected into the
// logits, and only on the tiles that reach the block's diagonal: no branch
// around an exp. Causal blocks stop at their diagonal tile; the upper half
// of the diagonal runs masked for warpgroup 0 (a branch on the warpgroup
// index would serialize the wgmma pipeline), and blockIdx.y = 0 takes the
// last query tile, which has the most key tiles. Without bias and dropout
// (the training path) the kernel is held to 128 registers a thread, so two
// blocks share an SM and one block's softmax overlaps the other's products
// (at the training shape two blocks beat one block without the limit
// although ptxas reports spills and a serialization for want of registers:
// a lone block's tensor cores wait through every softmax). Leaving the bias
// and dropout code out of that instantiation saves ~0.12 ms a launch at the
// training shape, ~3.4 ms of a training step. No block writes another
// block's rows: the same bits every run. Shared memory 98 KiB a block at
// D = 128, 50 KiB at D = 64. The bf16 kernel takes Sq and Sk multiples of
// 128 (Sq == Sk when causal) and 16-byte aligned tensors; the entry point
// refuses anything else with cudaErrorInvalidValue.
//
// f32 (the card-vs-CPU parity): the products run on the CUDA cores in f32
// (tensor cores would round them to TF32). Grid (ceil(Sq / 64), H, B), 256
// threads; a block keeps its 64-row Q tile in shared memory as f32 and
// streams 64-key K/V tiles (and their bias) through shared memory; each
// thread owns 4 query rows by 4 (S) or D/16 (O) columns, keeps m, l and the
// O accumulator in f32 registers, and reduces row statistics across the 16
// threads of a row by warp shuffles. Ragged Sq and Sk are masked.
#include <math.h>

#include "attention_tiles.cuh"

namespace {

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
  static constexpr int kBias = kP + kBlockQ * kPStride;
  static constexpr int kFloats = kBias + kBlockK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ kbias, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     int causal, float scale, int dropout, uint32_t seed,
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
  const float* qb = q + static_cast<int64_t>(bh) * Sq * D;
  const float* kb = k + static_cast<int64_t>(bh) * Sk * D;
  const float* vb = v + static_cast<int64_t>(bh) * Sk * D;
  const float* bb = kbias != nullptr ? kbias + static_cast<int64_t>(b) * Sk
                                     : nullptr;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    sQ[r * S::kQStride + d] =
        q0 + r < Sq ? qb[static_cast<int64_t>(q0 + r) * D + d] : 0.f;
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
      sK[c * S::kKStride + d] = in ? kb[off] : 0.f;
      sV[c * D + d] = in ? vb[off] : 0.f;
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
        sP[(ty * kRowsPerThread + i) * S::kPStride + cl] = p;
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

  float* ob = o + static_cast<int64_t>(bh) * Sq * D;
  float* lb = lse + static_cast<int64_t>(bh) * Sq;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (row[i] >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) {
      float out = acc[i][c] / l[i];
      if (dropout) out *= inv_keep;
      ob[static_cast<int64_t>(row[i]) * D + tx + kColGroups * c] = out;
    }
    if (tx == 0) lb[row[i]] = m[i] + logf(l[i]);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* kbias, void* o, void* lse, int B, int H,
                       int Sq, int Sk, int causal, float scale, int dropout,
                       uint32_t seed, uint32_t thresh, float inv_keep,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(pt::ceil_div(Sq, kBlockQ), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(kbias),
      static_cast<float*>(o), static_cast<float*>(lse), H, Sq, Sk, causal,
      scale, dropout, seed, thresh, inv_keep);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
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
using pt::tc::row_max4;
using pt::tc::row_sum4;
using pt::tc::store_rows;

constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: the resident Q tile, then kStages stages, each a K and a
// V tile and kCols floats of bias, every tile on a 1024-byte boundary (the
// swizzle atom).
template <int D>
struct Smem {
  static constexpr int kRes = kRows * D;    // elements of the Q tile
  static constexpr int kStr = kCols * D;    // elements of a K or V tile
  static constexpr int kStageBytes =
      (2 * kStr * 2 + kCols * 4 + 1023) / 1024 * 1024;
  static constexpr size_t kBytes = kRes * 2 + kStages * kStageBytes;
};

// PLAIN: no bias and no dropout (the training path), at most 128 registers
// a thread, two blocks an SM; the general instantiation keeps one block an
// SM.
template <int D, bool PLAIN>
__global__ void __launch_bounds__(kThreads, PLAIN ? 2 : 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ kbias,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                 int Sk, int causal, float scale, int dropout, uint32_t seed,
                 uint32_t thresh, float inv_keep) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + S::kRes * 2;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 7) * 64;   // the warpgroup's rows of sQ
  const int bh = blockIdx.x, b = bh / H;
  const int n_qt = Sq / kRows;
  const int q0 = (causal ? n_qt - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int64_t qoff = static_cast<int64_t>(bh) * Sq;
  const int64_t koff = static_cast<int64_t>(bh) * Sk;
  const int j_end = causal ? (q0 + kRows) / kCols : Sk / kCols;
  const bool has_bias = !PLAIN && kbias != nullptr;

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
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < j_end) load_stage(s);
    pt::cp_async_commit();
  }

  // this lane's queries: row_lo and row_lo + 8; m and this lane's share of
  // l for each
  const int row_lo = q0 + r0 + ((threadIdx.x >> 5) & 3) * 16 + g;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
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

    float s[kAcc];  // S [64 queries x 64 keys], then P
    product_nt<D, true>(s, sQ, sK, r0);
    finish(s);

    // Element 4j + e is row lo + 8 (e / 2), column 8j + 2t + e % 2. The
    // logits are s * scale (+ bias); exp(x - m) is 2^((x - m) log2(e)) by
    // the MUFU. Without a bias the row max is taken over the raw products
    // (scale > 0 commutes with max and with rounding) and the exponent is
    // one FFMA, s * scale log2(e) - m log2(e). The causal -inf is selected in
    // (not branched around an exp), on the tiles that reach the block's
    // diagonal only.
    if (has_bias) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        s[i] = s[i] * scale + sBias[(i >> 2) * 8 + 2 * t + (i & 1)];
    }
    if (causal && k0 + kCols > q0) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int col = (i >> 2) * 8 + 2 * t + (i & 1);
        const int qi = row_lo + ((i >> 1 & 1) << 3);
        s[i] = qi < k0 + col ? -INFINITY : s[i];
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
    const float xs = has_bias ? 1.f : scale;  // the scale not yet applied
    const float mn_lo = fmaxf(m_lo, row_max4(mx_lo) * xs);
    const float mn_hi = fmaxf(m_hi, row_max4(mx_hi) * xs);
    // a row with no visible key yet keeps m = -inf: exponentiate against 0
    // so that exp(-inf - -inf) never makes a NaN
    const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float al_lo = pt::exp2_approx((m_lo - mu_lo) * kLog2e);
    const float al_hi = pt::exp2_approx((m_hi - mu_hi) * kLog2e);
    const float c = xs * kLog2e;
    const float ml_lo = mu_lo * kLog2e, ml_hi = mu_hi * kLog2e;
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const bool hi = i & 2;
      // with a bias a fully padded row's logits are all exactly -1e30:
      // x - m must be 0 exactly there, so subtract before scaling
      const float p =
          has_bias ? pt::exp2_approx((s[i] - (hi ? mu_hi : mu_lo)) * kLog2e)
                   : pt::exp2_approx(fmaf(s[i], c, -(hi ? ml_hi : ml_lo)));
      if (hi)
        rs_hi += p;
      else
        rs_lo += p;
      // dropped probabilities count in l, not in PV
      bool keep = true;
      if (!PLAIN && dropout) {
        const int col = (i >> 2) * 8 + 2 * t + (i & 1);
        keep = pt::dropout_keep(seed, static_cast<uint32_t>(bh),
                                static_cast<uint32_t>(row_lo + (hi ? 8 : 0)),
                                static_cast<uint32_t>(k0 + col), thresh);
      }
      s[i] = keep ? p : 0.f;
    }
    l_lo = l_lo * al_lo + rs_lo;
    l_hi = l_hi * al_hi + rs_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al_hi : al_lo;
    product_acc<D>(acc, s, sV);  // O += P V
    finish(acc);
  }
  pt::cp_async_wait<0>();

  const float lt_lo = row_sum4(l_lo), lt_hi = row_sum4(l_hi);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    float out = acc[i] / ((i & 2) ? lt_hi : lt_lo);
    if (!PLAIN && dropout) out *= inv_keep;
    acc[i] = out;
  }
  store_rows<D>(o, qoff + row_lo, acc, t);
  if (t == 0) {
    lse[qoff + row_lo] = m_lo + logf(lt_lo);
    lse[qoff + row_lo + 8] = m_hi + logf(lt_hi);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kbias, void* o, void* lse, int B, int H,
                   int Sq, int Sk, int causal, float scale, int dropout,
                   uint32_t seed, uint32_t thresh, float inv_keep,
                   cudaStream_t stream) {
  if (Sq <= 0 || Sk <= 0 || Sq % kRows != 0 || Sk % kRows != 0 ||
      (causal && Sq != Sk))
    return cudaErrorInvalidValue;
  auto kernel = kbias == nullptr && !dropout ? flash_fwd_kernel<D, true>
                                             : flash_fwd_kernel<D, false>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, Sq / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(kbias),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Sq, Sk, causal,
      scale, dropout, seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace tc

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
  if (dtype == pt::kBFloat16 && !pt::tc::aligned16({q, k, v, kbias, o}))
    return cudaErrorInvalidValue;
#define PT_FA_FWD_LAUNCH(F, DD)                                           \
  return F<DD>(q, k, v, kbias, o, lse, B, H, Sq, Sk, causal, scale,       \
               dropout, seed, thresh, inv_keep, s)
  if (dtype == pt::kBFloat16 && D == 128) PT_FA_FWD_LAUNCH(tc::launch, 128);
  if (dtype == pt::kBFloat16 && D == 64) PT_FA_FWD_LAUNCH(tc::launch, 64);
  if (dtype == pt::kFloat32 && D == 128) PT_FA_FWD_LAUNCH(launch_f32, 128);
  if (dtype == pt::kFloat32 && D == 64) PT_FA_FWD_LAUNCH(launch_f32, 64);
#undef PT_FA_FWD_LAUNCH
  return cudaErrorInvalidValue;
}
