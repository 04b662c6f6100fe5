// Paged-KV attention of the serving decode and chunked-prefill steps, for
// Hopper (sm_90a).
//
// Replaces the non-fresh route of paddle_tpu/incubate/nn/functional/
// __init__.py::block_multihead_attention (:733-761), which the TPU package
// leaves to XLA (no Pallas kernel): each token t of batch row b = t2b[t],
// at cache position pos[t], attends its own row's cache positions
// 0..pos[t] (at most max_seq of them) in its kv-head group (GQA: query head
// h reads kv head h / G, G = HQ / HKV). K and V are read from the layer's
// page pool [num_blocks, HKV, block_size, D] through the block table,
// key j of row b at page block_tables[b, j / block_size], slot
// j % block_size; no gathered copy is made. The reference's rounding:
// logits from the cache dtype's operands with f32 accumulation, divided by
// sqrt(D); softmax in f32; the probabilities rounded to the cache dtype
// AFTER normalisation; P V accumulated in f32 and cast to the cache dtype.
// Because P is rounded once normalised, a single online-softmax pass (which
// rounds unnormalised P) would not match: each block makes two passes over
// its keys, the first for the max and the sum (an online pair a thread,
// merged in a fixed order), the second recomputing Q K for the normalised
// P and P V. Nothing is held a key, so the sequence length has no
// shared-memory limit. Padding tokens (the engine's trash row, whose table
// row is all page 0) read page 0; their positions may run past max_seq, and
// their keys stop at max_seq, so no read leaves the pool.
//
// Bound: bytes. A decode token reads its row's pos + 1 keys and values:
// at the flagship decode shape (8 rows at ~20-180 positions, HKV = 8,
// D = 128, bf16) ~1.5 us at 3.35 TB/s; the operations (4 D a key a query
// head) ~0.2 us on the CUDA cores. Design: one block a (token, kv head,
// group of up to 4 of its query heads), 256 threads, CUDA cores. The work
// of a block is a few query vectors against at most max_seq keys: there is
// no tile of 64 rows for a tensor core to fill. A block is bound by its own
// instruction and load latencies (64 blocks at decode), so the work is laid
// out to run few instructions: the logits a key a thread (its row of K
// read in 16-byte loads, q from shared memory), so each instruction of a
// warp serves 32 keys (a group of lanes a key, with shuffle-summed dots,
// served 2); the max and the sum are merged over the warp by shuffles and
// over the warps in a fixed order.
// Pass 2 recomputes the logits the same way, writes P for a chunk of 256
// keys to shared memory, then forms P V with P lanes of a group across D
// (8 elements a lane, 8 P >= D) and the groups across the chunk's keys,
// summed over the groups in shared memory in a fixed order: the same bits
// every run. The row's block table is copied to shared memory once, so a
// key costs one dependent load, not two.
#include <cmath>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kTable = 256;      // block-table entries a block keeps shared

// 8 consecutive elements of T as loaded (16 bytes of bf16, 32 of f32),
// kept raw until used so that more keys' loads fit in flight.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw<float> {
  float4 a, b;
};

__device__ __forceinline__ Raw<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ Raw<float> load8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float* f) {
  f[0] = r.a.x, f[1] = r.a.y, f[2] = r.a.z, f[3] = r.a.w;
  f[4] = r.b.x, f[5] = r.b.y, f[6] = r.b.z, f[7] = r.b.w;
}

template <typename T>
__device__ __forceinline__ Raw<T> zero_raw() {
  return Raw<T>{};
}

// Merge (m2, l2) into the running (m, l) of an online softmax: l sums
// exp(logit - m) over the keys seen.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // neither has seen a key
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// T: the cache dtype; P: lanes a key in P V; GH: query heads a block
// (1, 2, 4).
template <typename T, int P, int GH>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp, T* __restrict__ out,
                           const int64_t* __restrict__ t2b,
                           const int64_t* __restrict__ pos,
                           const int64_t* __restrict__ bt, int HQ, int HKV,
                           int D, int bs, int max_blocks, float scale_div) {
  constexpr int kSlotsPerWarp = 32 / P;
  constexpr int kSlots = kWarps * kSlotsPerWarp;  // keys a step of P V
  constexpr int U = GH == 4 ? 2 : 4;               // steps in flight
  constexpr int kDp = 8 * P;                       // D padded to the group
  __shared__ float red[kSlots * GH * kDp];
  __shared__ __align__(16) float qs[GH][kMaxD];
  __shared__ float ps[kThreads][GH];
  __shared__ float warp_m[kWarps][GH], warp_l[kWarps][GH];
  __shared__ float row_m[GH], row_l[GH];
  __shared__ int64_t table[kTable];

  const int t = blockIdx.x;
  const int G = HQ / HKV;
  const int groups = (G + GH - 1) / GH;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * G + (blockIdx.y % groups) * GH;  // first query head
  const int nh = min(GH, kvh * G + G - h0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int64_t b = t2b[t];
  const int64_t p = pos[t];
  const int max_seq = max_blocks * bs;
  const int n = p + 1 < max_seq ? static_cast<int>(p + 1) : max_seq;
  // the row's block table in shared memory where it fits (one load of it
  // all, not one dependent load a key)
  const int64_t* row = bt + b * max_blocks;
  const bool shared_table = max_blocks <= kTable;
  if (shared_table)
    for (int i = threadIdx.x; i < max_blocks; i += kThreads) table[i] = row[i];
  for (int i = threadIdx.x; i < GH * D; i += kThreads) {
    const int g = i / D;
    qs[g][i - g * D] =
        g < nh ? pt::to_float(q[(static_cast<size_t>(t) * HQ + h0) * D + i])
               : 0.f;
  }
  const size_t page_stride = static_cast<size_t>(HKV) * bs * D;
  const size_t head_off = static_cast<size_t>(kvh) * bs * D;
  __syncthreads();

  // the element offset of key j's row in the pool
  auto offset = [&](int j) {
    const int64_t page = shared_table ? table[j / bs] : row[j / bs];
    return static_cast<size_t>(page) * page_stride + head_off +
           static_cast<size_t>(j % bs) * D;
  };
  // the logits of key j for the block's query heads, by one thread
  auto logits = [&](int j, float* s) {
    const T* k = kp + offset(j);
#pragma unroll
    for (int g = 0; g < GH; ++g) s[g] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 8) {
      float kf[8];
      unpack(load8(k + c), kf);
#pragma unroll
      for (int g = 0; g < GH; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) s[g] = fmaf(qs[g][c + e], kf[e], s[g]);
    }
#pragma unroll
    for (int g = 0; g < GH; ++g) s[g] = s[g] / scale_div;
  };

  // pass 1: the max and the sum of exp over the keys (a key a thread),
  // merged over the warp, then over the warps in a fixed order
  float m[GH], l[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) m[g] = -INFINITY, l[g] = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float s[GH];
    logits(j, s);
#pragma unroll
    for (int g = 0; g < GH; ++g) merge(m[g], l[g], s[g], 1.f);
  }
#pragma unroll
  for (int g = 0; g < GH; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge(m[g], l[g], __shfl_xor_sync(0xffffffffu, m[g], off),
            __shfl_xor_sync(0xffffffffu, l[g], off));
    if (lane == 0) warp_m[warp][g] = m[g], warp_l[warp][g] = l[g];
  }
  __syncthreads();
  if (threadIdx.x < GH) {
    const int g = threadIdx.x;
    float mx = -INFINITY, sum = 0.f;
    for (int w = 0; w < kWarps; ++w) merge(mx, sum, warp_m[w][g], warp_l[w][g]);
    row_m[g] = mx;
    row_l[g] = sum;
  }
  __syncthreads();
  float mx[GH], sum[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) mx[g] = row_m[g], sum[g] = row_l[g];

  // pass 2, a chunk of kThreads keys at a time: the normalised P, rounded
  // to T (a key a thread, into shared memory), then P V with the P lanes
  // of a group across D and the groups (slots) across the chunk's keys
  const int sub = lane / P;
  const int c0 = (lane % P) * 8;  // this lane's 8 elements of D
  const bool has = c0 < D;
  const int slot = warp * kSlotsPerWarp + sub;
  float acc[GH][8];
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kThreads) {
    const int j = k0 + threadIdx.x;
    if (j < n) {
      float s[GH];
      logits(j, s);
#pragma unroll
      for (int g = 0; g < GH; ++g)
        ps[threadIdx.x][g] = pt::round_to<T>(expf(s[g] - mx[g]) / sum[g]);
    }
    __syncthreads();
    const int cn = min(kThreads, n - k0);
    for (int base = slot; base < cn; base += U * kSlots) {
      Raw<T> vr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = base + u * kSlots;
        vr[u] = has && jj < cn ? load8(vp + offset(k0 + jj) + c0)
                               : zero_raw<T>();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = base + u * kSlots;
        if (jj < cn) {
          float vf[8];
          unpack(vr[u], vf);
#pragma unroll
          for (int g = 0; g < GH; ++g) {
            const float pr = ps[jj][g];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      red[(slot * GH + g) * kDp + c0 + e] = acc[g][e];
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int g = i / D;
    const int c = i - g * D;
    float o = 0.f;
    for (int s = 0; s < kSlots; ++s) o += red[(s * GH + g) * kDp + c];
    out[(static_cast<size_t>(t) * HQ + h0 + g) * D + c] =
        pt::from_float<T>(o);
  }
}

template <typename T, int P, int GH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int64_t* t2b, const int64_t* pos, const int64_t* bt,
                   int T_, int HQ, int HKV, int D, int bs, int max_blocks,
                   float scale_div, cudaStream_t s) {
  const int G = HQ / HKV;
  const dim3 grid(T_, HKV * ((G + GH - 1) / GH));
  paged_attention_kernel<T, P, GH><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), t2b, pos, bt, HQ, HKV,
      D, bs, max_blocks, scale_div);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t by_heads(int G, const void* q, const void* k, const void* v,
                     void* out, const int64_t* t2b, const int64_t* pos,
                     const int64_t* bt, int T_, int HQ, int HKV, int D, int bs,
                     int max_blocks, float scale_div, cudaStream_t s) {
  if (G == 1)
    return launch<T, P, 1>(q, k, v, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                           max_blocks, scale_div, s);
  if (G == 2)
    return launch<T, P, 2>(q, k, v, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                           max_blocks, scale_div, s);
  return launch<T, P, 4>(q, k, v, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                         max_blocks, scale_div, s);
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, void* out,
                     const int64_t* t2b, const int64_t* pos, const int64_t* bt,
                     int T_, int HQ, int HKV, int D, int bs, int max_blocks,
                     float scale_div, cudaStream_t s) {
  const int G = HQ / HKV;
  if (D <= 32)
    return by_heads<T, 4>(G, q, k, v, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                          max_blocks, scale_div, s);
  if (D <= 64)
    return by_heads<T, 8>(G, q, k, v, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                          max_blocks, scale_div, s);
  if (D <= 128)
    return by_heads<T, 16>(G, q, k, v, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                           max_blocks, scale_div, s);
  return by_heads<T, 32>(G, q, k, v, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                         max_blocks, scale_div, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// out [T, HQ, D] = paged attention of q [T, HQ, D] over one layer's pools
// k, v [num_blocks, HKV, bs, D] (the cache dtype: pt::kFloat32 or
// pt::kBFloat16), t2b and pos [T] int64, block tables bt [B, max_blocks]
// int64. Refuses (cudaErrorInvalidValue) D not a multiple of 8 or above
// 256, HKV not dividing HQ, a non-positive size, and a pointer that is not
// 16-byte aligned.
extern "C" int pt_paged_attention(const void* q, const void* k, const void* v,
                                  void* out, const void* t2b, const void* pos,
                                  const void* bt, int T_, int HQ, int HKV,
                                  int D, int bs, int max_blocks, int dtype,
                                  float scale_div, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_ <= 0 || HQ <= 0 || HKV <= 0 || HQ % HKV != 0 || D <= 0 ||
      D % 8 != 0 || D > kMaxD || bs <= 0 || max_blocks <= 0 ||
      !(scale_div > 0.f))
    return cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(out)})
    if (ptr == nullptr || !aligned16(ptr)) return cudaErrorInvalidValue;
  if (t2b == nullptr || pos == nullptr || bt == nullptr)
    return cudaErrorInvalidValue;
  const int64_t* tb = static_cast<const int64_t*>(t2b);
  const int64_t* ps = static_cast<const int64_t*>(pos);
  const int64_t* tab = static_cast<const int64_t*>(bt);
  if (dtype == pt::kBFloat16)
    return by_width<__nv_bfloat16>(q, k, v, out, tb, ps, tab, T_, HQ, HKV, D,
                                   bs, max_blocks, scale_div, s);
  if (dtype == pt::kFloat32)
    return by_width<float>(q, k, v, out, tb, ps, tab, T_, HQ, HKV, D, bs,
                           max_blocks, scale_div, s);
  return cudaErrorInvalidValue;
}
