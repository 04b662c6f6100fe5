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
//
// Int8 pages (the dynamic int8 cache-KV path, functional/__init__.py:
// 738-746): the pools hold int8 codes with one f32 scale a (page, head,
// slot) in scale pools [num_blocks, HKV, bs]. The reference dequantizes the
// gathered view as (int8 as f32 * s) rounded to the compute dtype (q's)
// BEFORE the products, so each K and V element read here is that same
// value: the code times its slot's scale in f32, rounded to q's dtype.
// Everything after is as above. Those instantiations read 8 codes (8 bytes)
// where the others read 8 elements, plus one scale a key.
#include <cmath>
#include <initializer_list>
#include <type_traits>

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
template <>
struct Raw<int8_t> {
  uint2 u;
};

__device__ __forceinline__ Raw<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ Raw<float> load8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

__device__ __forceinline__ Raw<int8_t> load8(const int8_t* p) {
  return {__ldg(reinterpret_cast<const uint2*>(p))};
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

// 8 elements of K or V as the products take them: the cache's own values,
// or (int8 pages) each code times the slot's scale s in f32, rounded to T,
// q's dtype, as the reference's dequantized view.
template <typename T>
__device__ __forceinline__ void kv_values(const Raw<T>& r, float, float* f) {
  unpack(r, f);
}

template <typename T>
__device__ __forceinline__ void kv_values(const Raw<int8_t>& r, float s,
                                          float* f) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&r.u);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = pt::round_to<T>(static_cast<float>(c[i]) * s);
}

// Merge (m2, l2) into the running (m, l) of an online softmax: l sums
// exp(logit - m) over the keys seen.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // neither has seen a key
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// T: q's and out's dtype; C: the pools' (T, or int8_t with the scale pools
// ksc, vsc); P: lanes a key in P V; GH: query heads a block (1, 2, 4).
template <typename T, typename C, int P, int GH>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const C* __restrict__ kp,
                           const C* __restrict__ vp,
                           const float* __restrict__ ksc,
                           const float* __restrict__ vsc, T* __restrict__ out,
                           const int64_t* __restrict__ t2b,
                           const int64_t* __restrict__ pos,
                           const int64_t* __restrict__ bt, int HQ, int HKV,
                           int D, int bs, int max_blocks, float scale_div) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
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
  __syncthreads();

  // the (page, head, slot) index of key j: its scale's in the scale pool,
  // times D its row's element offset in the pool
  auto slot_of = [&](int j) {
    const int64_t page = shared_table ? table[j / bs] : row[j / bs];
    return (static_cast<size_t>(page) * HKV + kvh) * bs + j % bs;
  };
  // the logits of key j for the block's query heads, by one thread
  auto logits = [&](int j, float* s) {
    const size_t sl = slot_of(j);
    const C* k = kp + sl * D;
    const float ks = kInt8 ? ksc[sl] : 1.f;
#pragma unroll
    for (int g = 0; g < GH; ++g) s[g] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 8) {
      float kf[8];
      kv_values<T>(load8(k + c), ks, kf);
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
      Raw<C> vr[U];
      float vsu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = base + u * kSlots;
        const bool in = has && jj < cn;
        const size_t sl = in ? slot_of(k0 + jj) : 0;
        vr[u] = in ? load8(vp + sl * D + c0) : zero_raw<C>();
        vsu[u] = kInt8 && in ? vsc[sl] : 1.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = base + u * kSlots;
        if (jj < cn) {
          float vf[8];
          kv_values<T>(vr[u], vsu[u], vf);
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

// The pool arguments of a launch: K and V pages of C, and (C int8) their
// scale pools.
template <typename C>
struct Pools {
  const C* k;
  const C* v;
  const float* ks;
  const float* vs;
};

template <typename T, typename C, int P, int GH>
cudaError_t launch(const void* q, const Pools<C>& pl, void* out,
                   const int64_t* t2b, const int64_t* pos, const int64_t* bt,
                   int T_, int HQ, int HKV, int D, int bs, int max_blocks,
                   float scale_div, cudaStream_t s) {
  const int G = HQ / HKV;
  const dim3 grid(T_, HKV * ((G + GH - 1) / GH));
  paged_attention_kernel<T, C, P, GH><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), pl.k, pl.v, pl.ks, pl.vs, static_cast<T*>(out),
      t2b, pos, bt, HQ, HKV, D, bs, max_blocks, scale_div);
  return cudaGetLastError();
}

template <typename T, typename C, int P>
cudaError_t by_heads(int G, const void* q, const Pools<C>& pl, void* out,
                     const int64_t* t2b, const int64_t* pos,
                     const int64_t* bt, int T_, int HQ, int HKV, int D, int bs,
                     int max_blocks, float scale_div, cudaStream_t s) {
  if (G == 1)
    return launch<T, C, P, 1>(q, pl, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                              max_blocks, scale_div, s);
  if (G == 2)
    return launch<T, C, P, 2>(q, pl, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                              max_blocks, scale_div, s);
  return launch<T, C, P, 4>(q, pl, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                            max_blocks, scale_div, s);
}

template <typename T, typename C>
cudaError_t by_width(const void* q, const Pools<C>& pl, void* out,
                     const int64_t* t2b, const int64_t* pos, const int64_t* bt,
                     int T_, int HQ, int HKV, int D, int bs, int max_blocks,
                     float scale_div, cudaStream_t s) {
  const int G = HQ / HKV;
  if (D <= 32)
    return by_heads<T, C, 4>(G, q, pl, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                             max_blocks, scale_div, s);
  if (D <= 64)
    return by_heads<T, C, 8>(G, q, pl, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                             max_blocks, scale_div, s);
  if (D <= 128)
    return by_heads<T, C, 16>(G, q, pl, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                              max_blocks, scale_div, s);
  return by_heads<T, C, 32>(G, q, pl, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                            max_blocks, scale_div, s);
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// The checks both entries share: cudaSuccess when the sizes are valid and
// q, out and the index pointers are set (q and out 16-byte aligned).
cudaError_t check_args(const void* q, const void* out, const void* t2b,
                       const void* pos, const void* bt, int T_, int HQ,
                       int HKV, int D, int bs, int max_blocks,
                       float scale_div) {
  if (T_ <= 0 || HQ <= 0 || HKV <= 0 || HQ % HKV != 0 || D <= 0 ||
      D % 8 != 0 || D > kMaxD || bs <= 0 || max_blocks <= 0 ||
      !(scale_div > 0.f))
    return cudaErrorInvalidValue;
  for (const void* ptr : {q, out})
    if (ptr == nullptr || !aligned(ptr, 16)) return cudaErrorInvalidValue;
  if (t2b == nullptr || pos == nullptr || bt == nullptr)
    return cudaErrorInvalidValue;
  return cudaSuccess;
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
  const cudaError_t bad = check_args(q, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                                     max_blocks, scale_div);
  if (bad != cudaSuccess) return bad;
  for (const void* ptr : {k, v})
    if (ptr == nullptr || !aligned(ptr, 16)) return cudaErrorInvalidValue;
  const int64_t* tb = static_cast<const int64_t*>(t2b);
  const int64_t* ps = static_cast<const int64_t*>(pos);
  const int64_t* tab = static_cast<const int64_t*>(bt);
  if (dtype == pt::kBFloat16) {
    const Pools<__nv_bfloat16> pl{static_cast<const __nv_bfloat16*>(k),
                                  static_cast<const __nv_bfloat16*>(v),
                                  nullptr, nullptr};
    return by_width<__nv_bfloat16>(q, pl, out, tb, ps, tab, T_, HQ, HKV, D,
                                   bs, max_blocks, scale_div, s);
  }
  if (dtype == pt::kFloat32) {
    const Pools<float> pl{static_cast<const float*>(k),
                          static_cast<const float*>(v), nullptr, nullptr};
    return by_width<float>(q, pl, out, tb, ps, tab, T_, HQ, HKV, D, bs,
                           max_blocks, scale_div, s);
  }
  return cudaErrorInvalidValue;
}

// The same over int8 pools k, v [num_blocks, HKV, bs, D] with f32 scale
// pools ks, vs [num_blocks, HKV, bs]: q and out of `dtype` (pt::kFloat32 or
// pt::kBFloat16), each K and V element dequantized to it before its
// product. The pools must be 8-byte aligned, the scale pools 4-byte.
extern "C" int pt_paged_attention_int8(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, void* out,
                                       const void* t2b, const void* pos,
                                       const void* bt, int T_, int HQ,
                                       int HKV, int D, int bs, int max_blocks,
                                       int dtype, float scale_div,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t bad = check_args(q, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                                     max_blocks, scale_div);
  if (bad != cudaSuccess) return bad;
  for (const void* ptr : {k, v})
    if (ptr == nullptr || !aligned(ptr, 8)) return cudaErrorInvalidValue;
  for (const void* ptr : {ks, vs})
    if (ptr == nullptr || !aligned(ptr, 4)) return cudaErrorInvalidValue;
  const int64_t* tb = static_cast<const int64_t*>(t2b);
  const int64_t* ps = static_cast<const int64_t*>(pos);
  const int64_t* tab = static_cast<const int64_t*>(bt);
  const Pools<int8_t> pl{static_cast<const int8_t*>(k),
                         static_cast<const int8_t*>(v),
                         static_cast<const float*>(ks),
                         static_cast<const float*>(vs)};
  if (dtype == pt::kBFloat16)
    return by_width<__nv_bfloat16>(q, pl, out, tb, ps, tab, T_, HQ, HKV, D,
                                   bs, max_blocks, scale_div, s);
  if (dtype == pt::kFloat32)
    return by_width<float>(q, pl, out, tb, ps, tab, T_, HQ, HKV, D, bs,
                           max_blocks, scale_div, s);
  return cudaErrorInvalidValue;
}
