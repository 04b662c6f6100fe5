// RoPE and cache append of a paged serving step, for Hopper (sm_90a): one
// launch a layer.
//
// Replaces the rotation, the casts and the page scatters of
// paddle_tpu/incubate/nn/functional/__init__.py::block_multihead_attention
// (:655-704; the int8 `q8` at :687-704), which the TPU package writes as
// jnp for XLA to fuse into one loop (no Pallas kernel). From the step's
// packed qkv [T, (HQ + 2 HKV) D] (rows `row_stride` elements apart), for
// every token t:
//   q and k: each head's interleaved pairs (x1, x2) = (x[2i], x[2i+1])
//     become (x1 c - x2 s, x2 c + x1 s) in f32 at the token's angles
//     cos[t, i], sin[t, i], each product, difference and sum rounded on its
//     own (no FMA contraction: the plain version runs them as separate
//     tensor ops), then rounded once to q's dtype;
//   float pages (q's dtype): rotated k and v go to pool[page[t], h,
//     slot[t], :] of the layer's pools [num_blocks, HKV, bs, D];
//   int8 pages: the rounded k and v are quantized as csrc/kv_quant.cu does,
//     s = max(max_d |x| * (1/127), 1e-8) and codes clip(rint(x / s), -127,
//     127) (an IEEE division: no fast-math in _build.py), the scale into
//     the layer's f32 scale pool [num_blocks, HKV, bs];
//   the rotated q goes to q_out [T, HQ, D]; with heads-first outputs (the
//     fresh-prefill step, which attends over this step's unquantized k and
//     v) q, k and v go to [HQ, T, D], [HKV, T, D] and [HKV, T, D], the
//     layout the varlen kernel reads.
// Padding tokens write the trash page 0, as the reference's do; when several
// write one slot the winner is unordered, as in a scatter, and no live row
// reads page 0.
//
// Bound: bytes (qkv, the angles and page/slot read once; q, the pages and
// scales written once): at decode (8 tokens, 16/8 heads of 128, bf16) ~0.1
// MB, tens of nanoseconds, so a launch costs more than the work. The kernel
// is worth the launches it removes: the ~20 tensor ops a layer of the
// composition it replaces. Design: a warp a (token, unit), the units being
// the HQ q heads, the HKV k heads and the HKV v heads, so one launch covers
// q, k and v with a grid from the shapes only (the decode windows' CUDA
// graphs capture it). Each lane takes 16-byte chunks of its head where every
// pointer and the row stride allow (half a warp at D = 128 in bf16), single
// elements otherwise; int8 pages take a shuffle max over the warp before the
// codes. Nothing goes through shared memory.
#include <string.h>

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

struct Args {
  const void* qkv;
  int64_t row_stride;  // elements between tokens of qkv
  const float* cos;    // [T, D/2]
  const float* sin;
  const int64_t* page;  // [T]
  const int64_t* slot;
  void* kc;   // the layer's pools [num_blocks, HKV, bs, D]: q's dtype or int8
  void* vc;
  float* ks;  // the layer's scale pools [num_blocks, HKV, bs] (int8 pages)
  float* vs;
  void* q_out;  // [T, HQ, D], or [HQ, T, D] with heads-first outputs
  void* k_out;  // [HKV, T, D] with heads-first outputs, else null
  void* v_out;
  int T, HQ, HKV, D, bs;
};

// VEC elements of a head at p: one 16-byte load (VECTOR), or one at a time.
template <typename T, int VEC, bool VECTOR>
__device__ __forceinline__ void load_chunk(const T* p, float (&x)[VEC]) {
  T e[VEC];
  if constexpr (VECTOR) {
    static_assert(VEC * sizeof(T) == 16, "a 16-byte chunk");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(e, &u, 16);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = pt::to_float(e[i]);
}

// y (values of T already) stored as T at p.
template <typename T, int VEC, bool VECTOR>
__device__ __forceinline__ void store_chunk(T* p, const float (&y)[VEC]) {
  T e[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = pt::from_float<T>(y[i]);
  if constexpr (VECTOR) {
    uint4 u;
    memcpy(&u, e, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = e[i];
  }
}

// VEC int8 codes at p: one VEC-byte store (VECTOR; p is VEC-aligned), or one
// at a time.
template <int VEC, bool VECTOR>
__device__ __forceinline__ void store_codes(int8_t* p, const int8_t (&c)[VEC]) {
  if constexpr (VECTOR && VEC == 8) {
    uint2 u;
    memcpy(&u, c, 8);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (VECTOR && VEC == 4) {
    uint32_t u;
    memcpy(&u, c, 4);
    *reinterpret_cast<uint32_t*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = c[i];
  }
}

// T: q's dtype (float or bf16); INT8: int8 pages, else pages of T; VECTOR:
// 16-byte chunks (VEC = 16 / sizeof(T)), else pairs of elements (VEC = 2).
template <typename T, bool INT8, bool VECTOR>
__global__ void __launch_bounds__(kThreads) rope_append_kernel(Args a) {
  constexpr int VEC = VECTOR ? 16 / static_cast<int>(sizeof(T)) : 2;
  constexpr int KMAX = (kMaxD / VEC + 31) / 32;  // chunks a lane at most
  const int units = a.HQ + 2 * a.HKV;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= static_cast<int64_t>(a.T) * units) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int t = static_cast<int>(w / units);
  const int u = static_cast<int>(w - static_cast<int64_t>(t) * units);
  const int D = a.D;
  const int chunks = D / VEC;
  const bool is_q = u < a.HQ;
  const bool is_v = u >= a.HQ + a.HKV;
  const int h = is_q ? u : (is_v ? u - a.HQ - a.HKV : u - a.HQ);
  const T* x_row = static_cast<const T*>(a.qkv) + t * a.row_stride +
                   static_cast<int64_t>(u) * D;
  const float* cs = a.cos + static_cast<int64_t>(t) * (D / 2);
  const float* sn = a.sin + static_cast<int64_t>(t) * (D / 2);
  const bool heads_first = a.k_out != nullptr;

  float y[KMAX][VEC];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const int c = lane + 32 * j;
    float x[VEC] = {};
    if (c < chunks) load_chunk<T, VEC, VECTOR>(x_row + c * VEC, x);
    if (is_v) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[j][i] = x[i];
    } else {
#pragma unroll
      for (int p = 0; p < VEC / 2; ++p) {
        // a lane past the head's chunks keeps zeros (no angle read)
        const int pair = c < chunks ? c * (VEC / 2) + p : 0;
        const float co = cs[pair], si = sn[pair];
        const float x1 = x[2 * p], x2 = x[2 * p + 1];
        // three roundings each, as the plain version's tensor ops
        y[j][2 * p] = pt::round_to<T>(
            __fsub_rn(__fmul_rn(x1, co), __fmul_rn(x2, si)));
        y[j][2 * p + 1] = pt::round_to<T>(
            __fadd_rn(__fmul_rn(x2, co), __fmul_rn(x1, si)));
      }
    }
  }

  if (is_q) {
    T* out = static_cast<T*>(a.q_out) +
             (heads_first ? static_cast<int64_t>(h) * a.T + t
                          : static_cast<int64_t>(t) * a.HQ + h) *
                 D;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) store_chunk<T, VEC, VECTOR>(out + c * VEC, y[j]);
    }
    return;
  }
  if (heads_first) {
    T* out = static_cast<T*>(is_v ? a.v_out : a.k_out) +
             (static_cast<int64_t>(h) * a.T + t) * D;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) store_chunk<T, VEC, VECTOR>(out + c * VEC, y[j]);
    }
  }
  const int64_t row = (a.page[t] * a.HKV + h) * a.bs + a.slot[t];
  if constexpr (INT8) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)  // zeros past the head's chunks
#pragma unroll
      for (int i = 0; i < VEC; ++i) m = fmaxf(m, fabsf(y[j][i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = fmaxf(m * (1.0f / 127.0f), 1e-8f);
    int8_t* out = static_cast<int8_t*>(is_v ? a.vc : a.kc) + row * D;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const int c = lane + 32 * j;
      if (c >= chunks) continue;
      int8_t codes[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        codes[i] = static_cast<int8_t>(
            fminf(fmaxf(rintf(y[j][i] / s), -127.f), 127.f));
      store_codes<VEC, VECTOR>(out + c * VEC, codes);
    }
    if (lane == 0) (is_v ? a.vs : a.ks)[row] = s;
  } else {
    T* out = static_cast<T*>(is_v ? a.vc : a.kc) + row * D;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) store_chunk<T, VEC, VECTOR>(out + c * VEC, y[j]);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool INT8>
int launch(const Args& a, cudaStream_t s) {
  const int64_t warps =
      static_cast<int64_t>(a.T) * (a.HQ + 2 * a.HKV);
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool vector =
      a.D % VEC == 0 &&
      (a.row_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
      aligned16(a.qkv) && aligned16(a.kc) && aligned16(a.vc) &&
      aligned16(a.q_out) && (a.k_out == nullptr || aligned16(a.k_out)) &&
      (a.v_out == nullptr || aligned16(a.v_out));
  if (vector)
    rope_append_kernel<T, INT8, true><<<grid, kThreads, 0, s>>>(a);
  else
    rope_append_kernel<T, INT8, false><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// RoPE and cache append of one layer (see the note at the top). qkv [T,
// (HQ + 2 HKV) D] of dtype pt::kFloat32 or pt::kBFloat16, a token's row
// contiguous, rows row_stride elements apart; cos, sin [T, D/2] f32; page,
// slot [T] int64; kc, vc the layer's pools [num_blocks, HKV, bs, D] of qkv's
// dtype (int8 == 0, ks and vs null) or int8 with the layer's f32 scale pools
// ks, vs [num_blocks, HKV, bs] (int8 == 1); q_out, and k_out, v_out for
// heads-first outputs (both null otherwise). Refuses (cudaErrorInvalidValue)
// a non-positive size, an odd D or one above 256, a row stride below
// (HQ + 2 HKV) D, a missing pointer and a scale pool or heads-first output
// given without its pair.
extern "C" int pt_rope_append(const void* qkv, int64_t row_stride,
                              const void* cos, const void* sin,
                              const void* page, const void* slot, void* kc,
                              void* vc, void* ks, void* vs, void* q_out,
                              void* k_out, void* v_out, int T_, int HQ,
                              int HKV, int D, int bs, int dtype, int int8,
                              void* stream) {
  if (T_ <= 0 || HQ <= 0 || HKV <= 0 || D <= 0 || D % 2 || D > kMaxD ||
      bs <= 0 || row_stride < static_cast<int64_t>(HQ + 2 * HKV) * D)
    return cudaErrorInvalidValue;
  for (const void* p : {qkv, cos, sin, page, slot,
                        static_cast<const void*>(kc),
                        static_cast<const void*>(vc),
                        static_cast<const void*>(q_out)})
    if (p == nullptr) return cudaErrorInvalidValue;
  if ((k_out == nullptr) != (v_out == nullptr)) return cudaErrorInvalidValue;
  if (int8 ? (ks == nullptr || vs == nullptr)
           : (ks != nullptr || vs != nullptr))
    return cudaErrorInvalidValue;
  Args a{qkv, row_stride, static_cast<const float*>(cos),
         static_cast<const float*>(sin), static_cast<const int64_t*>(page),
         static_cast<const int64_t*>(slot), kc, vc, static_cast<float*>(ks),
         static_cast<float*>(vs), q_out, k_out, v_out, T_, HQ, HKV, D, bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBFloat16)
    return int8 ? launch<__nv_bfloat16, true>(a, s)
                : launch<__nv_bfloat16, false>(a, s);
  if (dtype == pt::kFloat32)
    return int8 ? launch<float, true>(a, s) : launch<float, false>(a, s);
  return cudaErrorInvalidValue;
}
