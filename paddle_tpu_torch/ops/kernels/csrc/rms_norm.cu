// RMSNorm forward and gradient for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/rms_norm.py::_kernel (with weight) and
// ::_kernel_nw (without): y = x * rsqrt(mean(x^2) + eps) [* w], computed in
// f32 after normalising, written once in the input dtype. The weight is
// x's dtype or f32 (the training path keeps its norm weights in f32 while
// activations are bf16); like the TPU kernel, it is read as f32.
//
// The gradient is the TPU package's analytic _bwd (rms_norm.py:88-104),
// which XLA fuses there: inv = rsqrt(mean(x^2) + eps), xhat = x * inv,
// gxhat = g * w (g without a weight), c = mean(gxhat * xhat) over the row,
// gx = inv * (gxhat - xhat * c) rounded once to x's dtype, and
// gw = sum over rows of g * xhat in f32, cast to the weight's dtype.
//
// Bound: bytes, for both. The forward reads each row once and writes it
// once, plus the weight: at the serving shape (N=256, h=2048, bf16) ~2.1 MB,
// ~0.63 us at 3.35 TB/s; at decode (N=8 rows) the launch dominates. The
// gradient reads x and g and writes gx: at the training shape (16384 x 2048
// bf16) 201 MB, 60 us.
//
// Rows are cut into units: a 16-byte vector where h is a multiple of 16
// bytes' worth of elements (N = 16 / sizeof(T) elements), else one element
// (N = 1; any h). Two ways over a row:
// - resident: each thread keeps its units of the row in registers, so the
//   row is read once (the forward holds up to kFwdUnits units a thread at
//   1024 threads, the gradient one unit a thread of x and of g);
// - two-pass, for a row wider than that: the first pass reduces, the
//   second reads the row again, from L2, and writes.
// The forward runs one block a row. The gradient runs a fixed grid of
// blocks (its count passed by the wrapper, a constant, never the card's SM
// count), each over a contiguous range of rows, with the next row's loads
// issued before the current row's stores; both sums a row (x^2 and
// gxhat * x) go through one block reduction. gw has no atomics: each block
// sums g * xhat over its rows per column in f32 and writes one row of a
// [blocks, h] f32 partial buffer, and a second small kernel sums the
// partials over the blocks in a fixed order: the same bits every run.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFwdUnits = 4;      // resident units a thread, forward
constexpr int kBwdThreads = 512;  // resident units (threads) a row, gradient

// Bits of the `mode` word the wrappers pass.
constexpr int kModeBFloat16 = 1;  // x (and y, g, gx) bf16, else f32
constexpr int kModeWeightF32 = 2; // weight f32, else x's dtype
constexpr int kModeVector = 4;    // 16-byte units, else single elements
constexpr int kModeResident = 8;  // rows held in registers, else two-pass

// N consecutive elements of T: one 16-byte vector or one element.
template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T e[N];
};

// Unit u of the row at p (N elements from p + u * N).
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* __restrict__ p,
                                                int u) {
  return reinterpret_cast<const Pack<T, N>*>(p)[u];
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* __restrict__ p, int u,
                                           const Pack<T, N>& v) {
  reinterpret_cast<Pack<T, N>*>(p)[u] = v;
}

// The N elements of unit u of p, as f32; p's type may be wider than the
// unit's (an f32 weight beside bf16 x spans two 16-byte vectors).
template <typename W, int N>
__device__ __forceinline__ void load_f32(const W* __restrict__ p, int u,
                                         float (&out)[N]) {
  constexpr int kPer = 16 / sizeof(W);
  if constexpr (N % kPer == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p + u * N);
#pragma unroll
    for (int c = 0; c < N / kPer; ++c) {
      const uint4 v = q[c];
      const W* e = reinterpret_cast<const W*>(&v);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[c * kPer + j] = pt::to_float(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = pt::to_float(p[u * N + j]);
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* __restrict__ p, int u,
                                          const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
    float4* q = reinterpret_cast<float4*>(p + u * N);
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      q[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[u * N + j] = v[j];
  }
}

// Sums of a and b over the block; every thread gets both. `red` (one
// float2 a warp) is written before one barrier and read after it, so a
// loop reducing once a row alternates two such buffers: a warp can only
// write a buffer again after every warp has passed the barrier between.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = pt::warp_sum(a);
  b = pt::warp_sum(b);
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const bool in = lane < static_cast<int>(blockDim.x >> 5);
  const float2 p = in ? red[lane] : make_float2(0.f, 0.f);
  return make_float2(pt::warp_sum(p.x), pt::warp_sum(p.y));
}

// The forwards' one sum a block: the same with one float (one barrier, no
// second pass of shuffles).
__device__ __forceinline__ float block_sum(float a, float* red) {
  const int lane = threadIdx.x & 31;
  a = pt::warp_sum(a);
  if (lane == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  const bool in = lane < static_cast<int>(blockDim.x >> 5);
  return pt::warp_sum(in ? red[lane] : 0.f);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// One block a row; thread t holds units t, t + blockDim, ... (at most
// kFwdUnits) of the row in registers.
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ y, int h, float eps) {
  const int units = h / N;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;

  Pack<T, N> buf[kFwdUnits];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kFwdUnits; ++i) {
    const int u = threadIdx.x + i * blockDim.x;
    if (u < units) {
      buf[i] = load_pack<T, N>(xr, u);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = pt::to_float(buf[i].e[j]);
        ss += f * f;
      }
    }
  }
  __shared__ float red[kMaxThreads / 32];
  const float inv = rsqrtf(block_sum(ss, red) / static_cast<float>(h) + eps);

#pragma unroll
  for (int i = 0; i < kFwdUnits; ++i) {
    const int u = threadIdx.x + i * blockDim.x;
    if (u < units) {
      Pack<T, N> out;
      if (w != nullptr) {
        float we[N];
        load_f32<W, N>(w, u, we);
#pragma unroll
        for (int j = 0; j < N; ++j)
          out.e[j] = pt::from_float<T>(pt::to_float(buf[i].e[j]) * inv * we[j]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
          out.e[j] = pt::from_float<T>(pt::to_float(buf[i].e[j]) * inv);
      }
      store_pack<T, N>(yr, u, out);
    }
  }
}

// One block a row wider than the resident kernel holds: the sum of squares
// in a first pass over the row, then a second pass (from L2) that scales
// and stores.
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_two_pass_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         T* __restrict__ y, int h, float eps) {
  const int units = h / N;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;

  float ss = 0.f;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    float f[N];
    load_f32<T, N>(xr, u, f);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += f[j] * f[j];
  }
  __shared__ float red[kMaxThreads / 32];
  const float inv = rsqrtf(block_sum(ss, red) / static_cast<float>(h) + eps);

  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    float f[N];
    load_f32<T, N>(xr, u, f);
    Pack<T, N> out;
    if (w != nullptr) {
      float we[N];
      load_f32<W, N>(w, u, we);
#pragma unroll
      for (int j = 0; j < N; ++j)
        out.e[j] = pt::from_float<T>(f[j] * inv * we[j]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) out.e[j] = pt::from_float<T>(f[j] * inv);
    }
    store_pack<T, N>(yr, u, out);
  }
}

// ---------------------------------------------------------------------------
// Gradient
// ---------------------------------------------------------------------------

// This block's rows [r0, r1): a balanced split of the rows over the grid,
// fixed by (rows, gridDim.x).
__device__ __forceinline__ void block_rows(int64_t rows, int64_t& r0,
                                           int64_t& r1) {
  r0 = rows * blockIdx.x / gridDim.x;
  r1 = rows * (blockIdx.x + 1) / gridDim.x;
}

// gx of one unit from the row's inv and c; adds g * xhat to acc.
template <typename T, int N, bool WEIGHT>
__device__ __forceinline__ Pack<T, N> grad_unit(const float (&xf)[N],
                                                const float (&gf)[N],
                                                const float (&wf)[N],
                                                float inv, float c,
                                                float (&acc)[N]) {
  Pack<T, N> out;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float xhat = xf[j] * inv;
    const float gxhat = WEIGHT ? gf[j] * wf[j] : gf[j];
    out.e[j] = pt::from_float<T>(inv * (gxhat - xhat * c));
    if (WEIGHT) acc[j] += gf[j] * xhat;
  }
  return out;
}

// One unit a thread (thread t holds unit t of every row of the block's
// range), the next row's x and g loaded before the current row's gx is
// stored. Writes gx and, with a weight, row blockIdx.x of part [grid, h].
template <typename T, typename W, int N, bool WEIGHT>
__global__ void __launch_bounds__(kBwdThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const W* __restrict__ w, T* __restrict__ gx,
                    float* __restrict__ part, int64_t rows, int h,
                    float eps) {
  const int units = h / N;
  const int u = threadIdx.x;
  const bool live = u < units;
  int64_t r0, r1;
  block_rows(rows, r0, r1);
  const float scale = 1.f / static_cast<float>(h);

  float wf[N], acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    wf[j] = 1.f;
    acc[j] = 0.f;
  }
  if (WEIGHT && live) load_f32<W, N>(w, u, wf);

  __shared__ float2 red[2][kBwdThreads / 32];
  Pack<T, N> xn, gn;
  if (live) {
    xn = load_pack<T, N>(x + r0 * h, u);
    gn = load_pack<T, N>(g + r0 * h, u);
  }
  for (int64_t r = r0; r < r1; ++r) {
    const Pack<T, N> xc = xn, gc = gn;
    if (live && r + 1 < r1) {
      xn = load_pack<T, N>(x + (r + 1) * h, u);
      gn = load_pack<T, N>(g + (r + 1) * h, u);
    }
    float xf[N], gf[N];
    float ss = 0.f, d = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      xf[j] = live ? pt::to_float(xc.e[j]) : 0.f;
      gf[j] = live ? pt::to_float(gc.e[j]) : 0.f;
      ss += xf[j] * xf[j];
      d += (WEIGHT ? gf[j] * wf[j] : gf[j]) * xf[j];
    }
    const float2 s = block_sum2(ss, d, red[r & 1]);
    const float inv = rsqrtf(s.x * scale + eps);
    // c = mean(gxhat * xhat) = inv * mean(gxhat * x)
    const float c = inv * (s.y * scale);
    if (live)
      store_pack<T, N>(gx + r * h, u,
                       grad_unit<T, N, WEIGHT>(xf, gf, wf, inv, c, acc));
  }
  if (WEIGHT && live)
    store_f32<N>(part + blockIdx.x * static_cast<int64_t>(h), u, acc);
}

// Rows too wide for one unit a thread: for each row of the block's range, a
// first pass reduces both sums, a second pass (from L2) writes gx and adds
// g * xhat into the block's partial row (each thread owns its columns of
// that row, so the read-modify-write needs no synchronisation).
template <typename T, typename W, int N, bool WEIGHT>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_bwd_two_pass_kernel(const T* __restrict__ x,
                             const T* __restrict__ g,
                             const W* __restrict__ w, T* __restrict__ gx,
                             float* __restrict__ part, int64_t rows, int h,
                             float eps) {
  const int units = h / N;
  int64_t r0, r1;
  block_rows(rows, r0, r1);
  const float scale = 1.f / static_cast<float>(h);
  float* pr = WEIGHT ? part + blockIdx.x * static_cast<int64_t>(h) : nullptr;
  __shared__ float2 red[2][kMaxThreads / 32];

  for (int64_t r = r0; r < r1; ++r) {
    const T* xr = x + r * h;
    const T* gr = g + r * h;
    float ss = 0.f, d = 0.f;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      float xf[N], gf[N], wf[N];
      load_f32<T, N>(xr, u, xf);
      load_f32<T, N>(gr, u, gf);
      if (WEIGHT) load_f32<W, N>(w, u, wf);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss += xf[j] * xf[j];
        d += (WEIGHT ? gf[j] * wf[j] : gf[j]) * xf[j];
      }
    }
    const float2 s = block_sum2(ss, d, red[r & 1]);
    const float inv = rsqrtf(s.x * scale + eps);
    const float c = inv * (s.y * scale);
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      float xf[N], gf[N], wf[N], acc[N];
      load_f32<T, N>(xr, u, xf);
      load_f32<T, N>(gr, u, gf);
      if (WEIGHT) {
        load_f32<W, N>(w, u, wf);
        if (r == r0) {
#pragma unroll
          for (int j = 0; j < N; ++j) acc[j] = 0.f;
        } else {
          load_f32<float, N>(pr, u, acc);
        }
      }
      store_pack<T, N>(gx + r * h, u,
                       grad_unit<T, N, WEIGHT>(xf, gf, wf, inv, c, acc));
      if (WEIGHT) store_f32<N>(pr, u, acc);
    }
  }
}

// gw[col] = sum over the nb partial rows, in a fixed order: 32 columns a
// block, warp k sums rows k, k + 8, ... in turn, then warp 0 adds the 8
// warps' sums in order and casts to W.
template <typename W>
__global__ void __launch_bounds__(256)
rms_norm_bwd_gw_kernel(const float* __restrict__ part, W* __restrict__ gw,
                       int nb, int h) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < h)
    for (int b = warp; b < nb; b += 8)
      s += part[static_cast<int64_t>(b) * h + col];
  __shared__ float red[8][32];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < h) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][lane];
    gw[col] = pt::from_float<W>(t);
  }
}

int threads_for(int units, int cap) {
  int t = (units + 31) / 32 * 32;
  return t > cap ? cap : t;
}

template <typename T, typename W, int N>
cudaError_t forward(const void* x, const void* w, void* y, int64_t rows,
                    int h, float eps, bool resident, cudaStream_t s) {
  const int units = h / N;
  const unsigned grid = static_cast<unsigned>(rows);
  const int threads = threads_for(units, kMaxThreads);
  if (resident) {
    if (units > kMaxThreads * kFwdUnits) return cudaErrorInvalidValue;
    rms_norm_kernel<T, W, N><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), h, eps);
  } else {
    rms_norm_two_pass_kernel<T, W, N><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), h, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename W, int N, bool WEIGHT>
cudaError_t backward(const void* x, const void* g, const void* w, void* gx,
                     float* part, void* gw, int64_t rows, int h, float eps,
                     bool resident, int blocks, cudaStream_t s) {
  const int units = h / N;
  if (resident) {
    if (units > kBwdThreads) return cudaErrorInvalidValue;
    rms_norm_bwd_kernel<T, W, N, WEIGHT>
        <<<blocks, threads_for(units, kBwdThreads), 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(g),
            static_cast<const W*>(w), static_cast<T*>(gx), part, rows, h,
            eps);
  } else {
    rms_norm_bwd_two_pass_kernel<T, W, N, WEIGHT>
        <<<blocks, threads_for(units, kMaxThreads), 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(g),
            static_cast<const W*>(w), static_cast<T*>(gx), part, rows, h,
            eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !WEIGHT) return err;
  rms_norm_bwd_gw_kernel<W><<<(h + 31) / 32, 256, 0, s>>>(
      part, static_cast<W*>(gw), blocks, h);
  return cudaGetLastError();
}

// The (x type, weight type, unit) a mode word names.
template <typename T, typename W, int N>
struct Types {
  using x_t = T;
  using w_t = W;
  static constexpr int n = N;
};

// Calls f(Types<...>{}) for the mode's types; refuses an f32 x with a bf16
// weight and, for vector units, an h that is not a multiple of the vector
// or a pointer that is not 16-byte aligned.
template <typename F>
cudaError_t by_types(int mode, const void* w, int h,
                     std::initializer_list<const void*> ptrs, F&& f) {
  const bool bf16 = mode & kModeBFloat16, wf32 = mode & kModeWeightF32;
  if (!bf16 && w != nullptr && !wf32) return cudaErrorInvalidValue;
  if (mode & kModeVector) {
    if (h % (bf16 ? 8 : 4) != 0) return cudaErrorInvalidValue;
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return cudaErrorInvalidValue;
    if (!bf16) return f(Types<float, float, 4>{});
    if (wf32) return f(Types<__nv_bfloat16, float, 8>{});
    return f(Types<__nv_bfloat16, __nv_bfloat16, 8>{});
  }
  if (!bf16) return f(Types<float, float, 1>{});
  if (wf32) return f(Types<__nv_bfloat16, float, 1>{});
  return f(Types<__nv_bfloat16, __nv_bfloat16, 1>{});
}

}  // namespace

// x, y: [rows, h] row-contiguous; w: [h] or null, of x's dtype or f32 (the
// mode word's bits, kMode*; an f32 x takes an f32 weight). Vector units
// need h a multiple of 16 bytes' worth of elements and 16-byte aligned
// pointers; resident rows at most 4 * 1024 units. Anything else is refused
// with cudaErrorInvalidValue.
extern "C" int pt_rms_norm(const void* x, const void* w, void* y,
                           int64_t rows, int h, float eps, int mode,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resident = mode & kModeResident;
  if (rows <= 0 || h <= 0 || rows > 0x7FFFFFFF) return cudaErrorInvalidValue;
  return by_types(mode, w, h, {x, w, y}, [&](auto types) {
    using Ty = decltype(types);
    return forward<typename Ty::x_t, typename Ty::w_t, Ty::n>(
        x, w, y, rows, h, eps, resident, s);
  });
}

// The gradient: x, g, gx [rows, h] row-contiguous in x's dtype; w, gw [h]
// in the weight's and part [blocks, h] f32 scratch (all three null without
// a weight). `blocks` blocks run (1 <= blocks <= rows), each over its
// balanced share of the rows. Resident rows need at most 512 units. Same
// refusals as pt_rms_norm.
extern "C" int pt_rms_norm_bwd(const void* x, const void* g, const void* w,
                               void* gx, void* part, void* gw, int64_t rows,
                               int h, float eps, int mode, int blocks,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resident = mode & kModeResident;
  float* p = static_cast<float*>(part);
  if (rows <= 0 || h <= 0 || blocks < 1 || blocks > rows ||
      (w != nullptr && (part == nullptr || gw == nullptr)))
    return cudaErrorInvalidValue;
  return by_types(mode, w, h, {x, g, w, gx, part}, [&](auto types) {
    using Ty = decltype(types);
    using T = typename Ty::x_t;
    using W = typename Ty::w_t;
    if (w != nullptr)
      return backward<T, W, Ty::n, true>(x, g, w, gx, p, gw, rows, h, eps,
                                         resident, blocks, s);
    return backward<T, W, Ty::n, false>(x, g, w, gx, p, gw, rows, h, eps,
                                        resident, blocks, s);
  });
}

// Shared by every wrapper's error message.
extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
