// RMSNorm forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/rms_norm.py::_kernel (with weight) and
// ::_kernel_nw (without): y = x * rsqrt(mean(x^2) + eps) [* w], computed in
// f32 after normalising, written once in the input dtype. The weight is
// x's dtype or f32 (the training path keeps its norm weights in f32 while
// activations are bf16); like the TPU kernel, it is read as f32.
//
// Bound: bytes. The function reads each row once and writes it once, plus
// the weight: at the serving shape (N=256, h=2048, bf16) that is ~2.1 MB,
// ~0.63 us at 3.35 TB/s. At decode (N=8 rows) the launch dominates.
//
// Design: one block per row. Each thread loads its 16-byte vectors of the
// row into registers once, the sum of squares is reduced in f32 by warp
// shuffles plus one shared-memory step, and the same registers are scaled
// and stored: one pass over device memory. Any row count works; the TPU
// kernel's 256-row tiling gate does not exist here.
#include "common.cuh"

namespace {

constexpr int kMaxVecPerThread = 4;
constexpr int kMaxThreads = 1024;

// The kVec weights of x's 16-byte vector v, as f32. W is T or float, so
// they span one or two 16-byte vectors of the weight.
template <typename T, typename W>
__device__ __forceinline__ void load_weight(const W* __restrict__ w, int v,
                                            float (&out)[16 / sizeof(T)]) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = 16 / sizeof(W);
  static_assert(kVec % kPer == 0, "weight wider than x's vector");
  const uint4* wp = reinterpret_cast<const uint4*>(w + v * kVec);
#pragma unroll
  for (int c = 0; c < kVec / kPer; ++c) {
    const uint4 wv = wp[c];
    const W* we = reinterpret_cast<const W*>(&wv);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[c * kPer + j] = pt::to_float(we[j]);
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ y, int h, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = h / kVec;
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * h);
  uint4* yr = reinterpret_cast<uint4*>(y + row * h);

  uint4 buf[kMaxVecPerThread];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      buf[i] = xr[v];
      const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = pt::to_float(e[j]);
        ss += f * f;
      }
    }
  }

  __shared__ float partial[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ss = pt::warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  // every warp sums the per-warp partials itself: no second barrier
  const int nwarps = blockDim.x >> 5;
  const float total = pt::warp_sum(lane < nwarps ? partial[lane] : 0.f);
  const float inv = rsqrtf(total / static_cast<float>(h) + eps);

#pragma unroll
  for (int i = 0; i < kMaxVecPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[i]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
      if (w != nullptr) {
        float we[kVec];
        load_weight<T, W>(w, v, we);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          o[j] = pt::from_float<T>(pt::to_float(e[j]) * inv * we[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          o[j] = pt::from_float<T>(pt::to_float(e[j]) * inv);
      }
      yr[v] = out;
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows,
                   int h, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = h / kVec;
  int threads = (nvec + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rms_norm_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(y), h, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: [rows, h] row-contiguous; w: [h] or null, of dtype wdtype (x's
// dtype, or f32); all 16-byte aligned (the vector loads), else refused.
// h must be a multiple of 16 bytes' worth of elements and at most 4 * 1024
// such vectors (checked by the Python wrapper).
extern "C" int pt_rms_norm(const void* x, const void* w, void* y,
                           int64_t rows, int h, float eps, int dtype,
                           int wdtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return cudaErrorInvalidValue;
  if (dtype == pt::kBFloat16 && wdtype == pt::kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, h, eps, s);
  if (dtype == pt::kBFloat16 && wdtype == pt::kFloat32)
    return launch<__nv_bfloat16, float>(x, w, y, rows, h, eps, s);
  if (dtype == pt::kFloat32 && wdtype == pt::kFloat32)
    return launch<float, float>(x, w, y, rows, h, eps, s);
  return cudaErrorInvalidValue;
}

// Shared by every wrapper's error message.
extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
