// Quantize-on-append of the int8 cache-KV path, for Hopper (sm_90a).
//
// Replaces `q8` and the four page scatters of the dynamic int8 route of
// paddle_tpu/incubate/nn/functional/__init__.py::block_multihead_attention
// (:687-704), which the TPU package leaves to XLA (no Pallas kernel): for
// each written token t and kv head h, of K and of V,
//   s = max(max_d |x| * (1/127), 1e-8)          (f32)
//   code = clip(round_half_even(x / s), -127, 127) as int8
// go to pool[page[t], h, slot[t], :] and scales[page[t], h, slot[t]] of the
// layer's int8 page pool [num_blocks, HKV, bs, D] and f32 scale pool
// [num_blocks, HKV, bs]. The reference writes `max / 127.0`, a division by
// a constant, which XLA's algebraic simplifier turns into a multiply by the
// constant's f32 reciprocal; the division by s stays a division. So s is
// max * (1.0f / 127.0f) here, x / s an IEEE division (no fast-math in
// _build.py) and the rounding rintf: codes and scales equal the
// reference's bit for bit. Padding tokens write the trash page 0, as the
// reference's do.
//
// Bound: bytes (the step's K and V read once, the codes and scales written
// once); a few operations an element. Design: one warp a (token, head, K or
// V): its lanes stride over D (coalesced), a shuffle max over the warp,
// then each lane reads its elements again (from L1) to write the codes.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kv_quant_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    int64_t k_stride, int64_t v_stride,
                    const int64_t* __restrict__ page,
                    const int64_t* __restrict__ slot, int8_t* __restrict__ kc,
                    int8_t* __restrict__ vc, float* __restrict__ ks,
                    float* __restrict__ vs, int T_, int HKV, int D, int bs) {
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t heads = static_cast<int64_t>(T_) * HKV;
  if (w >= 2 * heads) return;  // a whole warp leaves together
  const bool is_v = w >= heads;
  const int64_t r = is_v ? w - heads : w;
  const int64_t t = r / HKV;
  const int h = static_cast<int>(r - t * HKV);
  const T* x = (is_v ? v + t * v_stride : k + t * k_stride) +
               static_cast<int64_t>(h) * D;
  float m = 0.f;
  for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(pt::to_float(x[c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = fmaxf(m * (1.0f / 127.0f), 1e-8f);
  const int64_t row = (page[t] * HKV + h) * bs + slot[t];
  int8_t* out = (is_v ? vc : kc) + row * D;
  for (int c = lane; c < D; c += 32) {
    const float q = rintf(pt::to_float(x[c]) / s);
    out[c] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
  if (lane == 0) (is_v ? vs : ks)[row] = s;
}

}  // namespace

// Quantize k and v [T, HKV, D] (rows k_stride and v_stride elements apart;
// a row's HKV * D elements contiguous) into one layer's int8 pools kc, vc
// [num_blocks, HKV, bs, D] and f32 scale pools ks, vs [num_blocks, HKV, bs]
// at page[t], slot[t] (int64 [T]); dtype pt::kFloat32 or pt::kBFloat16.
// Refuses (cudaErrorInvalidValue) a non-positive size, a row stride below
// HKV * D and a null pointer.
extern "C" int pt_kv_quant(const void* k, const void* v, int64_t k_stride,
                           int64_t v_stride, const void* page,
                           const void* slot, void* kc, void* vc, void* ks,
                           void* vs, int T_, int HKV, int D, int bs,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_ <= 0 || HKV <= 0 || D <= 0 || bs <= 0 ||
      k_stride < static_cast<int64_t>(HKV) * D ||
      v_stride < static_cast<int64_t>(HKV) * D)
    return cudaErrorInvalidValue;
  for (const void* p : {k, v, page, slot, static_cast<const void*>(kc),
                        static_cast<const void*>(vc),
                        static_cast<const void*>(ks),
                        static_cast<const void*>(vs)})
    if (p == nullptr) return cudaErrorInvalidValue;
  const int64_t warps = 2 * static_cast<int64_t>(T_) * HKV;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  const int64_t* pg = static_cast<const int64_t*>(page);
  const int64_t* sl = static_cast<const int64_t*>(slot);
  int8_t* kq = static_cast<int8_t*>(kc);
  int8_t* vq = static_cast<int8_t*>(vc);
  float* kss = static_cast<float*>(ks);
  float* vss = static_cast<float*>(vs);
  if (dtype == pt::kBFloat16) {
    kv_quant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), k_stride, v_stride, pg, sl, kq,
        vq, kss, vss, T_, HKV, D, bs);
  } else if (dtype == pt::kFloat32) {
    kv_quant_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), k_stride,
        v_stride, pg, sl, kq, vq, kss, vss, T_, HKV, D, bs);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
