// Weight dequantization of the streamed serving decoder, for Hopper (sm_90a).
//
// Counterpart of paddle_tpu/inference/weight_stream.py::dequantize (:61) and
// ::dequantize_int4 (:99), which the TPU package writes as jnp inside the
// jitted step for XLA to fuse (no Pallas kernel). One launch dequantizes a
// decoder layer's group of streamed Linears (qkv, proj, gate_up, down: up to
// four segments of one descriptor) into the engine's workspace slot, in the
// reference's [in, out] layout:
//   int8 per channel:  w[r, c] = code[r, c] * scale[c]
//   int4 grouped:      w[r, c] = (nibble(r, c) - 8) * scale[r / 32, c], two
//                      codes a byte along the input axis, the even row in
//                      the high nibble; the padding rows (r >= in) are not
//                      written.
// A code becomes a float exactly, the product is one f32 multiply, and the
// result is rounded to the output dtype with __float2bfloat16_rn (or stored
// as f32): the bits of the plain version, (q.float() * s).to(dtype), and of
// the reference's in-trace dequant.
//
// Bound: bytes. Each code and scale is read once and each output written
// once; one multiply an output. At llama_1b's layer group (47.19 M weights)
// that is 141.6 MB for int8 and 123.9 MB for int4 with bf16 out: 42.3 and
// 37.0 us at 3.35 TB/s. Design, a simple kernel first: a thread takes one
// 16-byte (or, for an output width not a multiple of 16, 8-byte) load of
// codes along the output axis, i.e. V = 16 or 8 columns of one row (int8)
// or of two rows (int4), the V scales beside them, and writes its outputs
// with 16-byte stores; neighbouring threads take neighbouring columns, so
// loads and stores are coalesced on `out`. Blocks are laid over the four
// segments in turn; a block finds its segment from the segments' first
// blocks. Nothing is staged in shared memory.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 4;
constexpr int kModeInt8 = 0;
constexpr int kModeInt4 = 1;
constexpr int kInt4Group = 32;  // rows a scale covers (INT4_GROUP)

struct Segment {
  const uint8_t* codes;  // int8 [in, out], or packed uint8 [in_pad / 2, out]
  const float* scales;   // [out], or [in_pad / 32, out]
  void* out;             // [in, out] of the output dtype
  int in_dim;
  int out_dim;
  int64_t items;        // threads: code rows (in, or ceil(in / 2)) x out / V
  int64_t block_start;  // the segment's first block
};

struct Group {
  Segment seg[kMaxSegments];
  int n;
};

template <int V>
struct CodeVec;
template <>
struct CodeVec<8> {
  using T = uint2;
};
template <>
struct CodeVec<16> {
  using T = uint4;
};

// V outputs of one row, as 16-byte stores.
template <typename Out, int V>
__device__ __forceinline__ void store_row(Out* dst, const float (&v)[V]) {
  alignas(16) Out vals[V];
#pragma unroll
  for (int j = 0; j < V; ++j) vals[j] = pt::from_float<Out>(v[j]);
  constexpr int kStores = V * static_cast<int>(sizeof(Out)) / 16;
#pragma unroll
  for (int k = 0; k < kStores; ++k)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(vals)[k];
}

template <typename Out, int Mode, int V>
__global__ void __launch_bounds__(kThreads)
    weight_dequant_kernel(const Group g) {
  // the segment of this block: constant indices only, so the descriptor is
  // read from the parameter bank and never copied to local memory
  Segment sg = g.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i)
    if (i < g.n && static_cast<int64_t>(blockIdx.x) >= g.seg[i].block_start)
      sg = g.seg[i];
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) - sg.block_start) * kThreads +
      threadIdx.x;
  if (item >= sg.items) return;
  const int out_dim = sg.out_dim;
  const int64_t chunks = out_dim / V;
  const int64_t r = item / chunks;  // a code row
  const int c = static_cast<int>(item - r * chunks) * V;
  union {
    typename CodeVec<V>::T vec;
    uint8_t b[V];
  } code;
  code.vec = *reinterpret_cast<const typename CodeVec<V>::T*>(
      sg.codes + r * out_dim + c);
  // the scales of the V columns (of the row's group for int4)
  const float* sp =
      sg.scales + (Mode == kModeInt4 ? (r * 2 / kInt4Group) * out_dim : 0) + c;
  float s[V];
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const float4 q = reinterpret_cast<const float4*>(sp)[k];
    s[4 * k] = q.x;
    s[4 * k + 1] = q.y;
    s[4 * k + 2] = q.z;
    s[4 * k + 3] = q.w;
  }
  Out* out = static_cast<Out*>(sg.out);
  if (Mode == kModeInt8) {
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = static_cast<float>(static_cast<int8_t>(code.b[j])) * s[j];
    store_row<Out, V>(out + r * out_dim + c, v);
  } else {
    float hi[V], lo[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      hi[j] = static_cast<float>(static_cast<int>(code.b[j] >> 4) - 8) * s[j];
      lo[j] = static_cast<float>(static_cast<int>(code.b[j] & 0xF) - 8) * s[j];
    }
    store_row<Out, V>(out + 2 * r * out_dim + c, hi);
    if (2 * r + 1 < sg.in_dim)  // the odd row of the last pair may be padding
      store_row<Out, V>(out + (2 * r + 1) * out_dim + c, lo);
  }
}

template <typename Out, int Mode>
void launch(const Group& g, int V, unsigned blocks, cudaStream_t s) {
  if (V == 16)
    weight_dequant_kernel<Out, Mode, 16><<<blocks, kThreads, 0, s>>>(g);
  else
    weight_dequant_kernel<Out, Mode, 8><<<blocks, kThreads, 0, s>>>(g);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Dequantize n (1-4) segments in one launch: segment i reads codes[i] (int8
// [in, out] for mode 0; packed uint8 [ceil(in / 32) * 16, out] for mode 1)
// and scales[i] (f32 [out]; [ceil(in / 32), out]) and writes outs[i] [in,
// out] of dtype pt::kFloat32 or pt::kBFloat16. Refuses
// (cudaErrorInvalidValue) a count outside 1-4, a null or unaligned
// (16-byte) pointer, a non-positive size, an output width not a multiple of
// 8, an unknown mode or dtype, and a grid beyond 2^31 - 1 blocks.
extern "C" int pt_weight_dequant(int mode, int dtype, int n,
                                 const void* const* codes,
                                 const void* const* scales,
                                 void* const* outs, const int* in_dims,
                                 const int* out_dims, void* stream) {
  if (n < 1 || n > kMaxSegments || (mode != kModeInt8 && mode != kModeInt4) ||
      (dtype != pt::kFloat32 && dtype != pt::kBFloat16))
    return cudaErrorInvalidValue;
  Group g{};
  g.n = n;
  int V = 16;
  int64_t blocks = 0;
  for (int i = 0; i < n; ++i) {
    const int in = in_dims[i], out = out_dims[i];
    if (codes[i] == nullptr || scales[i] == nullptr || outs[i] == nullptr ||
        !aligned16(codes[i]) || !aligned16(scales[i]) || !aligned16(outs[i]) ||
        in <= 0 || out <= 0 || out % 8 != 0)
      return cudaErrorInvalidValue;
    if (out % 16 != 0) V = 8;
  }
  for (int i = 0; i < n; ++i) {
    Segment& sg = g.seg[i];
    sg.codes = static_cast<const uint8_t*>(codes[i]);
    sg.scales = static_cast<const float*>(scales[i]);
    sg.out = outs[i];
    sg.in_dim = in_dims[i];
    sg.out_dim = out_dims[i];
    const int64_t rows =
        mode == kModeInt4 ? (static_cast<int64_t>(in_dims[i]) + 1) / 2
                          : in_dims[i];
    sg.items = rows * (out_dims[i] / V);
    sg.block_start = blocks;
    blocks += (sg.items + kThreads - 1) / kThreads;
  }
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (dtype == pt::kBFloat16) {
    if (mode == kModeInt8)
      launch<__nv_bfloat16, kModeInt8>(g, V, grid, s);
    else
      launch<__nv_bfloat16, kModeInt4>(g, V, grid, s);
  } else {
    if (mode == kModeInt8)
      launch<float, kModeInt8>(g, V, grid, s);
    else
      launch<float, kModeInt4>(g, V, grid, s);
  }
  return cudaGetLastError();
}
