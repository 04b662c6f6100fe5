// Paged-KV attention of the serving decode, chunked-prefill, prefix-hit and
// speculative-verify steps, for Hopper (sm_90a).
//
// Replaces the non-fresh route of paddle_tpu/incubate/nn/functional/
// __init__.py::block_multihead_attention (:733-761; int8 pages :738-746),
// which the TPU package leaves to XLA (no Pallas kernel): each token t of
// batch row b = t2b[t], at cache position pos[t], attends its own row's
// cache positions 0..pos[t] (at most max_seq of them) in its kv-head group
// (GQA: query head h reads kv head h / G, G = HQ / HKV). K and V are read
// from the layer's page pool [num_blocks, HKV, block_size, D] through the
// block table, key j of row b at page block_tables[b, j / block_size], slot
// j % block_size; no gathered copy is made. The reference's rounding:
// logits from the cache dtype's operands with f32 accumulation, divided by
// sqrt(D); softmax in f32; the probabilities rounded to the cache dtype
// AFTER normalisation; P V accumulated in f32 and cast to the cache dtype.
// Padding tokens (the engine's trash row, whose table row is all page 0)
// may sit at positions past max_seq; their keys stop at max_seq, so no
// read leaves the pool.
//
// Bound: bytes. A row's K and V are read once however many of its tokens
// the step holds (at the decode shape, 8 rows at positions 18-177, HKV 8,
// D 128, bf16: ~2.5 MB, 0.77 us at 3.35 TB/s; a 256-token chunked step
// 2.4 MB of K and V and 2.1 MB of q and out, 1.34 us). The operations, 4 D
// a (token, query head, key) at the bf16 tensor-core rate, take less: the
// chunked step's 0.24 GFLOP 0.25 us at 989 TFLOP/s.
//
// bf16 pages, and int8 pages with bf16 q (paged_attention_tc_kernel):
// one block a (query tile, kv head, pair of its query heads), 256 threads.
// A tile is up to kTileTokens = 32 consecutive tokens of one batch row (the
// engine packs a row's tokens together); its rows are token x head, up to
// 64. Against what held the earlier design (a block a token) back:
//  1. A row's keys were read once a token. Here a tile's tokens share one
//     read of the row's pages: a 120-token chunk reads them 4 times, not
//     120. The grid, min(ceil(T / 32) + B, T) tiles by HKV x head pairs,
//     depends on the shapes only, so a CUDA graph captures it. Each block
//     finds its tile by a ballot scan of t2b (a tile starts where a run of
//     one t2b value starts and every 32 tokens after); a block with no
//     tile exits, and any t2b is taken: blocks stride over the tiles when
//     there are more than the grid.
//  2. Q K was computed twice from device memory. Here the logits S of the
//     whole tile stay in shared memory (64 rows x up to 192 keys of f32 at
//     D <= 128, 96 at D 256); a row's max, sum and P come from them in one
//     pass held in registers (P rounded after normalising, the reference's
//     order), so no logit is computed twice. A longer row streams K through
//     the ring for the max and the sum (an online pair a row) and again,
//     with V, for P V: the one case that computes its logits twice.
//  3. Each key's dot was one thread's chain of D f32 FMAs. Here S = Q K^T
//     and O = P V run on the tensor cores (mma.sync m16n8k16, operands by
//     ldmatrix, f32 accumulators); the warps split a chunk's keys (S) or D
//     (P V) 8, 4 or 2 ways as the tile has 16, 32 or 64 rows. Every
//     ldmatrix and mma runs unconditionally, counts fixed at compile time
//     for each of those splits: the compiler must re-converge the warp
//     (WARPSYNC and a stall) before each such .aligned instruction under a
//     branch, and with per-tile guards that cost ~450 cycles a depth step,
//     more than the products.
//  4. P V summed 32 slot partials serially. Here each warp owns its output
//     columns: no partials, no atomics; every sum runs in a fixed order,
//     so a call gives the same bits on every run.
//  5. Each key was a chain of table, page and row loads. Here the tile scan
//     and the block tables come in one round of loads, then every page the
//     tile needs (up to 6 chunks of 64 keys, K and V) is issued at once by
//     16-byte cp.async into a ring of shared-memory slots: one device-memory
//     round trip.
// Int8 pages land as codes (8-byte cp.async) and f32 scales, and are
// dequantized once, as they are consumed, into bf16 tiles: the code times
// its slot's scale in f32, rounded to bf16, the reference's dequantized
// view. Everything after is the bf16 path, so the int8 kernel gives the
// bits of the bf16 kernel over pages holding those values. The logits are
// divided by sqrt(D) correctly rounded (a reciprocal with one FMA
// correction: the bits of the IEEE division); exp is 2^x by the MUFU and
// the normalisation a multiply by 1 / l, before P's rounding to bf16.
//
// f32 pages, and int8 pages with f32 q (paged_attention_kernel): the f32
// parity runs need full-f32 products, which the tensor cores lack, so they
// keep the earlier CUDA-core design as it was. One block a (token, kv head,
// group of up to 4 of its query heads), 256 threads; two passes over the
// token's keys: the first for the max and the sum (an online pair a thread,
// merged in a fixed order), the second recomputing Q K for the normalised P
// and P V. The logits a key a thread (its row of K read in 16-byte loads,
// q from shared memory); pass 2 writes P for a chunk of 256 keys to shared
// memory, then forms P V with P lanes of a group across D and the groups
// across the chunk's keys, summed in shared memory in a fixed order. The
// row's block table is copied to shared memory once (up to 256 entries).
// Over int8 pages each K and V element is the code times its slot's scale
// in f32, rounded to q's dtype, as above.
#include <algorithm>
#include <cmath>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kTable = 256;      // block-table entries a block keeps shared

// 8 consecutive elements as loaded (32 bytes of f32, 8 of int8 codes), kept
// raw until used so that more keys' loads fit in flight.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 a, b;
};
template <>
struct Raw<int8_t> {
  uint2 u;
};

__device__ __forceinline__ Raw<float> load8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

__device__ __forceinline__ Raw<int8_t> load8(const int8_t* p) {
  return {__ldg(reinterpret_cast<const uint2*>(p))};
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


// ---------------------------------------------------------------------------
// bf16 q: the tensor-core kernel over bf16 or int8 pages.
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 32;                    // tokens a tile
constexpr int kHeads = 2;                          // query heads a block
constexpr int kRows = kTileTokens * kHeads;        // rows of Q, S and O
constexpr int kSlots = 6;                          // chunks of K or V staged
constexpr int kTable = 1024;       // block tables kept shared, entries at most

// Shared memory of one instantiation: the Q tile, S (f32), P (bf16), the
// ring of K/V slots (bf16 tiles, or int8 codes and their scales), and for
// int8 the bf16 tiles the slots are dequantized into (a kept row's every
// K, then V, chunk). Tile rows are padded by 8 elements (16 bytes), S rows
// by 4 floats and P rows by 8 elements, so that ldmatrix's 8 row addresses
// and the fragments' stores fall on distinct banks.
template <typename C, int DP>
struct Layout {
  static constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  static constexpr int KC = DP > 128 ? 32 : 64;    // keys a chunk
  static constexpr int kKeep = kSlots / 2;         // chunks whose S stays
  static constexpr int ROW = DP + 8;               // bf16 a tile row
  static constexpr int SS = kKeep * KC + 4;        // floats an S row
  static constexpr int PS = kKeep * KC + 8;        // bf16 a P row
  static constexpr int kTileBytes = KC * ROW * 2;
  static constexpr int kSlotBytes = kInt8 ? KC * DP + KC * 4 : kTileBytes;
  static constexpr int kQ = 0;
  static constexpr int kS = kQ + kRows * ROW * 2;
  static constexpr int kP = kS + kRows * SS * 4;
  static constexpr int kSlot0 = kP + kRows * PS * 2;
  static constexpr int kWork = kSlot0 + kSlots * kSlotBytes;
  static constexpr int kBytes = kWork + (kInt8 ? kKeep * kTileBytes : 0);
  static_assert(kS % 16 == 0 && kP % 16 == 0 && kSlot0 % 16 == 0 &&
                    kWork % 16 == 0 && (PS * 2) % 16 == 0 &&
                    kSlotBytes % 16 == 0 && (SS * 4) % 16 == 0,
                "16-byte aligned regions");
  static_assert(KC * DP / 8 <= 4 * kThreads, "at most 4 keys a lane a copy");
};

// 8 int8 codes times their slot's scale in f32, each rounded to bf16 (the
// reference's dequantized view), packed as 16 bytes. A code becomes its
// float exactly without I2F (a quarter-rate instruction): biased to
// unsigned (xor 0x80) and placed in the low mantissa byte of 2^23 by a byte
// permute, 2^23 + 128 subtracted.
__device__ __forceinline__ uint4 dequant8(uint2 codes, float s) {
  float f[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t u = (h ? codes.y : codes.x) ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * h + k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) -
                     8388736.f;
  }
  uint4 r;
  r.x = pt::pack_bf16(f[0] * s, f[1] * s);
  r.y = pt::pack_bf16(f[2] * s, f[3] * s);
  r.z = pt::pack_bf16(f[4] * s, f[5] * s);
  r.w = pt::pack_bf16(f[6] * s, f[7] * s);
  return r;
}

// The block's tile'th tile of the step, as (first token, tokens, keys n)
// into info and its batch row into *row, first token -1 when there is
// none; all threads call it. A tile starts where a run of equal t2b starts
// and every kTileTokens tokens of the run after; its tokens are the run's
// from there, at most kTileTokens; n is the most keys a token of it reads.
// The tokens' positions, clamped to max_seq, go to tpos. t2b and pos come
// in 256 tokens at a time (one load a thread, into sb and sp), and warp 0
// scans them 32 at a time by ballots. A block runs its code once, so the
// loops stay rolled: its instructions are fetched once each.
__device__ __forceinline__ void find_tile(const int64_t* __restrict__ t2b,
                                          const int64_t* __restrict__ pos,
                                          int T, int max_seq, int tile,
                                          int* info, int* row, int* tpos,
                                          int* sb, int* sp) {
  const unsigned all = 0xffffffffu;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const auto clamped = [&](int64_t p) {
    return static_cast<int>(p < max_seq ? p : max_seq);
  };
  int seen = 0, run0 = 0, prev = -1;               // warp 0's scan state
  if (tid == 0) info[0] = -1;
  for (int c0 = 0; c0 < T; c0 += kThreads) {
    const int t = c0 + tid;
    sb[tid] = t < T ? static_cast<int>(__ldg(t2b + t)) : -2;
    sp[tid] = t < T ? clamped(__ldg(pos + t)) : 0;
    __syncthreads();
    if (tid < 32) {
      int found = -1;
#pragma unroll 1
      for (int c = c0; c < min(T, c0 + kThreads) && found < 0; c += 32) {
        const int b = sb[c - c0 + lane];
        int up = __shfl_up_sync(all, b, 1);
        if (lane == 0) up = prev;
        const unsigned runs = __ballot_sync(all, c + lane < T && b != up);
        const unsigned le = runs & (all >> (31 - lane));
        const int r0 = le ? c + 31 - __clz(le) : run0;
        const unsigned starts = __ballot_sync(
            all, c + lane < T && (c + lane - r0) % kTileTokens == 0);
        const int cnt = __popc(starts);
        if (seen + cnt > tile) {
          unsigned m = starts;
          for (int k = tile - seen; k > 0; --k) m &= m - 1;
          found = c + __ffs(m) - 1;
        }
        seen += cnt;
        prev = __shfl_sync(all, b, 31);
        run0 = __shfl_sync(all, r0, 31);
      }
      if (found >= 0) {
        // lane k: token found + k, from shared memory or past it
        const int tk = found + lane;
        const int k = tk - c0;
        int bv = -2, pv = 0;
        if (tk < T) {
          bv = k < kThreads ? sb[k] : static_cast<int>(__ldg(t2b + tk));
          pv = k < kThreads ? sp[k] : clamped(__ldg(pos + tk));
        }
        const int b0 = __shfl_sync(all, bv, 0);
        const unsigned same = __ballot_sync(all, bv == b0);
        const int count = ~same ? __ffs(~same) - 1 : 32;
        int keys = lane < count ? min(pv + 1, max_seq) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          keys = max(keys, __shfl_xor_sync(all, keys, off));
        if (lane < count) tpos[lane] = pv;
        if (lane == 0) {
          info[0] = found;
          info[1] = count;
          info[2] = keys;
          *row = b0;
        }
      }
    }
    __syncthreads();
    if (info[0] >= 0) return;
  }
}

// C: the pools' element (bf16, or int8 with the f32 scale pools ksc, vsc);
// DP: D's class (64, 128, 256), which sizes shared memory.
template <typename C, int DP>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_tc_kernel(
    const bf16* __restrict__ q, const C* __restrict__ kp,
    const C* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, bf16* __restrict__ out,
    const int64_t* __restrict__ t2b, const int64_t* __restrict__ pos,
    const int64_t* __restrict__ bt, int T, int HQ, int HKV, int D, int bs,
    int max_blocks, int B, float scale_div) {
  using Lay = Layout<C, DP>;
  constexpr bool kInt8 = Lay::kInt8;
  constexpr int KC = Lay::KC, ROW = Lay::ROW, SS = Lay::SS, PS = Lay::PS;
  constexpr int kKeyTiles = KC / 8;                 // n-tiles of a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int tpos[kTileTokens];
  __shared__ float row_m[kRows], row_l[kRows];
  __shared__ int info[3];
  __shared__ int tile_row;
  __shared__ int scan_b[kThreads], scan_p[kThreads];
  __shared__ int table[kTable];               // the block tables, if they fit
  __shared__ int slots_of[Lay::kKeep * KC];   // a key's (page, head, slot)
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::kQ);
  float* S = reinterpret_cast<float*>(smem + Lay::kS);
  bf16* P = reinterpret_cast<bf16*>(smem + Lay::kP);
  unsigned char* slots = smem + Lay::kSlot0;
  bf16* work = reinterpret_cast<bf16*>(smem + Lay::kWork);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = HQ / HKV;
  const int pairs = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.y / pairs;
  const int h0 = kvh * G + (blockIdx.y % pairs) * kHeads;
  const int nh = min(kHeads, kvh * G + G - h0);
  const int max_seq = max_blocks * bs;
  const int DU = D / 8;                   // 16-byte (int8: 8-byte) units
  // copies: a warp takes 32 / DUp keys at a time, lane cu of a key its
  // unit cu (DUp: DU rounded up to a power of two)
  const int du_log = 32 - __clz(DU - 1);
  const int du_lane = lane & ((1 << du_log) - 1);
  const int du_key = lane >> du_log;
  const int du_keys = kWarps * (32 >> du_log);

  // zero the columns [D, DP) of the Q tile and of every K/V tile, which Q
  // K^T's depth steps and P V's column tiles span and no copy writes (P V's
  // columns from D on are not stored)
  for (int u = tid; u < (kRows + (kInt8 ? Lay::kKeep : kSlots) * KC) *
                            ((DP - D) / 8);
       u += kThreads) {
    const int r = u / ((DP - D) / 8);
    const int c = D + (u - r * ((DP - D) / 8)) * 8;
    bf16* row = r < kRows ? qs + r * ROW
                          : (kInt8 ? work : reinterpret_cast<bf16*>(slots)) +
                                (r - kRows) * ROW;
    *reinterpret_cast<uint4*>(row + c) = make_uint4(0, 0, 0, 0);
  }

  // every row's block table in shared memory when they fit: loaded into
  // registers first, in flight beside the first tile scan's loads, and
  // stored after it
  const bool table_shared = B * max_blocks <= kTable;
  int table_part[kTable / kThreads];
#pragma unroll
  for (int k = 0; k < kTable / kThreads; ++k) {
    const int i = tid + k * kThreads;
    table_part[k] =
        table_shared && i < B * max_blocks ? static_cast<int>(__ldg(bt + i))
                                           : 0;
  }

#pragma unroll 1
  for (int tile = blockIdx.x;; tile += gridDim.x) {
    find_tile(t2b, pos, T, max_seq, tile, info, &tile_row, tpos, scan_b,
              scan_p);
    const int start = info[0];
    if (start < 0) break;
    if (tile == blockIdx.x) {
#pragma unroll
      for (int k = 0; k < kTable / kThreads; ++k)
        table[tid + k * kThreads] = table_part[k];
      __syncthreads();
    }
    const int count = info[1];
    const int n = info[2];
    const int64_t* row_bt = bt + static_cast<int64_t>(tile_row) * max_blocks;
    const int M = count * nh;                       // live rows
    const int nch = (n + KC - 1) / KC;              // chunks of keys
    const bool keep = nch <= Lay::kKeep;
    const int items = keep ? 2 * nch : 3 * nch;     // copies of K or V

    // Q first, its own cp.async group
    for (int u = tid; u < M * DU; u += kThreads) {
      const int r = u / DU;
      const int cu = u - r * DU;
      const int tok = r / nh;
      const bf16* src =
          q + (static_cast<size_t>(start + tok) * HQ + h0 + r - tok * nh) * D;
      pt::cp_async16(qs + r * ROW + cu * 8, src + cu * 8);
    }
    pt::cp_async_commit();
    for (int r = tid; r < kRows; r += kThreads) {
      row_m[r] = -INFINITY;
      row_l[r] = 0.f;
    }
    // each of the first keys' (page, head, slot) index, in shared memory
    // (one round of loads; the copies then read no table from device
    // memory); a streaming row's later keys read the table as they go
    const int kept = min(n, Lay::kKeep * KC);
    for (int j = tid; j < kept; j += kThreads) {
      const int64_t page = table_shared ? table[tile_row * max_blocks + j / bs]
                                        : __ldg(row_bt + j / bs);
      slots_of[j] = static_cast<int>((page * HKV + kvh) * bs + j % bs);
    }
    __syncthreads();
    auto slot_of = [&](int j) -> size_t {
      if (j < kept) return static_cast<size_t>(slots_of[j]);
      return (static_cast<size_t>(__ldg(row_bt + j / bs)) * HKV + kvh) * bs +
             j % bs;
    };
    // copy i: keep: K chunks 0..nch-1, then V chunks; streaming: K chunks,
    // then K and V of each chunk in turn
    auto copy_of = [&](int i, int& chunk, int& is_v) {
      if (i < nch) {
        chunk = i, is_v = 0;
      } else if (keep) {
        chunk = i - nch, is_v = 1;
      } else {
        chunk = (i - nch) >> 1, is_v = (i - nch) & 1;
      }
    };
    int issued = 0;
    // copies up to kSlots ahead of the last one consumed (i), each its own
    // cp.async group, after a __syncthreads that ends every read of copy
    // i's slot (-1: none consumed yet)
    auto refill = [&](int i) {
#pragma unroll 1
      for (; issued < items && issued < i + 1 + kSlots; ++issued) {
        int chunk, is_v;
        copy_of(issued, chunk, is_v);
        const C* pool = is_v ? vp : kp;
        unsigned char* dst = slots + (issued % kSlots) * Lay::kSlotBytes;
        if (du_lane < DU) {
          // a lane's keys kk0, kk0 + du_keys, ... (at most 4): their slots
          // first, all loads in flight, then the copies
          const int kk0 = warp * (32 >> du_log) + du_key;
          size_t sl[4];
#pragma unroll
          for (int it = 0; it < 4; ++it) {
            const int j = chunk * KC + kk0 + it * du_keys;
            sl[it] = kk0 + it * du_keys < KC && j < n ? slot_of(j) : 0;
          }
#pragma unroll
          for (int it = 0; it < 4; ++it) {
            const int kk = kk0 + it * du_keys;
            const bool in = kk < KC && chunk * KC + kk < n;
            if (kk >= KC) break;
            if constexpr (kInt8)
              pt::cp_async8_zfill(dst + kk * DP + du_lane * 8,
                                  pool + sl[it] * D + du_lane * 8, in);
            else
              pt::cp_async16_zfill(
                  reinterpret_cast<bf16*>(dst) + kk * ROW + du_lane * 8,
                  pool + sl[it] * D + du_lane * 8, in);
          }
        }
        if constexpr (kInt8) {
          const float* sp = is_v ? vsc : ksc;
          float* sd = reinterpret_cast<float*>(dst + KC * DP);
          for (int kk = tid; kk < KC; kk += kThreads) {
            const int j = chunk * KC + kk;
            const bool in = j < n;
            pt::cp_async4_zfill(sd + kk, sp + (in ? slot_of(j) : 0), in);
          }
        }
        pt::cp_async_commit();
      }
    };
    // copies [i0, i1) landed and visible to the block; int8: dequantized
    // into the work tiles, copy i0 + c into tile c
    auto land = [&](int i0, int i1) {
      pt::cp_async_wait_upto(issued - i1);
      __syncthreads();
      if constexpr (kInt8) {
        if (du_lane < DU)
#pragma unroll 1
          for (int i = i0; i < i1; ++i) {
            const unsigned char* src = slots + (i % kSlots) * Lay::kSlotBytes;
            const float* sc = reinterpret_cast<const float*>(src + KC * DP);
            bf16* dst = work + (i - i0) * KC * ROW;
            // a lane's (at most 4) keys at once: their loads in flight
            // together
            const int kk0 = warp * (32 >> du_log) + du_key;
            uint2 codes[4];
            float scale[4];
#pragma unroll
            for (int it = 0; it < 4; ++it) {
              const int kk = min(kk0 + it * du_keys, KC - 1);
              codes[it] = *reinterpret_cast<const uint2*>(src + kk * DP +
                                                          du_lane * 8);
              scale[it] = sc[kk];
            }
#pragma unroll
            for (int it = 0; it < 4; ++it) {
              const int kk = kk0 + it * du_keys;
              if (kk < KC)
                *reinterpret_cast<uint4*>(dst + kk * ROW + du_lane * 8) =
                    dequant8(codes[it], scale[it]);
            }
          }
        __syncthreads();
      }
    };
    // chunk c's K or V tile once copies [i0, ..) have landed, c counted
    // from copy i0's chunk
    auto tile_of = [&](int i0, int c) -> const bf16* {
      if constexpr (kInt8) return work + c * KC * ROW;
      return reinterpret_cast<const bf16*>(slots + ((i0 + c) % kSlots) *
                                                       Lay::kSlotBytes);
    };

    constexpr float kLog2e = 1.4426950408889634f;
    // x / sqrt(D), correctly rounded (the same bits as the IEEE division):
    // the quotient by the rounded reciprocal, corrected by one FMA of its
    // exact residual (Markstein), three instructions where the division
    // takes a checked sequence with a slow path
    const float rcp_d = 1.f / scale_div;
    auto div_sqrt_d = [&](float x) {
      const float q0 = x * rcp_d;
      return fmaf(fmaf(-q0, scale_div, x), rcp_d, q0);
    };

    // The products, for W warps a 16-row group (8, 4 or 2: fewer row
    // groups, more ways to split a chunk's keys in Q K^T and D in P V).
    // Every ldmatrix and mma runs unconditionally, a count fixed at compile
    // time: under a branch the compiler must re-converge the warp before
    // each of these .aligned instructions (a WARPSYNC and a stall apiece),
    // which cost more than the products.
    auto products = [&](auto ways) {
      constexpr int W = decltype(ways)::value;
      constexpr int kGroups = kWarps / W;
      constexpr int TPC = kKeyTiles >= W ? kKeyTiles / W : 1;  // tiles/chunk
      constexpr int DPW = DP / 8 / W;            // column tiles a warp
      const int rg = warp % kGroups;
      const int part = warp / kGroups;
      const bool rows_live = rg * 16 < M && part * TPC < kKeyTiles;
      const uint32_t qaddr = pt::smem_addr(qs + (rg * 16 + (lane & 15)) * ROW +
                                           (lane >> 4) * 8);

      // S[:, 0..cols) of the live rows, keys key0 + column: the logits
      // divided by sqrt(D), -inf where masked (a key beyond the token's
      // position or the tile's n); fold them into the rows' (max, sum of
      // exp(s - max)); and / or write P = round_bf16(exp(s - m) / l) (exp
      // as 2^x by the MUFU, the normalisation a multiply by 1 / l). A row's
      // values sit in the registers of a group of ACROSS lanes (16, 8 or 4:
      // the block's 8 warps cover 16, 32 or 64 rows), which sum in a fixed
      // order.
      constexpr int ACROSS = W == 8 ? 16 : W == 4 ? 8 : 4;
      constexpr int VALS = Lay::kKeep * KC / ACROSS;
      const int srow = warp * (32 / ACROSS) + lane / ACROSS;
      const int scol = lane % ACROSS;
      auto softmax = [&](int cols, int key0, bool fold, bool normalise) {
        const bool live = srow < M;
        const int p = live ? tpos[srow / nh] : -1;
        const float* sr = S + (live ? srow : 0) * SS + scol;
        float v[VALS];
#pragma unroll
        for (int k = 0; k < VALS; ++k) {
          const int key = key0 + scol + k * ACROSS;
          v[k] = k * ACROSS < cols && key < n && key <= p
                     ? div_sqrt_d(sr[k * ACROSS])
                     : -INFINITY;
        }
        float m = live ? row_m[srow] : -INFINITY;
        float l = live ? row_l[srow] : 0.f;
        if (fold) {
          float mc = -INFINITY;
#pragma unroll
          for (int k = 0; k < VALS; ++k) mc = fmaxf(mc, v[k]);
#pragma unroll
          for (int off = ACROSS / 2; off > 0; off >>= 1)
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
          const float mn = fmaxf(m, mc);
          const float mb = mn * kLog2e;
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < VALS; ++k)
            sum += pt::exp2_approx(fmaf(v[k], kLog2e, -mb));
#pragma unroll
          for (int off = ACROSS / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (mn != -INFINITY) {
            l = l * pt::exp2_approx(fmaf(m, kLog2e, -mb)) + sum;
            m = mn;
          }
          if (live && scol == 0) row_m[srow] = m, row_l[srow] = l;
        }
        if (normalise && live) {
          bf16* pr = P + srow * PS + scol;
          const bool none = m == -INFINITY;       // no key: P = 0
          const float mb = none ? 0.f : m * kLog2e;
          const float inv = none ? 0.f : 1.f / l;
#pragma unroll
          for (int k = 0; k < VALS; ++k)
            if (k * ACROSS < cols)
              pr[k * ACROSS] = __float2bfloat16_rn(
                  pt::exp2_approx(fmaf(v[k], kLog2e, -mb)) * inv);
        }
      };

      // S[:, col0 + ..] of NC chunks (their K tiles from copy i0 on; a
      // chunk past the row's last holds other data, and its columns of S
      // are not read): the raw Q K^T, key tiles part + W t of each chunk
      auto logits = [&](auto nc, int i0, int col0) {
        constexpr int NC = decltype(nc)::value;
        if (!rows_live) return;
        uint32_t kaddr[NC][TPC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int t = 0; t < TPC; ++t)
            kaddr[c][t] = pt::smem_addr(
                tile_of(i0, c) + ((part + W * t) * 8 + (lane & 7)) * ROW +
                ((lane >> 3) & 1) * 8);
        float acc[NC][TPC][4];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int t = 0; t < TPC; ++t)
            acc[c][t][0] = acc[c][t][1] = acc[c][t][2] = acc[c][t][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          uint32_t a[4], b[NC][TPC][2];
          pt::ldsm_x4(a, qaddr + ks * 32);
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int t = 0; t < TPC; ++t)
              pt::ldsm_x2(b[c][t], kaddr[c][t] + ks * 32);
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int t = 0; t < TPC; ++t)
              pt::mma_16816(acc[c][t], a, b[c][t]);
        }
        float* sr = S + (rg * 16 + (lane >> 2)) * SS + col0 + 2 * (lane & 3);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int t = 0; t < TPC; ++t) {
            float* d = sr + c * KC + (part + W * t) * 8;
            *reinterpret_cast<float2*>(d) =
                make_float2(acc[c][t][0], acc[c][t][1]);
            *reinterpret_cast<float2*>(d + 8 * SS) =
                make_float2(acc[c][t][2], acc[c][t][3]);
          }
      };
      // O += P[:, pcol0 + ..] V over `steps` steps of 16 keys (their V
      // tiles from copy i0 on); column tiles part + W i, all of D's class
      // (the ones past D are not stored). The next step's fragments load
      // while this one multiplies (the last step's twice: no branch).
      float o[DPW][4];
#pragma unroll
      for (int i = 0; i < DPW; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
      const bool cols_live = rg * 16 < M;
      auto pv = [&](int i0, int steps, int pcol0) {
        if (!cols_live || steps <= 0) return;
        const uint32_t paddr = pt::smem_addr(
            P + (rg * 16 + (lane & 15)) * PS + pcol0 + (lane >> 4) * 8);
        uint32_t a[4], b[DPW][2], na[4], nb[DPW][2];
        auto load = [&](int ks, uint32_t (&fa)[4], uint32_t (&fb)[DPW][2]) {
          const uint32_t vaddr = pt::smem_addr(
              tile_of(i0, ks / (KC / 16)) +
              ((ks % (KC / 16)) * 16 + (lane & 15)) * ROW + part * 8);
          pt::ldsm_x4(fa, paddr + ks * 32);
#pragma unroll
          for (int i = 0; i < DPW; ++i)
            pt::ldsm_x2_trans(fb[i], vaddr + i * W * 16);
        };
        load(0, a, b);
#pragma unroll 1
        for (int ks = 0; ks < steps; ++ks) {
          load(min(ks + 1, steps - 1), na, nb);
#pragma unroll
          for (int i = 0; i < DPW; ++i) pt::mma_16816(o[i], a, b[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = na[e];
#pragma unroll
          for (int i = 0; i < DPW; ++i) b[i][0] = nb[i][0], b[i][1] = nb[i][1];
        }
      };

      if (keep) {
        // every copy is in flight at once (K chunks, then V chunks): S of
        // the whole row, its max and sum and P, then P V
        refill(-1);
        land(0, nch);
        logits(std::integral_constant<int, Lay::kKeep>{}, 0, 0);
        __syncthreads();
        softmax(nch * KC, 0, true, true);
        land(nch, 2 * nch);
        pv(nch, (n + 15) / 16, 0);
      } else {
        // a chunk at a time: the max and sum over K, then K again and V
#pragma unroll 1
        for (int i = 0; i < items; ++i) {
          refill(i - 1);
          int chunk, is_v;
          copy_of(i, chunk, is_v);
          land(i, i + 1);
          if (is_v) {
            pv(i, min(KC, n - chunk * KC + 15) / 16, 0);
          } else {
            logits(std::integral_constant<int, 1>{}, i, 0);
            __syncthreads();
            softmax(KC, chunk * KC, i < nch, i >= nch);
          }
          __syncthreads();
        }
      }

      if (cols_live) {
        bf16* orow[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rg * 16 + (lane >> 2) + h * 8;
          const int tok = r / nh;
          orow[h] = r < M ? out +
                                (static_cast<size_t>(start + tok) * HQ + h0 +
                                 r - tok * nh) * D +
                                2 * (lane & 3)
                          : nullptr;
        }
#pragma unroll
        for (int i = 0; i < DPW; ++i) {
          const int d = part + W * i;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (d < DU && orow[h])
              *reinterpret_cast<uint32_t*>(orow[h] + d * 8) =
                  pt::pack_bf16(o[i][2 * h], o[i][2 * h + 1]);
        }
      }
    };
    const int groups = (M + 15) / 16;
    if (groups <= 1)
      products(std::integral_constant<int, 8>{});
    else if (groups <= 2)
      products(std::integral_constant<int, 4>{});
    else
      products(std::integral_constant<int, 2>{});
    __syncthreads();          // before the next tile's scan and copies
  }
}

template <typename C, int DP>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(paged_attention_tc_kernel<C, DP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<C, DP>::kBytes);
}

// Every instantiation's dynamic shared memory (above the default 48 KB),
// set once, at the library's first call, before any graph capture.
cudaError_t set_smem_once() {
  static const cudaError_t err = [] {
    for (cudaError_t e :
         {set_smem<bf16, 64>(), set_smem<bf16, 128>(), set_smem<bf16, 256>(),
          set_smem<int8_t, 64>(), set_smem<int8_t, 128>(),
          set_smem<int8_t, 256>()})
      if (e != cudaSuccess) return e;
    return cudaSuccess;
  }();
  return err;
}

template <typename C, int DP>
cudaError_t launch(const void* q, const C* k, const C* v, const float* ks,
                   const float* vs, void* out, const int64_t* t2b,
                   const int64_t* pos, const int64_t* bt, int T_, int HQ,
                   int HKV, int D, int bs, int max_blocks, int B,
                   float scale_div, cudaStream_t s) {
  const int G = HQ / HKV;
  const int tiles = std::min((T_ + kTileTokens - 1) / kTileTokens + B, T_);
  const dim3 grid(tiles, HKV * ((G + kHeads - 1) / kHeads));
  paged_attention_tc_kernel<C, DP>
      <<<grid, kThreads, Layout<C, DP>::kBytes, s>>>(
          static_cast<const bf16*>(q), k, v, ks, vs, static_cast<bf16*>(out),
          t2b, pos, bt, T_, HQ, HKV, D, bs, max_blocks, B, scale_div);
  return cudaGetLastError();
}

template <typename C>
cudaError_t by_width(const void* q, const C* k, const C* v, const float* ks,
                     const float* vs, void* out, const int64_t* t2b,
                     const int64_t* pos, const int64_t* bt, int T_, int HQ,
                     int HKV, int D, int bs, int max_blocks, int B,
                     float scale_div, cudaStream_t s) {
  const cudaError_t err = set_smem_once();
  if (err != cudaSuccess) return err;
  if (D <= 64)
    return launch<C, 64>(q, k, v, ks, vs, out, t2b, pos, bt, T_, HQ, HKV, D,
                         bs, max_blocks, B, scale_div, s);
  if (D <= 128)
    return launch<C, 128>(q, k, v, ks, vs, out, t2b, pos, bt, T_, HQ, HKV, D,
                          bs, max_blocks, B, scale_div, s);
  return launch<C, 256>(q, k, v, ks, vs, out, t2b, pos, bt, T_, HQ, HKV, D,
                        bs, max_blocks, B, scale_div, s);
}

}  // namespace tc

}  // namespace

// out [T, HQ, D] = paged attention of q [T, HQ, D] over one layer's pools
// k, v [num_blocks, HKV, bs, D] (the cache dtype: pt::kFloat32 or
// pt::kBFloat16), t2b and pos [T] int64, block tables bt [B, max_blocks]
// int64. Refuses (cudaErrorInvalidValue) D not a multiple of 8 or above
// 256, HKV not dividing HQ, a non-positive size, and a pointer that is not
// 16-byte aligned. bf16 runs the tensor-core kernel, f32 the CUDA-core one.
extern "C" int pt_paged_attention(const void* q, const void* k, const void* v,
                                  void* out, const void* t2b, const void* pos,
                                  const void* bt, int T_, int HQ, int HKV,
                                  int D, int bs, int max_blocks, int B,
                                  int dtype, float scale_div, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t bad = check_args(q, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                                     max_blocks, scale_div);
  if (bad != cudaSuccess) return bad;
  if (B <= 0) return cudaErrorInvalidValue;
  for (const void* ptr : {k, v})
    if (ptr == nullptr || !aligned(ptr, 16)) return cudaErrorInvalidValue;
  const int64_t* tb = static_cast<const int64_t*>(t2b);
  const int64_t* ps = static_cast<const int64_t*>(pos);
  const int64_t* tab = static_cast<const int64_t*>(bt);
  if (dtype == pt::kBFloat16)
    return tc::by_width<__nv_bfloat16>(
        q, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), nullptr, nullptr, out, tb, ps,
        tab, T_, HQ, HKV, D, bs, max_blocks, B, scale_div, s);
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
                                       int B, int dtype, float scale_div,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t bad = check_args(q, out, t2b, pos, bt, T_, HQ, HKV, D, bs,
                                     max_blocks, scale_div);
  if (bad != cudaSuccess) return bad;
  if (B <= 0) return cudaErrorInvalidValue;
  for (const void* ptr : {k, v})
    if (ptr == nullptr || !aligned(ptr, 8)) return cudaErrorInvalidValue;
  for (const void* ptr : {ks, vs})
    if (ptr == nullptr || !aligned(ptr, 4)) return cudaErrorInvalidValue;
  const int64_t* tb = static_cast<const int64_t*>(t2b);
  const int64_t* ps = static_cast<const int64_t*>(pos);
  const int64_t* tab = static_cast<const int64_t*>(bt);
  if (dtype == pt::kBFloat16)
    return tc::by_width<int8_t>(
        q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs), out, tb,
        ps, tab, T_, HQ, HKV, D, bs, max_blocks, B, scale_div, s);
  if (dtype == pt::kFloat32) {
    const Pools<int8_t> pl{static_cast<const int8_t*>(k),
                           static_cast<const int8_t*>(v),
                           static_cast<const float*>(ks),
                           static_cast<const float*>(vs)};
    return by_width<float>(q, pl, out, tb, ps, tab, T_, HQ, HKV, D, bs,
                           max_blocks, scale_div, s);
  }
  return cudaErrorInvalidValue;
}
