// Fused int8 KV quantise + EXTENT erased-row store, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kv_quant/kernel.py::kv_quant_kernel.
// It computes the same function. The tensor is read as one flat vector of
// n float32 or bfloat16 values, zero-padded to whole blocks of 64 x 128 =
// 8192 elements (the reference's (rows, 128) layout with 64-row blocks, so
// block i holds flat elements [8192 i, 8192 (i + 1))). Per block:
//   scale  = max(absmax, 1e-12) * (1/127 rounded to float32)
//   q      = clip(round_half_even(x / scale), -127, 127)   (IEEE division)
// (the reference's scale divides by the constant 127, which XLA rewrites
// into that product; its x / scale is a true division)
// and the two's-complement byte of q is stored through the erased-row
// write model: only set bits can fail, bit b of element e failing when
//   uniform_bits(seed, e, b) < thr[b]
// (the counter hash of counter_hash.cuh over the flat padded index). The
// stored byte is q ^ fail_mask; the block's error count is its failed bits.
//
// Bound: integer issue, not memory. Each element is read once (4 or 2
// bytes) and its payload written once (1 byte): a bfloat16 K or V leaf of
// recurrentgemma-2b's served cache (8, 4, 2048, 1, 256) is 16.8 M
// elements, 50 MB, 0.015 ms at 3.35 TB/s. But every set payload bit costs
// a counter-hash draw of 8 integer instructions (draw_key and collect),
// about 4 draws an element (a negative byte sets 5-8 bits, a small
// positive one 1-3). Five of the 8 (three LOP3, SHF, IADD3) run on the
// integer ALU and three (two IMAD, IMAD.X) on the FMA pipe, each 64 lanes
// a clock per SM, so the ALU sets the pace: ~335 M ALU instructions,
// 0.020 ms on 132 SMs at 1.98 GHz.
//
// Design, against that bound:
//   - Every plane of every element is drawn, unrolled with compile-time
//     plane constants, and the set bits are picked afterwards
//     (fail &= q). That is 8 draws an element where ~4 are needed, but
//     every lane of a warp runs the same draws. Walking only the set bits
//     made a warp run as many steps as its densest lane (7-8 an element,
//     with a loop's overhead on each); a per-lane stream over the set bits
//     of 4-byte words, and a per-warp queue of (element, plane) pairs
//     (extent_write.cu's scheme), draw only ~4 but spend as many
//     instructions on finding, routing and indexing each draw as the draw
//     itself. On an H100 the unrolled form took about half the time of
//     either.
//   - Folded draws (counter_hash.cuh): fold(e * kElem) once per element;
//     fold(seed) ^ fold(b * kBit) once per plane, uniform across the
//     grid; the threshold compare on draw_key, without fmix32's last
//     shift. A draw is then ^, *, >>, ^, *, ^ and the compare.
//   - The compare feeds a carry (counter_hash::collect): u - thr sets
//     the carry when the draw does not fail, and acc = 2 acc + carry (one
//     IMAD.X) collects the 32 outcomes of four elements into one word,
//     so the integer ALU (shared by ^, >> and compares) is spared a
//     select or a predicated or per draw; the FMA pipe takes the
//     collecting.
//   - Memory: 16-byte loads (8 bfloat16 or 4 float32 a thread), payload
//     stores of 8 or 4 bytes a thread. The vectors follow the tensor's
//     16-byte grid, so a flat view at any element offset is read with
//     aligned loads: a block's first and last vector then straddle the
//     block's edges and are read and written element by element, as are
//     the tensor's ragged tail and a payload whose address is not aligned
//     to its vector.
//   - Rounding: rint and the int conversion are one IEEE add of
//     1.5 * 2^23, whose low byte is then q's two's-complement byte (exact
//     for |q| < 2^22, round half to even).
//   - One block of 256 threads per quantisation block, 32 elements a
//     thread held in registers between the two passes (absmax, then
//     quantise and store); a warp-shuffle then shared-memory reduction for
//     the absmax and the error count. The padding is never read or
//     written: padded elements quantise to 0, which has no set bit to fail.
// Products, division and rounding are IEEE round-to-nearest-even
// (__fmul_rn, __fdiv_rn, __fadd_rn; the build never uses --use_fast_math),
// so scales and payloads match the reference bit for bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 64 * 128;            // elements per quantisation block
constexpr float kQmax = 127.0f;
constexpr float kQmaxInv = 1.0f / kQmax;    // rounded once, at compile time
constexpr float kRound = 12582912.0f;       // 1.5 * 2^23

// elements per 16-byte vector
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };
template <> struct Vec<float> { static constexpr int kN = 4; };

__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// element i of a vector held as raw bits
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int i) {
  if constexpr (Vec<T>::kN == 8) {
    const uint32_t w = word(r, i >> 1);
    return __uint_as_float((i & 1) ? (w & 0xFFFF0000u) : (w << 16));
  } else {
    return __uint_as_float(word(r, i));
  }
}

// The vector of elements [e0, e0 + kN), those outside [lo, hi) read as 0.
// x + e0 is 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ x,
                                          int64_t e0, int64_t lo,
                                          int64_t hi) {
  constexpr int N = Vec<T>::kN;
  if (e0 >= lo && e0 + N <= hi)
    return *reinterpret_cast<const uint4*>(x + e0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int64_t e = e0 + i;
    if (e >= lo && e < hi) {
      if constexpr (N == 8)
        w[i >> 1] |= (uint32_t)__bfloat16_as_ushort(x[e]) << (16 * (i & 1));
      else
        w[i] = __float_as_uint(x[e]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stores the payload bytes p (little-endian words) of elements
// [e0, e0 + N) that lie in [lo, hi).
template <int N>
__device__ __forceinline__ void store_vec(int8_t* __restrict__ st,
                                          int64_t e0, int64_t lo, int64_t hi,
                                          const uint32_t* p) {
  if (e0 >= lo && e0 + N <= hi &&
      ((reinterpret_cast<uintptr_t>(st) + (uint64_t)e0) & (N - 1)) == 0) {
    if constexpr (N == 8)
      *reinterpret_cast<uint2*>(st + e0) = make_uint2(p[0], p[1]);
    else
      *reinterpret_cast<uint32_t*>(st + e0) = p[0];
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int64_t e = e0 + i;
    if (e >= lo && e < hi) st[e] = (int8_t)(p[i >> 2] >> (8 * (i & 3)));
  }
}

// `lead` is the number of elements between the 16-byte boundary at or
// below x and x itself: vector k of a block starts at its element
// -lead + kN k, so every vector is aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_quant_kernel(const T* __restrict__ x, int64_t n, uint32_t seed,
                const uint32_t* __restrict__ thr, int8_t* __restrict__ stored,
                float* __restrict__ scales, int32_t* __restrict__ errors,
                int lead) {
  constexpr int N = Vec<T>::kN;
  constexpr int kWords = N / 4;                    // payload words a vector
  constexpr int kSlots = kBlock / N / kThreads;    // vectors a thread
  __shared__ float r_max[kWarps];
  __shared__ int32_t r_err[kWarps];
  __shared__ float s_scale;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t lo = (int64_t)blockIdx.x * kBlock;
  const int64_t hi = n < lo + kBlock ? n : lo + kBlock;
  // a block that does not start on the 16-byte grid spans one more
  // vector, the extra slot of thread 0
  const int vectors = kBlock / N + (lead != 0);

  uint4 raw[kSlots + 1];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j <= kSlots; ++j) {
    const int k = tid + j * kThreads;
    raw[j] = k < vectors ? load_vec(x, lo - lead + (int64_t)N * k, lo, hi)
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < N; ++i) amax = fmaxf(amax, fabsf(elem<T>(raw[j], i)));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_down_sync(0xffffffffu, amax, off));
  if (lane == 0) r_max[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < kWarps ? r_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_down_sync(0xffffffffu, amax, off));
    if (lane == 0) s_scale = __fmul_rn(fmaxf(amax, 1e-12f), kQmaxInv);
  }
  __syncthreads();
  const float scale = s_scale;

  // per plane: the seed's and the plane's folded hash input, the
  // threshold and its upper half (uniform over the grid)
  uint32_t key[8], t[8], t_hi[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    key[b] = counter_hash::fold(seed) ^
             counter_hash::fold((uint32_t)b * counter_hash::kBit);
    t[b] = __ldg(thr + b);
    t_hi[b] = t[b] >> 16;
  }

  int32_t nerr = 0;
#pragma unroll
  for (int j = 0; j <= kSlots; ++j) {
    const int k = tid + j * kThreads;
    if (j == kSlots && __all_sync(0xffffffffu, k >= vectors)) break;
    const int64_t e0 = lo - lead + (int64_t)N * k;
    uint32_t qf[N], m[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float y = fminf(fmaxf(__fdiv_rn(elem<T>(raw[j], i), scale),
                                  -kQmax), kQmax);
      qf[i] = __float_as_uint(__fadd_rn(y, kRound));  // low byte: q
      // flat indices above 2^32 wrap, as the uint32 reference's do
      m[i] = (uint32_t)(e0 + i) * counter_hash::kElem;
    }
    uint32_t out[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t q = __byte_perm(
          __byte_perm(qf[4 * w], qf[4 * w + 1], 0x0040),
          __byte_perm(qf[4 * w + 2], qf[4 * w + 3], 0x0040), 0x5410);
      // bit 8 i + b of pass: plane b of element 4 w + i did not fail
      uint32_t pass = 0u;
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        const uint32_t mi = m[4 * w + i];
#pragma unroll
        for (int b = 7; b >= 0; --b)
          pass = counter_hash::collect(
              pass, counter_hash::draw_key(mi ^ (mi >> 16) ^ key[b],
                                           t_hi[b]),
              t[b]);
      }
      const uint32_t fail = q & ~pass;
      nerr += __popc(fail);
      out[w] = q ^ fail;
    }
    if (k < vectors) store_vec<N>(stored, e0, lo, hi, out);
  }

  for (int off = 16; off > 0; off >>= 1)
    nerr += __shfl_down_sync(0xffffffffu, nerr, off);
  if (lane == 0) r_err[warp] = nerr;
  __syncthreads();
  if (warp == 0) {
    nerr = lane < kWarps ? r_err[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      nerr += __shfl_down_sync(0xffffffffu, nerr, off);
    if (lane == 0) {
      scales[blockIdx.x] = scale;
      errors[blockIdx.x] = nerr;
    }
  }
}

}  // namespace

// Launches one block per 8192 elements on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for an
// empty tensor, more than 2^31 - 1 blocks, or an x not aligned to its
// element. is_bf16 selects bfloat16 input, else float32. stored holds n
// int8; scales and errors one entry per block.
extern "C" int kv_quant_launch(const void* x, int64_t n, uint32_t seed,
                               const void* thr, void* stored, void* scales,
                               void* errors, int is_bf16, void* stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  const int size = is_bf16 ? 2 : 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (n <= 0 || blocks > 0x7fffffff || addr % size)
    return (int)cudaErrorInvalidValue;
  const int lead = (int)(addr % 16) / size;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    kv_quant_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, seed, (const uint32_t*)thr,
        (int8_t*)stored, (float*)scales, (int32_t*)errors, lead);
  } else {
    kv_quant_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, n, seed, (const uint32_t*)thr, (int8_t*)stored,
        (float*)scales, (int32_t*)errors, lead);
  }
  return (int)cudaGetLastError();
}
