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
// Bound: memory. Each element is read once (4 or 2 bytes) and its int8
// payload written once (1 byte); a bfloat16 K or V leaf of
// recurrentgemma-2b's served cache (8, 4, 2048, 1, 256) is 16.8 M elements,
// 50 MB, 0.015 ms at 3.35 TB/s. The hash runs only for the set bits of a
// byte (a find-first-set loop), 3-4 of 8 on average.
//
// Design: one block of 256 threads per 8192-element quantisation block,
// 32 elements per thread held in registers between the two passes (absmax,
// then quantise and store), a warp-shuffle then shared-memory reduction
// for the absmax and for the error count. The padding is never read or
// written: padded elements quantise to 0, which has no set bit to fail.
// Products, division and rounding are IEEE round-to-nearest-even
// (__fmul_rn, __fdiv_rn, rintf; the build never uses --use_fast_math), so
// scales and payloads match the reference bit for bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64 * 128;            // elements per quantisation block
constexpr int kPer = kBlock / kThreads;     // 32 elements per thread
constexpr float kQmax = 127.0f;
constexpr float kQmaxInv = 1.0f / kQmax;    // rounded once, at compile time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_quant_kernel(const T* __restrict__ x, int64_t n, uint32_t seed,
                const uint32_t* __restrict__ thr, int8_t* __restrict__ stored,
                float* __restrict__ scales, int32_t* __restrict__ errors) {
  __shared__ uint32_t s_thr[8];
  __shared__ float r_max[kThreads / 32];
  __shared__ int32_t r_err[kThreads / 32];
  __shared__ float s_scale;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid < 8) s_thr[tid] = thr[tid];
  const int64_t base = (int64_t)blockIdx.x * kBlock;

  float vals[kPer];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t e = base + tid + (int64_t)i * kThreads;
    vals[i] = e < n ? to_f32(x[e]) : 0.f;
    amax = fmaxf(amax, fabsf(vals[i]));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_down_sync(0xffffffffu, amax, off));
  if (lane == 0) r_max[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < kThreads / 32 ? r_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_down_sync(0xffffffffu, amax, off));
    if (lane == 0) s_scale = __fmul_rn(fmaxf(amax, 1e-12f), kQmaxInv);
  }
  __syncthreads();
  const float scale = s_scale;

  int32_t nerr = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t e = base + tid + (int64_t)i * kThreads;
    const float qf = fminf(fmaxf(rintf(__fdiv_rn(vals[i], scale)), -kQmax),
                           kQmax);
    const uint32_t qu = (uint32_t)(int32_t)qf & 0xFFu;
    // flat indices above 2^32 wrap, as the uint32 reference's do
    const uint32_t hb = counter_hash::hash_base((uint32_t)e, seed);
    uint32_t fail = 0u, bits = qu;
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1u;
      if (counter_hash::uniform_bits(hb, b) < s_thr[b]) {
        fail |= 1u << b;
        ++nerr;
      }
    }
    if (e < n) stored[e] = (int8_t)(qu ^ fail);
  }

  for (int off = 16; off > 0; off >>= 1)
    nerr += __shfl_down_sync(0xffffffffu, nerr, off);
  if (lane == 0) r_err[warp] = nerr;
  __syncthreads();
  if (warp == 0) {
    nerr = lane < kThreads / 32 ? r_err[lane] : 0;
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
// cudaGetLastError() (0 on success). is_bf16 selects bfloat16 input, else
// float32. stored holds n int8; scales and errors one entry per block.
extern "C" int kv_quant_launch(const void* x, int64_t n, uint32_t seed,
                               const void* thr, void* stored, void* scales,
                               void* errors, int is_bf16, void* stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  if (n <= 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    kv_quant_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, seed, (const uint32_t*)thr,
        (int8_t*)stored, (float*)scales, (int32_t*)errors);
  } else {
    kv_quant_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, n, seed, (const uint32_t*)thr, (int8_t*)stored,
        (float*)scales, (int32_t*)errors);
  }
  return (int)cudaGetLastError();
}
