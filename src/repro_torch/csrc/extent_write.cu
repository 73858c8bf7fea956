// EXTENT approximate write over uint32 lanes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/extent_write/kernel.py::extent_write_kernel.
// It computes the same function, lane by lane instead of block by block:
// for each 32-bit lane and each bit plane b,
//   flip   = bit b of (old ^ new)          (0->1 when new's bit is set)
//   u      = fmix32((lane * 2654435761) ^ (b * 0x9E3779B9) ^ seed)
//   fail   = flip && u < (0->1 ? thr01[b] : thr10[b])
//   stored = new ^ fail_mask
// plus per-block partial sums of the energy (f32) and of the 0->1 flips,
// 1->0 flips and failed flips (int32). The wrapper sums the partials in a
// fixed order (no float atomics), so a call is deterministic.
//
// The counter hash sees only the flat lane index, so any thread/block
// decomposition gives the same bits as the TPU kernel and the plain
// PyTorch twin (repro_torch/kernels/extent_write/ref.py).
//
// Bound: memory. Each lane reads 8 bytes (old, new) and writes 4 (stored),
// 12 bytes per lane against 3.35 TB/s of HBM; the 32-plane hash loop is
// integer ALU work that hides under the loads at admission sizes (millions
// of lanes). The decode column write is ~18k lanes per leaf at batch 4
// (qwen2.5-3b: 36 layers x 4 slots x 2 kv heads x 128 / 2 bf16 per lane),
// a few microseconds of traffic, so there the launch latency bounds it.
//
// Design: a grid-stride loop, one lane per thread per iteration, the 4x32
// threshold/energy operands staged in shared memory once per block
// (they are device operands, not compile-time constants, so a change of
// quality floor swaps operands without a rebuild), warp-shuffle then
// shared-memory reduction of the four statistics, one partial per block.
// Later work: 16-byte vector loads and fusing the decode gather/scatter.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 32;

__global__ void __launch_bounds__(kThreads)
extent_write_kernel(const uint32_t* __restrict__ old_u,
                    const uint32_t* __restrict__ new_u,
                    uint32_t* __restrict__ stored,
                    int64_t n_lanes, uint32_t seed,
                    const uint32_t* __restrict__ thr01,
                    const uint32_t* __restrict__ thr10,
                    const float* __restrict__ e01,
                    const float* __restrict__ e10,
                    float* __restrict__ part_energy,
                    int32_t* __restrict__ part_counts) {
  __shared__ uint32_t s_thr01[kPlanes], s_thr10[kPlanes];
  __shared__ float s_e01[kPlanes], s_e10[kPlanes];
  __shared__ float r_energy[kThreads / 32];
  __shared__ int32_t r_counts[3][kThreads / 32];

  const int tid = threadIdx.x;
  if (tid < kPlanes) {
    s_thr01[tid] = thr01[tid];
    s_thr10[tid] = thr10[tid];
    s_e01[tid] = e01[tid];
    s_e10[tid] = e10[tid];
  }
  __syncthreads();

  float energy = 0.f;
  int32_t n01 = 0, n10 = 0, nerr = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < n_lanes;
       i += stride) {
    const uint32_t o = old_u[i];
    const uint32_t nw = new_u[i];
    const uint32_t diff = o ^ nw;
    uint32_t fail_mask = 0u;
    if (diff) {
      // lane indices above 2^32 are refused by the wrapper: the hash
      // takes the index modulo 2^32 exactly as the uint32 reference does
      const uint32_t base = counter_hash::hash_base((uint32_t)i, seed);
#pragma unroll 8
      for (int b = 0; b < kPlanes; ++b) {
        const uint32_t bit = 1u << b;
        if (!(diff & bit)) continue;
        const bool to_ap = (nw & bit) != 0u;
        const uint32_t u = counter_hash::uniform_bits(base, b);
        const bool fail = u < (to_ap ? s_thr01[b] : s_thr10[b]);
        fail_mask |= fail ? bit : 0u;
        energy += to_ap ? s_e01[b] : s_e10[b];
        n01 += to_ap;
        n10 += !to_ap;
        nerr += fail;
      }
    }
    stored[i] = nw ^ fail_mask;
  }

  // block reduction: warp shuffles, then the first warp over the warps
  for (int off = 16; off > 0; off >>= 1) {
    energy += __shfl_down_sync(0xffffffffu, energy, off);
    n01 += __shfl_down_sync(0xffffffffu, n01, off);
    n10 += __shfl_down_sync(0xffffffffu, n10, off);
    nerr += __shfl_down_sync(0xffffffffu, nerr, off);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    r_energy[warp] = energy;
    r_counts[0][warp] = n01;
    r_counts[1][warp] = n10;
    r_counts[2][warp] = nerr;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kThreads / 32;
    energy = live ? r_energy[lane] : 0.f;
    n01 = live ? r_counts[0][lane] : 0;
    n10 = live ? r_counts[1][lane] : 0;
    nerr = live ? r_counts[2][lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      energy += __shfl_down_sync(0xffffffffu, energy, off);
      n01 += __shfl_down_sync(0xffffffffu, n01, off);
      n10 += __shfl_down_sync(0xffffffffu, n10, off);
      nerr += __shfl_down_sync(0xffffffffu, nerr, off);
    }
    if (lane == 0) {
      part_energy[blockIdx.x] = energy;
      part_counts[blockIdx.x] = n01;
      part_counts[gridDim.x + blockIdx.x] = n10;
      part_counts[2 * gridDim.x + blockIdx.x] = nerr;
    }
  }
}

}  // namespace

extern "C" int extent_write_threads() { return kThreads; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// part_counts holds 3 x grid int32: flips01, flips10, errors.
extern "C" int extent_write_launch(const void* old_u, const void* new_u,
                                   void* stored, int64_t n_lanes,
                                   uint32_t seed, const void* thr01,
                                   const void* thr10, const void* e01,
                                   const void* e10, void* part_energy,
                                   void* part_counts, int grid,
                                   void* stream) {
  extent_write_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)old_u, (const uint32_t*)new_u, (uint32_t*)stored,
      n_lanes, seed, (const uint32_t*)thr01, (const uint32_t*)thr10,
      (const float*)e01, (const float*)e10, (float*)part_energy,
      (int32_t*)part_counts);
  return (int)cudaGetLastError();
}
