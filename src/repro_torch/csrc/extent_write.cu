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
// Bound: at admission sizes (millions of lanes) the integer ALU. Each
// lane reads 8 bytes (old, new) and writes 4 (stored), 12 bytes per lane
// against 3.35 TB/s of HBM (0.0048 ms for an admission row of qwen2.5-3b,
// 1,327,104 lanes), but each flipped plane costs a hash of about a dozen
// integer operations, and about 11 of a lane's 32 planes flip. On an
// H100 80GB HBM3 at 700 W the kernel takes about 0.042 ms there
// (chip_smoke.py's kernels line), 9x its byte bound. The decode column
// write is ~18k lanes per leaf at batch 4 (qwen2.5-3b: 36 layers x 4
// slots x 2 kv heads x 128 / 2 bf16 per lane), a few microseconds of
// traffic, so there the launch latency bounds it.
//
// Design: a grid-stride loop in which a warp takes 32 consecutive lanes
// per step, one lane per thread, with the 4x32 threshold/energy operands
// staged in shared memory once per block as (thr01, thr10) and
// (e01, e10) pairs, one 8-byte broadcast load each per plane (they are
// device operands, not compile-time constants, so a change of quality
// floor swaps operands without a rebuild). A warp counts its flipped
// planes (a popcount per lane, a shuffle scan over the warp) and queues
// the flipped (lane, plane) pairs in shared memory; every thread then
// hashes an even share of the queue and sets fail bits in the source
// lane's shared word. No thread hashes a plane that did not flip, and no
// thread idles while another walks its own lane's flips (a loop over each
// lane's planes, about a third of them flipped, kept every warp on all
// 32). The counts are popcounts of the diff and fail masks. A warp whose
// 32 words are all unchanged costs only their loads. Warp-shuffle then
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
  constexpr int kWarps = kThreads / 32;
  __shared__ uint2 s_thr[kPlanes];   // (thr01, thr10) per plane
  __shared__ float2 s_e[kPlanes];    // (e01, e10) per plane
  __shared__ float r_energy[kWarps];
  __shared__ int32_t r_counts[3][kWarps];
  // per warp: the queue of flipped (lane, plane) pairs, the lanes' new
  // words and their fail masks
  __shared__ uint16_t s_q[kWarps][32 * kPlanes];
  __shared__ uint32_t s_nw[kWarps][32], s_fail[kWarps][32];

  const int tid = threadIdx.x;
  if (tid < kPlanes) {
    s_thr[tid] = make_uint2(thr01[tid], thr10[tid]);
    s_e[tid] = make_float2(e01[tid], e10[tid]);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  float energy = 0.f;
  int32_t n01 = 0, n10 = 0, nerr = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // a warp takes 32 consecutive lanes per step, all its threads together
  for (int64_t base = (int64_t)blockIdx.x * kThreads + warp * 32;
       base < n_lanes; base += stride) {
    const int64_t i = base + lane;
    const bool valid = i < n_lanes;
    const uint32_t o = valid ? old_u[i] : 0u;
    const uint32_t nw = valid ? new_u[i] : 0u;
    const uint32_t diff = o ^ nw;
    const int cnt = __popc(diff);
    n01 += __popc(diff & nw);
    n10 += __popc(diff & ~nw);
    // the warp's flipped planes: an inclusive scan of the lanes' counts
    int pre = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, pre, off);
      if (lane >= off) pre += t;
    }
    const int total = __shfl_sync(0xffffffffu, pre, 31);
    uint32_t fail_mask = 0u;
    if (total > 0) {
      // the flipped pairs are queued and shared out evenly, so every
      // thread hashes about total / 32 of them. Lane indices above 2^32
      // are refused by the wrapper: the hash takes the index modulo 2^32
      // exactly as the uint32 reference does
      int slot = pre - cnt;
      s_nw[warp][lane] = nw;
      s_fail[warp][lane] = 0u;
      for (uint32_t d = diff; d; d &= d - 1)
        s_q[warp][slot++] = (uint16_t)(lane << 5 | (__ffs(d) - 1));
      __syncwarp();
      for (int j = lane; j < total; j += 32) {
        const uint32_t e = s_q[warp][j];
        const int src = e >> 5, b = e & 31;
        const bool to_ap = (s_nw[warp][src] >> b) & 1u;
        const uint32_t u = counter_hash::uniform_bits(
            counter_hash::hash_base((uint32_t)(base + src), seed), b);
        const uint2 thr = s_thr[b];
        const float2 en = s_e[b];
        if (u < (to_ap ? thr.x : thr.y))
          atomicOr(&s_fail[warp][src], 1u << b);
        energy += to_ap ? en.x : en.y;
      }
      __syncwarp();
      fail_mask = s_fail[warp][lane];
      __syncwarp();   // the queue is read before the next step refills it
    }
    nerr += __popc(fail_mask);
    if (valid) stored[i] = nw ^ fail_mask;
  }

  // block reduction: warp shuffles, then the first warp over the warps
  for (int off = 16; off > 0; off >>= 1) {
    energy += __shfl_down_sync(0xffffffffu, energy, off);
    n01 += __shfl_down_sync(0xffffffffu, n01, off);
    n10 += __shfl_down_sync(0xffffffffu, n10, off);
    nerr += __shfl_down_sync(0xffffffffu, nerr, off);
  }
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
