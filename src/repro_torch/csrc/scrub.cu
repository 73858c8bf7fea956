// Scrub (corrective re-write) over uint32 lanes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/scrub/kernel.py::scrub_kernel.
// It computes the same function: for each 32-bit lane with decay mask m
// and each bit plane b set in m,
//   corrected = stored ^ m
//   to_ap     = bit b of corrected           (the re-write's direction)
//   u         = fmix32((lane * 2654435761) ^ (b * 0x9E3779B9) ^ seed)
//   fail      = u < (to_ap ? thr01[b] : thr10[b])
//   scrubbed  = corrected ^ fail_mask,  residual = fail_mask
// and every re-written bit is a 0->1 or a 1->0 re-write of its plane,
// failed or not. Each block writes its per-plane counts n01[b] and n10[b]
// and its failed re-writes (int32); the wrapper sums the blocks in int64
// and prices the counts with the twin's own formula
// (ref.stats_from_partials: the float64 sum over planes of count x plane
// energy, rounded once to float32). So on one device the energy equals
// the twin's bit for bit, and a call is deterministic (integer counts
// only; no float atomics).
//
// The counter hash sees only the flat lane index, so any thread/block
// decomposition gives the same bits as the TPU kernel and the plain
// PyTorch twin (repro_torch/kernels/scrub/ref.py).
//
// Bound: the larger of two. Memory: each lane reads 8 bytes (stored,
// mask) and writes 8 (scrubbed, residual), 16 bytes against 3.35 TB/s of
// HBM; a whole K or V leaf of qwen2.5-3b's pool at capacity 4 is
// 5,308,416 lanes, 0.0254 ms. Draws: one folded counter-hash draw (and
// one energy add) per set mask bit, a draw being 5 integer-ALU and 3 FMA
// instructions at best; a checkpoint restore's 400 K decay mask sets
// 13.2 of a float32 lane's 32 bits, 4.1 G draws over the 311 M-lane
// embedding moment. Retention masks in serving are sparse (about 1e-5 of
// the mantissa bits a step at 350 K), so there almost every warp finds
// nothing to re-write and the bytes bound.
//
// Design, against both:
//   - A thread takes 4 lanes a 16-byte vector, kVecs vectors a trip (1 for
//     calls of up to 2^21 lanes, whose latency more resident threads
//     hide; 2 above, where the walk's per-plane work serves twice the
//     lanes). Vectors follow stored's 16-byte grid (`lead` lanes before
//     the first boundary), so stored is read with aligned vector loads at
//     any lane offset; the first and last vectors, lanes past the end,
//     and a mask or output whose grid differs from stored's go element by
//     element, in the same kernel.
//   - The route is chosen per warp trip, not per lane, from the OR of the
//     trip's masks (__reduce_or_sync) and their set bits
//     (__reduce_add_sync). Every lane joins the collectives; lanes past
//     the end hold m = 0.
//       * OR 0: the warp copies stored to scrubbed and writes zero
//         residuals, with no draw.
//       * At most kSparseBits set bits (a serving pass's live warps):
//         each lane draws its own set bits one by one and counts them
//         with shared-memory atomics; no walk, no flush, so the few live
//         warps of a small call finish with the others.
//       * Otherwise the warp walks the set planes of the OR: in three
//         passes by kind (both directions can fail, only 0->1, only 1->0,
//         from the thresholds), each as runs of adjacent planes, highest
//         first. The plane index is warp-uniform, so no lane waits on
//         another's queue and the operands (folded plane key, thresholds,
//         their upper halves) come from a per-warp shared table, built at
//         the warp's first live trip. Every lane is drawn at every walked
//         plane, set or not: 7 ALU instructions a lane-plane where both
//         directions are compared (the draw finished, m ^ m >> 16, and
//         held against both thresholds), 5 where one is (draw_key). The
//         compares feed carries collected as 2 acc + (u >= thr) (IADD3,
//         IMAD.X); a run's word shifted by its lowest plane ANDed with the
//         mask and the direction gives the fail bits, once a lane a run.
//   - Folded draws (counter_hash.cuh): fold(lane * kElem) once a lane,
//     fold(seed) ^ fold(b * kBit) once a plane, then fmix32_mid.
//   - Statistics are integer counts per plane. A walked trip's 0->1 and
//     1->0 re-write masks (m & corrected, m & ~corrected) go into
//     bit-sliced counters over a thread's lanes (a full-adder tree, then
//     a ripple over 8 slices), flushed every 255 / (4 kVecs) such trips,
//     and at the end, by a 32 x 32 bit transpose across the warp (five
//     shuffles) and popcounts, after which lane b holds the warp's plane b
//     counts. Failed re-writes are popcounts of the fail words. One
//     shared-memory pass sums the warps into the block's partials.
//   - The grid is 4 x the blocks the device holds at once, at most, so
//     the grid-stride loop's blocks stay few (the partials are grid x 65
//     int32) and no wave is mostly empty.
// Every per-call scalar (seed, lane count, lead) is passed by value, so a
// CUDA graph capture would freeze them, as it freezes any kernel argument;
// nothing captures a scrub today. The windowed pass still gathers its
// column window into a copy before the kernel and scatters it back; an
// in-place walk of the window is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 32;
constexpr int kParts = 2 * kPlanes + 1;  // n01[32], n10[32], errors
constexpr int kSlices = 8;     // bits of a thread's bit-sliced counts
constexpr int kSparseBits = 32;  // the most set bits of a per-bit trip
constexpr int64_t kSmallLanes = int64_t{1} << 21;  // calls of kVecs 1
constexpr int kWavesCap = 4;   // the grid: at most 4 x resident blocks
constexpr uint32_t kAll = 0xffffffffu;

// One full adder per bit: s + a + b = (s ^ a ^ b) + 2 maj(s, a, b). The
// sum bits stay in s; returns the carries.
__device__ __forceinline__ uint32_t full_add(uint32_t& s, uint32_t a,
                                             uint32_t b) {
  const uint32_t carry = (s & a) | (s & b) | (a & b);
  s ^= a ^ b;
  return carry;
}

// Adds the bits of a thread's N words w plane by plane into the
// bit-sliced counts c: c[j] holds bit j of every plane's count.
template <int N>
__device__ __forceinline__ void count(uint32_t (&c)[kSlices],
                                      const uint32_t (&w)[N]) {
  uint32_t k1[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    k1[i] = full_add(c[0], w[2 * i], w[2 * i + 1]);
  uint32_t k = full_add(c[1], k1[0], k1[1]);   // weight 4
  int j = 2;
  if constexpr (N == 8) {
    const uint32_t k2 = full_add(c[1], k1[2], k1[3]);
    k = full_add(c[2], k, k2);                  // weight 8
    j = 3;
  }
#pragma unroll
  for (; j < kSlices; ++j) {
    const uint32_t t = c[j] & k;
    c[j] ^= k;
    k = t;
  }
}

// Lane L gets the word whose bit j is bit L of lane j's x.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  uint32_t m = 0x0000FFFFu;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1, m ^= m << s) {
    const uint32_t y = __shfl_xor_sync(kAll, x, s);
    x = (lane & s) ? (x & ~m) | ((y >> s) & m)
                   : (x & m) | ((y << s) & ~m);
  }
  return x;
}

// Adds the warp's bit-sliced counts c, each below 2^slices, to `count`
// (lane b: plane b) and clears them.
__device__ __forceinline__ void flush(uint32_t (&c)[kSlices],
                                      int32_t& count, int lane,
                                      int slices) {
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    if (j < slices) count += __popc(transpose32(c[j], lane)) << j;
    c[j] = 0u;
  }
}

__device__ __forceinline__ bool on_grid(const uint32_t* p, int lead) {
  return ((reinterpret_cast<uintptr_t>(p) - 4u * (uintptr_t)lead) & 15u)
         == 0u;
}

// Lanes [e0, e0 + 4) into w[0..3], those outside [0, n) as 0. `vec`: p's
// 16-byte grid is the vectors'.
__device__ __forceinline__ void load4(const uint32_t* __restrict__ p,
                                      int64_t e0, int64_t n, bool vec,
                                      uint32_t* w) {
  if (vec && e0 >= 0 && e0 + 4 <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + e0);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (e0 + k >= 0 && e0 + k < n) ? p[e0 + k] : 0u;
}

__device__ __forceinline__ void store4(uint32_t* __restrict__ p, int64_t e0,
                                       int64_t n, bool vec,
                                       const uint32_t* w) {
  if (vec && e0 >= 0 && e0 + 4 <= n) {
    *reinterpret_cast<uint4*>(p + e0) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e0 + k >= 0 && e0 + k < n) p[e0 + k] = w[k];
}

// Draws the thread's N lanes at the planes of `todo` (kMode 0: planes
// where both directions can fail, both compared; 1: where only 0->1
// re-writes can, 2: only 1->0) and sets in `fail` the mask bits whose
// re-write fails. `todo` is walked as runs of adjacent planes, highest
// first, each collected as 2 acc + carry so that plane b's outcome lands
// on bit b - lo of the run's word. ops[b] = {folded plane key, thr01,
// thr10}, his[b] = the thresholds' upper halves.
template <int kMode, int N>
__device__ __forceinline__ void walk(uint32_t todo,
                                     const uint4* __restrict__ ops,
                                     const uint2* __restrict__ his,
                                     const uint32_t (&fl)[N],
                                     const uint32_t (&m)[N],
                                     const uint32_t (&cor)[N],
                                     uint32_t (&fail)[N]) {
  while (todo != 0u) {
    const int hi = 31 - __clz(todo);
    const uint32_t gaps = ~todo & ((1u << hi) - 1u);
    const int lo = gaps != 0u ? 32 - __clz(gaps) : 0;
    const uint32_t run = (kAll >> (31 - hi)) & (kAll << lo);
    todo &= ~run;
    uint32_t acc01[N] = {}, acc10[N] = {};
    for (int b = hi; b >= lo; --b) {
      const uint4 op = ops[b];
      const uint2 h = his[b];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const uint32_t x = counter_hash::fmix32_mid(fl[k] ^ op.x);
        if (kMode == 0) {
          const uint32_t u = x ^ (x >> 16);
          acc01[k] = counter_hash::collect(acc01[k], u, op.y);
          acc10[k] = counter_hash::collect(acc10[k], u, op.z);
        } else if (kMode == 1) {
          acc01[k] = counter_hash::collect(acc01[k], x ^ h.x, op.y);
        } else {
          acc10[k] = counter_hash::collect(acc10[k], x ^ h.y, op.z);
        }
      }
    }
    // bit b of acc01 / acc10 << lo: plane b's re-write did not fail
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint32_t f01 = cor[k] & ~(acc01[k] << lo);
      const uint32_t f10 = ~cor[k] & ~(acc10[k] << lo);
      fail[k] |= m[k] & run & (kMode == 0 ? f01 | f10
                               : kMode == 1 ? f01 : f10);
    }
  }
}

// kVecs: the 16-byte vectors a thread takes a trip (1 for small calls,
// whose latency more resident threads hide; 2 for large ones, where the
// walk's per-plane work is shared by twice the lanes).
template <int kVecs>
__global__ void __launch_bounds__(kThreads)
scrub_kernel(const uint32_t* __restrict__ stored,
             const uint32_t* __restrict__ mask,
             uint32_t* __restrict__ scrubbed,
             uint32_t* __restrict__ residual, int64_t n, int lead,
             uint32_t seed, const uint32_t* __restrict__ thr01,
             const uint32_t* __restrict__ thr10,
             int32_t* __restrict__ parts) {
  constexpr int N = 4 * kVecs;                 // lanes a thread takes
  constexpr int kFlushTrips = 255 / N;         // dense trips a flush
  // each warp's table of plane operands, built at its first live trip;
  // s_part[w] collects warp w's counts
  __shared__ uint4 s_ops[kWarps][kPlanes];
  __shared__ uint2 s_his[kWarps][kPlanes];
  __shared__ int32_t s_part[kWarps][kParts];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t t01 = thr01[lane], t10 = thr10[lane];  // plane `lane`'s
  bool table = false, sparse = false;  // live trips; the per-bit route
  uint32_t can01 = 0u, can10 = 0u;     // planes whose re-writes can fail
  const bool mask_vec = on_grid(mask, lead);
  const bool out_vec = on_grid(scrubbed, lead) && on_grid(residual, lead);

  uint32_t c01[kSlices] = {}, c10[kSlices] = {};
  int32_t n01 = 0, n10 = 0, nerr = 0;  // lane b: the warp's plane b
  int dense = 0;
  const int64_t n_vec = (n + lead + 3) >> 2;
  const int64_t stride = (int64_t)gridDim.x * kThreads * kVecs;
  // a warp's trip: vectors v0 + 32 j + lane, j < kVecs
  for (int64_t v0 = ((int64_t)blockIdx.x * kThreads + warp * 32) * kVecs;
       v0 < n_vec; v0 += stride) {
    int64_t e0[kVecs];
    uint32_t s[N], m[N];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      e0[j] = 4 * (v0 + 32 * j + lane) - lead;
      load4(stored, e0[j], n, true, s + 4 * j);
      load4(mask, e0[j], n, mask_vec, m + 4 * j);
    }
    uint32_t any = 0u;
#pragma unroll
    for (int k = 0; k < N; ++k) any |= m[k];
    const uint32_t planes = __reduce_or_sync(kAll, any);
    if (planes == 0u) {  // nothing decayed in the warp: no re-write
      const uint32_t zero[4] = {};
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        store4(scrubbed, e0[j], n, out_vec, s + 4 * j);
        store4(residual, e0[j], n, out_vec, zero);
      }
      continue;
    }
    if (!table) {  // the warp's first live trip
      s_ops[warp][lane] = make_uint4(
          counter_hash::fold(seed) ^
              counter_hash::fold((uint32_t)lane * counter_hash::kBit),
          t01, t10, 0u);
      s_his[warp][lane] = make_uint2(t01 >> 16, t10 >> 16);
      can01 = __ballot_sync(kAll, t01 != 0u);
      can10 = __ballot_sync(kAll, t10 != 0u);
      __syncwarp();
      table = true;
    }
    uint32_t cor[N], fl[N], fail[N] = {}, bits = 0u;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      cor[k] = s[k] ^ m[k];
      bits += __popc(m[k]);
      // lane indices above 2^32 are refused by the wrapper: the hash
      // takes the index modulo 2^32 as the uint32 reference does
      fl[k] = counter_hash::fold((uint32_t)(e0[k / 4] + k % 4) *
                                 counter_hash::kElem);
      // kept in a register: recomputing it costs each draw two more
      asm volatile("" : "+r"(fl[k]));
    }
    if (__reduce_add_sync(kAll, bits) <= kSparseBits) {
      // a few decayed bits: each lane draws its own, one at a time, and
      // counts them in the warp's shared counters
      if (!sparse) {
        s_part[warp][lane] = 0;
        s_part[warp][kPlanes + lane] = 0;
        __syncwarp();
        sparse = true;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        for (uint32_t w = m[k]; w != 0u; w &= w - 1u) {
          const int b = __ffs(w) - 1;
          const bool up = (cor[k] >> b) & 1u;
          const uint4 op = s_ops[warp][b];
          const uint32_t x = counter_hash::fmix32_mid(fl[k] ^ op.x);
          if ((x ^ (x >> 16)) < (up ? op.y : op.z)) fail[k] |= 1u << b;
          atomicAdd(&s_part[warp][(up ? 0 : kPlanes) + b], 1);
        }
      }
    } else {
      uint32_t a01[N], a10[N];
      walk<0>(planes & can01 & can10, s_ops[warp], s_his[warp], fl, m, cor,
              fail);
      walk<1>(planes & can01 & ~can10, s_ops[warp], s_his[warp], fl, m,
              cor, fail);
      walk<2>(planes & ~can01 & can10, s_ops[warp], s_his[warp], fl, m,
              cor, fail);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        a01[k] = m[k] & cor[k];
        a10[k] = m[k] & ~cor[k];
      }
      count(c01, a01);
      count(c10, a10);
      if (++dense == kFlushTrips) {
        flush(c01, n01, lane, kSlices);
        flush(c10, n10, lane, kSlices);
        dense = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      nerr += __popc(fail[k]);
      s[k] = cor[k] ^ fail[k];  // the scrubbed word
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      store4(scrubbed, e0[j], n, out_vec, s + 4 * j);
      store4(residual, e0[j], n, out_vec, fail + 4 * j);
    }
  }
  if (dense != 0) {  // counts of at most N x dense
    const int slices = 32 - __clz(N * dense);
    flush(c01, n01, lane, slices);
    flush(c10, n10, lane, slices);
  }
  if (table) {  // the warp had a live trip
    for (int off = 16; off > 0; off >>= 1)
      nerr += __shfl_down_sync(kAll, nerr, off);
  }
  if (sparse) {
    __syncwarp();
    n01 += s_part[warp][lane];
    n10 += s_part[warp][kPlanes + lane];
  }
  s_part[warp][lane] = n01;
  s_part[warp][kPlanes + lane] = n10;
  if (lane == 0) s_part[warp][2 * kPlanes] = nerr;
  __syncthreads();
  if (tid < kParts) {
    int32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_part[w][tid];
    parts[(int64_t)blockIdx.x * kParts + tid] = sum;
  }
}

int vecs_for(int64_t n_lanes) { return n_lanes <= kSmallLanes ? 1 : 2; }

// kWavesCap x the blocks the current device holds at once (its SMs x the
// kernel's resident blocks per SM), or -1.
int grid_cap(int vecs) {
  static int cap[3] = {0, 0, 0};
  if (cap[vecs] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        (vecs == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, scrub_kernel<1>, kThreads, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, scrub_kernel<2>, kThreads, 0)) !=
            cudaSuccess)
      return -1;
    cap[vecs] = kWavesCap * sms * per_sm;
  }
  return cap[vecs];
}

}  // namespace

extern "C" int scrub_parts() { return kParts; }

// The 16-byte vectors a thread takes a trip for n_lanes lanes, and the
// most set bits a warp trip draws one by one: a warp trip takes
// 128 x scrub_vecs lanes on stored's 16-byte grid.
extern "C" int scrub_vecs(int64_t n_lanes) { return vecs_for(n_lanes); }

extern "C" int scrub_sparse_bits() { return kSparseBits; }

// The grid scrub_launch takes for n_lanes lanes starting `lead` lanes
// past a 16-byte boundary, or -1 if the device cannot be queried.
extern "C" int scrub_grid(int64_t n_lanes, int lead) {
  const int vecs = vecs_for(n_lanes);
  const int cap = grid_cap(vecs);
  if (cap <= 0) return -1;
  const int64_t per_block = (int64_t)kThreads * vecs;
  const int64_t need = ((n_lanes + lead + 3) / 4 + per_block - 1) / per_block;
  return (int)(need < 1 ? 1 : need < cap ? need : cap);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `lead`: the lanes between the 16-byte boundary at or below stored and
// stored itself (0-3); `grid`: scrub_grid's. parts holds grid x 65 int32:
// per block n01[32], n10[32], errors.
extern "C" int scrub_launch(const void* stored, const void* mask,
                            void* scrubbed, void* residual, int64_t n_lanes,
                            int lead, uint32_t seed, const void* thr01,
                            const void* thr10, void* parts, int grid,
                            void* stream) {
  const auto kernel =
      vecs_for(n_lanes) == 1 ? scrub_kernel<1> : scrub_kernel<2>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)stored, (const uint32_t*)mask, (uint32_t*)scrubbed,
      (uint32_t*)residual, n_lanes, lead, seed, (const uint32_t*)thr01,
      (const uint32_t*)thr10, (int32_t*)parts);
  return (int)cudaGetLastError();
}
