// Causal sliding-window GQA attention with an optional tanh logit softcap,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/local_attention/kernel.py::local_attention_kernel.
// It computes the same function: for query row i of head `head` in batch
// b, the keys j with 0 <= i - j < window are visible; the K/V row is head
// head / (H / Kh) of batch b (grouped heads share it, nothing is expanded
// in memory);
//   s = (q . k) * scale,  s = softcap * tanh(s / softcap) when softcap > 0,
// an online softmax in float32 in which masked keys get exactly 0
// probability, the p.v product in float32, and out = acc / max(l, 1e-30)
// rounded to the input type.
//
// Layout: the model's own, q/out (B,S,H,h) and k/v (B,S,Kh,h), contiguous,
// float32 or bfloat16; h a multiple of 4, at most 256.
//
// Bound: at the hybrid prefill's shape (S 3072, window 2048, 10 heads of
// 256, one KV head) the band holds 4.2 M live (query, key) pairs per head,
// 4.3e10 FLOP against 35 MB of traffic: operations bound it.
//
// Three kernels (routes), chosen by (type, h) in `route` below:
//
// * bfloat16 at h 64, 128 and 256 (the served model's h 256): wgmma fed by
//   TMA. A persistent grid of one block per SM walks the work items
//   (batch x head, query tile) longest band first, in a snake over the
//   blocks so long and short bands pair up. A block is three warpgroups:
//   one producer warp (setmaxnreg down to 40) keeps TMA loads of the
//   band's 64-key K and V tiles in flight through a two-stage ring of
//   mbarriers, and loads each item's Q tile once; two consumer
//   warpgroups (setmaxnreg up to 232) run q.k^T as wgmma m64n64k16 with
//   Q and K read from shared memory through descriptors, and p.v as wgmma
//   with p from registers and V read in its natural (key, h) layout with
//   the transpose bit. The tensor maps are 4-D over the model's own
//   layout (h, heads, S, B), 64-column boxes with the 128-byte swizzle;
//   rows past S arrive as zeros. The two consumer warpgroups take the
//   tensor cores in turns (two named barriers): each issues its q.k^T and
//   its previous tile's p.v back to back and hands over, and its softmax
//   runs under the other's products. The softmax works in log2 units
//   (exp2 with scale * log2(e) folded in) and masks per (row, key) only
//   on the tiles at the edge of a warpgroup's band. At h 64 and 128 each
//   consumer warpgroup owns 64 of the item's 128 query rows. At h 256 the
//   float32 output of 64 rows takes 128 registers a thread, which with s
//   and p does not fit 168, and every layout tried here compiled at 168
//   registers a thread (the 384-thread block's even share) whatever
//   setmaxnreg asked; why is not known, since kernels of the same layout
//   elsewhere give their consumers 240. So there both warpgroups take
//   the same 64 rows and each owns 128 output columns: each computes
//   q.k^T itself, a third more tensor-core work, and nothing spills. Shared memory: the Q tile and two K and V stages,
//   160 KB at h 256.
// * bfloat16 at any other h (a multiple of 4 up to 256): mma.sync
//   m16n8k16 with float32 accumulation. One block of 8 warps per (batch x
//   head, 128-row query tile), each warp owning 16 query rows; the tiles
//   with the longest bands are handed out first. The block walks the
//   64-key tiles of its band (keys no row of the tile can see are never
//   loaded; a warp none of whose rows sees a tile skips its products)
//   through two shared-memory stages: cp.async copies tile t + 1 in while
//   tile t is computed. Rows are padded by 16 bytes so that ldmatrix
//   reads are free of bank conflicts, and the head width is padded with
//   zeros to the template's HD. Shared memory holds the Q tile and two K
//   and V tiles, (128 + 4 x 64) x (HD + 8) x 2 bytes.
// * float32: the CUDA cores. One block of 256 threads per (batch x head,
//   64-row query tile) walks the band's 32-key tiles through shared memory.
//   Four neighbouring threads share a query row: each computes 8 of the
//   tile's 32 scores with 16-byte shared-memory loads, the four reduce the
//   row's running max and sum with warp shuffles, then each accumulates a
//   quarter of the row's h outputs, taking the row's 32 probabilities from
//   its three neighbours by shuffle. Q, K and V tiles take
//   (64 + 2 x 32) x (h + 4) x 4 bytes of shared memory (133 KB at h = 256);
//   the 4-float row padding keeps the 16-byte loads free of bank conflicts.
//
// Both bfloat16 kernels multiply bf16 by bf16 into float32 for q.k, which
// is exact per product. For p.v the float32 probabilities are split as
// p = hi + lo, both bf16 (16 significant bits together), and both halves
// go through the tensor cores into the same float32 accumulator: p.v
// keeps float32 probabilities to a relative 2^-17, where one bf16 p would
// lose 2^-9 (1.5x the products of one bf16 p). The running max starts at
// -2e38, so a fully masked tile gives p = 0, not NaN. Every kernel raises
// the launch's shared-memory limit above the 48 KB default.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;           // the reference's NEG_INF

// ---- bfloat16: the tensor cores ----

constexpr int kWarps = 8;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaBQ = 16 * kWarps;           // query rows per block
constexpr int kMmaBK = 64;                    // keys per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 bytes from global to shared memory, zero-filled when !in
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 8 : 0));
}

// 16 bytes, zero-filled when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = hi + lo, each a bf16 pair (x in the low half)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h2);
  hi = as_u32(h2);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows [s0, s0 + rows) of one head of a (.., S, heads, h) tensor into a
// shared tile of row stride HD + 8; rows past S and columns past h are 0.
// 16-byte copies when h is a multiple of 8, else 8-byte ones.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int s0, int rows,
                                          int S, int h) {
  if (h % 8 == 0) {
    constexpr int kChunks = HD / 8;
    for (int e = threadIdx.x; e < rows * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = e - r * kChunks;
      const int s = s0 + r;
      const bool in = s < S && 8 * c < h;
      cp_async16(smem_u32(dst + r * (HD + 8) + 8 * c),
                 in ? src + s * stride + 8 * c : src, in);
    }
  } else {
    constexpr int kChunks = HD / 4;
    for (int e = threadIdx.x; e < rows * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = e - r * kChunks;
      const int s = s0 + r;
      const bool in = s < S && 4 * c < h;
      cp_async8(smem_u32(dst + r * (HD + 8) + 4 * c),
                in ? src + s * stride + 4 * c : src, in);
    }
  }
}

// HD: the head width rounded up to a power of two in [16, 256]; columns
// h..HD-1 are zero in shared memory and never stored.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 1)
local_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int S, int H,
                            int Kh, int h, int window, float scale,
                            float softcap) {
  constexpr int kLd = HD + 8;          // shared row stride, in elements
  constexpr int kN = HD / 8;           // 8-column output tiles per warp
  constexpr int kT = kMmaBK / 8;       // 8-key score tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + kMmaBQ * kLd;   // two stages of (K, V)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment row, column
  const int b = blockIdx.x / H;
  const int head = blockIdx.x % H;
  const int kvh = head / (H / Kh);
  // the longest bands (last query tiles) are handed out first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const int r_lo = q0 + 16 * warp;           // this warp's first row
  const int row[2] = {r_lo + g, r_lo + g + 8};
  const int64_t q_stride = (int64_t)H * h;
  const int64_t kv_stride = (int64_t)Kh * h;
  const __nv_bfloat16* qb = q + ((int64_t)b * S * H + head) * h;
  const __nv_bfloat16* kb = k + ((int64_t)b * S * Kh + kvh) * h;
  const __nv_bfloat16* vb = v + ((int64_t)b * S * Kh + kvh) * h;

  auto load_kv = [&](int stage, int ks) {
    __nv_bfloat16* dst = sKV + stage * 2 * kMmaBK * kLd;
    load_tile<HD>(dst, kb, kv_stride, ks, kMmaBK, S, h);
    load_tile<HD>(dst + kMmaBK * kLd, vb, kv_stride, ks, kMmaBK, S, h);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // the band: keys (q0 - window, q0 + kMmaBQ), from a tile-aligned start
  int k_lo = q0 - window + 1;
  k_lo = k_lo < 0 ? 0 : (k_lo / kMmaBK) * kMmaBK;
  const int k_hi = min(S, q0 + kMmaBQ);
  const int n_tiles = (k_hi - k_lo + kMmaBK - 1) / kMmaBK;
  load_tile<HD>(sQ, qb, q_stride, q0, kMmaBQ, S, h);
  load_kv(0, k_lo);
  cp_async_commit();
  // two stages: tile it + 1 is copied in while tile it is computed
  for (int it = 0; it < n_tiles; ++it) {
    const int ks = k_lo + it * kMmaBK;
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, ks + kMmaBK);
    cp_async_commit();
    cp_async_wait<1>();   // all but the prefetch have landed
    __syncthreads();
    const __nv_bfloat16* sK = sKV + (it & 1) * 2 * kMmaBK * kLd;
    const __nv_bfloat16* sV = sK + kMmaBK * kLd;
    // does any row of this warp see a key of the tile? (warp-uniform)
    const bool active = r_lo < S && ks <= r_lo + 15 &&
                        ks + kMmaBK - 1 > r_lo - window;
    if (active) {
      float sc[kT][4];
#pragma unroll
      for (int j = 0; j < kT; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(smem_u32(sQ + (16 * warp + (lane & 15)) * kLd + 16 * kk +
                         8 * (lane >> 4)), a);
#pragma unroll
        for (int j = 0; j < kT; j += 2) {
          uint32_t bk[4];   // b0, b1 of key tiles j and j + 1
          ldsm_x4(smem_u32(sK + (8 * j + 8 * (lane >> 4) + (lane & 7)) * kLd +
                           16 * kk + 8 * ((lane >> 3) & 1)), bk);
          mma_bf16(sc[j], a, bk[0], bk[1]);
          mma_bf16(sc[j + 1], a, bk[2], bk[3]);
        }
      }

      // online softmax; element e of tile j is row row[e / 2], key
      // ks + 8 j + 2 tig + e % 2
      uint32_t live = 0;
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ks + 8 * j + 2 * tig + (e & 1);
          const int d = row[e >> 1] - key;
          const bool in = key < S && d >= 0 && d < window;
          float x = sc[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          sc[j][e] = in ? x : kNegInf;
          live |= (uint32_t)in << (4 * j + e);
          mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
        }
      }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = (live >> (4 * j + e)) & 1u
                         ? expf(sc[j][e] - m[e >> 1]) : 0.f;
          psum[e >> 1] += sc[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l[r] = l[r] * alpha[r] + psum[r];
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // o += p . v over the tile's 16-key steps, p = hi + lo
#pragma unroll
      for (int t = 0; t < kMmaBK / 16; ++t) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * t][0], sc[2 * t][1], ph[0], pl[0]);
        split_bf16(sc[2 * t][2], sc[2 * t][3], ph[1], pl[1]);
        split_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < kN; n += 2) {
          uint32_t bv[4];   // b0, b1 of output tiles n and n + 1
          const int key = 16 * t + 8 * ((lane >> 3) & 1) + (lane & 7);
          ldsm_x4_t(smem_u32(sV + key * kLd + 8 * n + 8 * (lane >> 4)), bv);
          mma_bf16(o[n], ph, bv[0], bv[1]);
          mma_bf16(o[n], pl, bv[0], bv[1]);
          mma_bf16(o[n + 1], ph, bv[2], bv[3]);
          mma_bf16(o[n + 1], pl, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* ob = out + ((int64_t)b * S + row[r]) * q_stride +
                        (int64_t)head * h;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c < h)
        *reinterpret_cast<__nv_bfloat162*>(ob + c) = __floats2bfloat162_rn(
            o[n][2 * r] / den, o[n][2 * r + 1] / den);
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int Kh, int h, int window, float scale,
                float softcap, cudaStream_t stream) {
  const size_t smem = (size_t)(kMmaBQ + 4 * kMmaBK) * (HD + 8) * 2;
  auto kern = local_attention_kernel_bf16<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kMmaBQ - 1) / kMmaBQ);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, H, Kh, h, window,
      scale, softcap);
  return (int)cudaGetLastError();
}

// ---- bfloat16 at h in {64, 128, 256}: wgmma fed by TMA ----

constexpr int kWgBK = 64;           // keys per tile
constexpr int kWgThreads = 384;     // two consumer warpgroups, one producer
constexpr int kStages = 2;          // K and V ring depth
constexpr int kBox = 64;            // columns per TMA box: one 128-byte row
constexpr int kBars = 2 + 4 * kStages;
constexpr float kLog2e = 1.4426950408889634f;

// How the two consumer warpgroups share a work item. At h 64 and 128 each
// owns 64 of the item's 128 query rows. At h 256 the 64 x 256 float32
// output takes 128 registers a thread, more than fit beside s and p in
// the 168 a thread this kernel compiles to (setmaxnreg did not raise the
// consumers' allocation in any layout tried, for reasons not known), so
// there both warpgroups take the same 64 rows and each owns 128 of the
// output columns: each computes s = q k^T itself, a third more
// tensor-core work than the row split, and no spill.
__host__ __device__ constexpr bool col_split(int hd) { return hd == 256; }
__host__ __device__ constexpr int wg_rows(int hd) {
  return col_split(hd) ? 64 : 128;
}

// mbarriers: a full/empty pair for Q and for each K and V stage; a full
// barrier takes the producer's arrival and the TMA bytes, an empty one the
// eight consumer warps' arrivals
__device__ __forceinline__ uint32_t full_q(uint32_t bars) { return bars; }
__device__ __forceinline__ uint32_t empty_q(uint32_t bars) { return bars + 8; }
__device__ __forceinline__ uint32_t full_k(uint32_t bars, int s) {
  return bars + 16 + 16 * s;
}
__device__ __forceinline__ uint32_t empty_k(uint32_t bars, int s) {
  return bars + 24 + 16 * s;
}
__device__ __forceinline__ uint32_t full_v(uint32_t bars, int s) {
  return bars + 16 + 16 * kStages + 16 * s;
}
__device__ __forceinline__ uint32_t empty_v(uint32_t bars, int s) {
  return bars + 24 + 16 * kStages + 16 * s;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// waits for the phase of parity `parity` to complete; a pipeline that
// stalls for four seconds traps (a launch error) instead of hanging the
// card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 1023) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

// the same for a whole warp, which leaves it converged for the .aligned
// instructions that follow (wgmma, bar)
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar,
                                               uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// named barriers that hand the tensor cores from one consumer warpgroup
// to the other
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers that an asynchronous wgmma reads or writes at this point
// of the program, so the compiler neither reads them earlier nor reuses
// them before the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled shared-memory operand:
// rows of 128 bytes in atoms of 8 rows (1024 bytes, SBO); `lbo` is the
// byte stride between 64-column boxes along N for an N-major operand
// (ignored for a K-major one)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, float32) (+)= A (64 x 16, K-major in shared memory) *
// B (64 x 16, K-major in shared memory)^T; d is overwritten when !acc
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, float32) += A (64 x 16, bf16 fragments in registers) *
// B (16 x 64, N-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, bf16 fragments in registers) *
// B (16 x 128, N-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// the work items, (batch x head, query tile of wg_rows(HD) rows), longest
// bands first: item i is query tile n_qt - 1 - i / BH. A block takes every
// gridDim.x-th item, in a snake (even rounds left to right, odd rounds
// right to left), so the longest and shortest bands pair up.
struct Item {
  int b, head, q0;
};

__device__ __forceinline__ bool item_at(int round, int n_items, int n_qt,
                                        int H, int bq, Item& w) {
  const int pos = round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int i = round * gridDim.x + pos;
  if (i >= n_items) return false;
  const int BH = n_items / n_qt;
  const int bh = i % BH;
  w.b = bh / H;
  w.head = bh % H;
  w.q0 = (n_qt - 1 - i / BH) * bq;
  return true;
}

// the band of a query tile: keys (q0 - window, q0 + bq), from a
// tile-aligned start; returns the number of key tiles
__device__ __forceinline__ int band(int q0, int bq, int S, int window,
                                    int& k_lo) {
  k_lo = q0 - window + 1;
  k_lo = k_lo < 0 ? 0 : (k_lo / kWgBK) * kWgBK;
  const int k_hi = min(S, q0 + bq);
  return (k_hi - k_lo + kWgBK - 1) / kWgBK;
}

// HD = h. Q, K and V come in through 4-D tensor maps over (h, heads, S, B)
// with 64-column boxes and the 128-byte swizzle; rows past S are zero.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
local_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, int S, int H,
                             int Kh, int window, float scale,
                             float softcap, int n_items, int n_qt) {
  constexpr int kBoxes = HD / kBox;
  constexpr int kBQ = wg_rows(HD);
  constexpr int kNO = col_split(HD) ? HD / 2 : HD;   // output columns per wg
  constexpr uint32_t kQBytes = kBQ * HD * 2;
  constexpr uint32_t kKVBytes = kWgBK * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  // swizzled TMA boxes need 1024-byte aligned destinations
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bars = sV + kStages * kKVBytes;
  // the warp index through a shuffle, so the compiler knows it is
  // warp-uniform (setmaxnreg and the roles below are per warp)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(bars + 8 * i, i & 1 ? 8 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;   // K/V tiles issued so far, over all items
      Item w;
      for (int round = 0; item_at(round, n_items, n_qt, H, kBQ, w); ++round) {
        int k_lo;
        const int n_t = band(w.q0, kBQ, S, window, k_lo);
        const int kvh = w.head / (H / Kh);
        mbar_wait(empty_q(bars), (round & 1) ^ 1);
        mbar_expect_tx(full_q(bars), kQBytes);
        for (int p = 0; p < kBoxes; ++p)
          tma_load_4d(sQ + p * kBQ * 128, &tq, full_q(bars), p * kBox,
                      w.head, w.q0, w.b);
        for (int t = 0; t < n_t; ++t, ++it) {
          const int s = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          const int ks = k_lo + t * kWgBK;
          mbar_wait(empty_k(bars, s), ph ^ 1);
          mbar_expect_tx(full_k(bars, s), kKVBytes);
          for (int p = 0; p < kBoxes; ++p)
            tma_load_4d(sK + s * kKVBytes + p * kWgBK * 128, &tk,
                        full_k(bars, s), p * kBox, kvh, ks, w.b);
          mbar_wait(empty_v(bars, s), ph ^ 1);
          mbar_expect_tx(full_v(bars, s), kKVBytes);
          for (int p = 0; p < kBoxes; ++p)
            tma_load_4d(sV + s * kKVBytes + p * kWgBK * 128, &tv,
                        full_v(bars, s), p * kBox, kvh, ks, w.b);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: 64 query rows each, or at h 256 the
    // same 64 rows and half the output columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;
    const int g = lane >> 2, tig = lane & 3;   // fragment row, column pair
    const float scale_log2 = scale * kLog2e;
    // warpgroup 0 takes the tensor cores first
    if (wg == 1) bar_arrive(1);
    int it = 0;   // K/V tiles consumed so far, over all items
    Item w;
    for (int round = 0; item_at(round, n_items, n_qt, H, kBQ, w); ++round) {
      int k_lo;
      const int n_t = band(w.q0, kBQ, S, window, k_lo);
      // the warpgroup's rows and its first output column
      const int r0 = col_split(HD) ? w.q0 : w.q0 + 64 * wg;
      const int c0 = col_split(HD) ? wg * kNO : 0;
      const int row0 = r0 + 16 * (warp % 4) + g;   // this thread's: +0, +8
      float o[kNO / 2];
#pragma unroll
      for (int i = 0; i < kNO / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      uint32_t ph[4][4], pl[4][4];   // p = hi + lo, per 16-key step
      mbar_wait_warp(full_q(bars), round & 1);
      const uint32_t q_base = sQ + (r0 - w.q0) * 128;

      // step t issues s = q k_t^T and o += p_{t-1} v_{t-1} back to back
      // and hands the tensor cores to the other warpgroup, whose products
      // then run under this one's softmax of s; step n_t only adds the
      // last p.v
      for (int t = 0; t <= n_t; ++t) {
        const int cur = it + t, prev = cur - 1;
        float sc[32];
        if (t < n_t)
          mbar_wait_warp(full_k(bars, cur % kStages), (cur / kStages) & 1);
        if (t > 0)
          mbar_wait_warp(full_v(bars, prev % kStages), (prev / kStages) & 1);
        bar_sync(1 + wg);
        wgmma_fence();
        if (t < n_t) {
          const uint32_t k_base = sK + (cur % kStages) * kKVBytes;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_n64(sc,
                         sw128_desc(q_base + (kk / 4) * kBQ * 128 +
                                        (kk % 4) * 32, 16),
                         sw128_desc(k_base + (kk / 4) * kWgBK * 128 +
                                        (kk % 4) * 32, 16),
                         kk > 0);
        }
        if (t > 0) {
          // the warpgroup's columns start at box c0 / 64
          const uint32_t v_base =
              sV + (prev % kStages) * kKVBytes + (c0 / kBox) * kWgBK * 128;
#pragma unroll
          for (int kt = 0; kt < kWgBK / 16; ++kt) {
            const uint64_t dv = sw128_desc(v_base + kt * 16 * 128,
                                           kWgBK * 128);
            wgmma_rs<kNO>(o, ph[kt], dv);
            wgmma_rs<kNO>(o, pl[kt], dv);
          }
        }
        wgmma_commit();
        bar_arrive(2 - wg);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(ph);
        reg_fence(pl);
        if (t == n_t) {
          if (lane == 0) mbar_arrive(empty_v(bars, prev % kStages));
          __syncwarp();
          break;
        }
        reg_fence(sc);
        if (lane == 0) {
          mbar_arrive(empty_k(bars, cur % kStages));
          if (t > 0) mbar_arrive(empty_v(bars, prev % kStages));
          if (t == n_t - 1) mbar_arrive(empty_q(bars));
        }
        __syncwarp();

        // logits in log2 units; element i is row row0 + 8 ((i >> 1) & 1),
        // key ks + 8 (i >> 2) + 2 tig + (i & 1)
        if (softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = softcap * tanhf(sc[i] * scale / softcap) * kLog2e;
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
        }
        // edge tiles of the band mask per (row, key); in an interior tile
        // every key is visible to every row of the warpgroup
        const int ks = k_lo + t * kWgBK;
        const bool interior = ks + kWgBK - 1 <= r0 && r0 + 63 - ks < window &&
                              ks + kWgBK <= S;
        uint32_t live = 0xffffffffu;
        if (!interior) {
          live = 0u;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = ks + 8 * (i >> 2) + 2 * tig + (i & 1);
            const int d = row0 + 8 * ((i >> 1) & 1) - key;
            const bool in = key < S && d >= 0 && d < window;
            live |= (uint32_t)in << i;
            sc[i] = in ? sc[i] : kNegInf;
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mt = kNegInf;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            mt = fmaxf(mt, sc[(i >> 1) * 4 + 2 * r + (i & 1)]);
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float m_new = fmaxf(m[r], mt);
          alpha[r] = ex2(m[r] - m_new);
          m[r] = m_new;
        }
        if (interior) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = (live >> i) & 1u ? ex2(sc[i] - m[(i >> 1) & 1]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float psum = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            psum += sc[(i >> 1) * 4 + 2 * r + (i & 1)];
          psum += __shfl_xor_sync(0xffffffffu, psum, 1);
          psum += __shfl_xor_sync(0xffffffffu, psum, 2);
          l[r] = l[r] * alpha[r] + psum;
        }
#pragma unroll
        for (int i = 0; i < kNO / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        // the accumulator of s is the A fragment of p: 16-key step kt is
        // elements 8 kt .. 8 kt + 7
#pragma unroll
        for (int kt = 0; kt < 4; ++kt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_bf16(sc[8 * kt + 2 * j], sc[8 * kt + 2 * j + 1], ph[kt][j],
                       pl[kt][j]);
      }
      it += n_t;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= S) continue;
        const float den = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* ob =
            out + (((int64_t)w.b * S + row) * H + w.head) * HD;
#pragma unroll
        for (int n = 0; n < kNO / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(ob + c0 + 8 * n + 2 * tig) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] / den,
                                    o[4 * n + 2 * r + 1] / den);
      }
    }
    // the last hand-over of warpgroup 1 is taken here, so every arrival
    // on the named barriers is matched
    if (wg == 0) bar_sync(1);
  }
}

// cuTensorMapEncodeTiled is a driver-API function: it is fetched through
// the runtime, so the library links as the others do (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, heads, h) bf16 tensor as 4-D (h, heads, S, B), boxes of 64
// columns x `rows` rows of one head, 128-byte swizzle; out-of-range rows
// read as zero
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int h, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)h, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)h * 2,
                                 (cuuint64_t)heads * h * 2,
                                 (cuuint64_t)S * heads * h * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
size_t wgmma_smem_bytes() {
  return 1024 + (size_t)(wg_rows(HD) + 2 * kStages * kWgBK) * HD * 2 +
         8 * kBars;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int Kh, int window, float scale,
                 float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, HD, wg_rows(HD)) ||
      !tensor_map(&tk, k, B, S, Kh, HD, kWgBK) ||
      !tensor_map(&tv, v, B, S, Kh, HD, kWgBK))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes<HD>();
  auto kern = local_attention_kernel_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + wg_rows(HD) - 1) / wg_rows(HD);
  const int64_t n_items = (int64_t)B * H * n_qt;
  if (n_items > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_items < sms ? n_items : sms);
  kern<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, (__nv_bfloat16*)out,
                                           S, H, Kh, window, scale, softcap,
                                           (int)n_items, n_qt);
  return (int)cudaGetLastError();
}

// ---- float32: the CUDA cores ----

constexpr int kThreads = 256;
constexpr int kBQ = 64;                       // query rows per block
constexpr int kBK = 32;                       // keys per tile
constexpr int kRowThreads = kThreads / kBQ;   // 4 threads per query row
constexpr int kKeys = kBK / kRowThreads;      // 8 scores per thread

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// HD: the head width rounded up to a power of two in [16, 256]; it sizes
// the per-thread accumulators, h itself is a runtime value.
template <int HD>
__global__ void __launch_bounds__(kThreads)
local_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int H, int Kh,
                           int h, int window, float scale, float softcap) {
  constexpr int kOut = HD / 16;   // float4 output chunks per thread
  extern __shared__ float4 smem[];
  const int h4 = h / 4;
  const int ld = h4 + 1;          // row stride in float4, padded
  float4* sQ = smem;
  float4* sK = sQ + kBQ * ld;
  float4* sV = sK + kBK * ld;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid % kRowThreads;    // this thread's quarter of the row
  const int r = tid / kRowThreads;    // query row within the tile
  const int b = blockIdx.y / H;
  const int head = blockIdx.y % H;
  const int kvh = head / (H / Kh);
  const int q0 = blockIdx.x * kBQ;
  const int iq = q0 + r;
  const int64_t q_stride = (int64_t)H * h;
  const int64_t kv_stride = (int64_t)Kh * h;
  const float* qb = q + ((int64_t)b * S * H + head) * h;
  const float* kb = k + ((int64_t)b * S * Kh + kvh) * h;
  const float* vb = v + ((int64_t)b * S * Kh + kvh) * h;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < kBQ * h4; e += kThreads) {
    const int rr = e / h4, c = e - rr * h4;
    const int s = q0 + rr;
    sQ[rr * ld + c] = s < S ? load4(qb + s * q_stride + 4 * c) : zero;
  }

  float m = kNegInf, l = 0.f;
  float4 acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = zero;

  // the band: keys (q0 - window, q0 + kBQ), from a tile-aligned start
  int k_lo = q0 - window + 1;
  k_lo = k_lo < 0 ? 0 : (k_lo / kBK) * kBK;
  const int k_hi = min(S, q0 + kBQ);
  for (int ks = k_lo; ks < k_hi; ks += kBK) {
    __syncthreads();   // the previous tile is consumed (and Q is stored)
    for (int e = tid; e < kBK * h4; e += kThreads) {
      const int rr = e / h4, c = e - rr * h4;
      const int s = ks + rr;
      const bool in = s < S;
      sK[rr * ld + c] = in ? load4(kb + s * kv_stride + 4 * c) : zero;
      sV[rr * ld + c] = in ? load4(vb + s * kv_stride + 4 * c) : zero;
    }
    __syncthreads();

    float sc[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) sc[j] = 0.f;
    for (int c = 0; c < h4; ++c) {
      const float4 qv = sQ[r * ld + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float4 kv = sK[(g + kRowThreads * j) * ld + c];
        sc[j] = fmaf(qv.x, kv.x, sc[j]);
        sc[j] = fmaf(qv.y, kv.y, sc[j]);
        sc[j] = fmaf(qv.z, kv.z, sc[j]);
        sc[j] = fmaf(qv.w, kv.w, sc[j]);
      }
    }
    bool live[kKeys];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int jk = ks + g + kRowThreads * j;
      const int d = iq - jk;
      live[j] = jk < S && d >= 0 && d < window;
      float s = sc[j] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sc[j] = live[j] ? s : kNegInf;
      m_tile = fmaxf(m_tile, sc[j]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float p[kKeys];
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      p[j] = live[j] ? expf(sc[j] - m_new) : 0.f;
      psum += p[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int gg = 0; gg < kRowThreads; ++gg) {
        const float pj = __shfl_sync(0xffffffffu, p[j],
                                     (lane & ~(kRowThreads - 1)) | gg);
        const float4* vrow = sV + (gg + kRowThreads * j) * ld;
#pragma unroll
        for (int i = 0; i < kOut; ++i) {
          const int c = g + kRowThreads * i;
          if (c < h4) {
            const float4 vv = vrow[c];
            acc[i].x = fmaf(pj, vv.x, acc[i].x);
            acc[i].y = fmaf(pj, vv.y, acc[i].y);
            acc[i].z = fmaf(pj, vv.z, acc[i].z);
            acc[i].w = fmaf(pj, vv.w, acc[i].w);
          }
        }
      }
    }
  }

  if (iq < S) {
    const float den = fmaxf(l, 1e-30f);
    float* ob = out + ((int64_t)b * S + iq) * q_stride + (int64_t)head * h;
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int c = g + kRowThreads * i;
      if (c < h4) {
        store4(ob + 4 * c, make_float4(acc[i].x / den, acc[i].y / den,
                                       acc[i].z / den, acc[i].w / den));
      }
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int Kh, int h, int window, float scale,
               float softcap, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ + 2 * kBK) * (h / 4 + 1) * sizeof(float4);
  auto kern = local_attention_kernel_f32<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H,
      Kh, h, window, scale, softcap);
  return (int)cudaGetLastError();
}

// the route for (type, h): 0 the CUDA cores (float32), 1 mma.sync
// (bfloat16 at any other width), 2 wgmma fed by TMA (bfloat16 at h 64,
// 128 or 256)
int route(int is_bf16, int h) {
  if (!is_bf16) return 0;
  return h == 64 || h == 128 || h == 256 ? 2 : 1;
}

// the kernel of `route(is_bf16, h)`, its HD the head width rounded up to
// a power of two in [16, 256]
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Kh, int h, int window, float scale,
           float softcap, int is_bf16, cudaStream_t stream) {
  const int rt = route(is_bf16, h);
  if constexpr (HD >= 64) {
    if (rt == 2)
      return launch_wgmma<HD>(q, k, v, out, B, S, H, Kh, window, scale,
                              softcap, stream);
  }
  return rt == 1 ? launch_bf16<HD>(q, k, v, out, B, S, H, Kh, h, window,
                                   scale, softcap, stream)
                 : launch_f32<HD>(q, k, v, out, B, S, H, Kh, h, window,
                                  scale, softcap, stream);
}

}  // namespace

extern "C" int local_attention_route(int is_bf16, int h) {
  return route(is_bf16, h);
}

// Launches on `stream` and returns a CUDA error code (0 on success).
// is_bf16 selects bfloat16 tensors, else float32.
extern "C" int local_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int S, int H, int Kh, int h,
                                      int window, float scale,
                                      float softcap, int is_bf16,
                                      void* stream) {
  if (h <= 0 || h > 256 || h % 4 || Kh <= 0 || H % Kh || window <= 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (h <= 16)
    return launch<16>(q, k, v, out, B, S, H, Kh, h, window, scale, softcap,
                      is_bf16, st);
  if (h <= 32)
    return launch<32>(q, k, v, out, B, S, H, Kh, h, window, scale, softcap,
                      is_bf16, st);
  if (h <= 64)
    return launch<64>(q, k, v, out, B, S, H, Kh, h, window, scale, softcap,
                      is_bf16, st);
  if (h <= 128)
    return launch<128>(q, k, v, out, B, S, H, Kh, h, window, scale, softcap,
                       is_bf16, st);
  return launch<256>(q, k, v, out, B, S, H, Kh, h, window, scale, softcap,
                     is_bf16, st);
}
