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
// Two kernels, chosen by the input type:
//
// * bfloat16 (the served model's path): the tensor cores, through
//   mma.sync m16n8k16 with float32 accumulation. One block of 8 warps per
//   (batch x head, 128-row query tile), each warp owning 16 query rows;
//   the tiles with the longest bands are handed out first. The block
//   walks the 64-key tiles of its band (keys no row of the tile can see
//   are never loaded; a warp none of whose rows sees a tile skips its
//   products) through two shared-memory stages: cp.async copies tile
//   t + 1 in while tile t is computed. Rows are padded by 16 bytes so
//   that ldmatrix reads are free of bank conflicts, and the head width is
//   padded with zeros to the template's HD. q.k multiplies bf16 by bf16
//   into float32, which is exact per product. For p.v the float32
//   probabilities are split as p = hi + lo, both bf16 (16 significant
//   bits together), and both halves go through the tensor cores into the
//   same float32 accumulator: the p.v product keeps float32 probabilities
//   to a relative 2^-17, where one bf16 p would lose 2^-9. Shared memory
//   holds the Q tile and two K and V tiles, (128 + 4 x 64) x (HD + 8) x 2
//   bytes (198 KB at HD 256: one block per SM).
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
// Both raise the launch's shared-memory limit above the 48 KB default.

#include <cstdint>
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

// the kernel for the type, its HD the head width rounded up to a power of
// two in [16, 256]
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Kh, int h, int window, float scale,
           float softcap, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<HD>(q, k, v, out, B, S, H, Kh, h, window,
                                   scale, softcap, stream)
                 : launch_f32<HD>(q, k, v, out, B, S, H, Kh, h, window,
                                  scale, softcap, stream);
}

}  // namespace

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
