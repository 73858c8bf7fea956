// The counter hash shared by every kernel of the port that draws a
// stochastic write failure (extent_write.cu, scrub.cu, kv_quant.cu).
// Two entry points: uniform_bits (one draw from a hash base) and the
// folded draw (fold, fmix32_mid, draw_key, collect) for kernels that hash
// many planes of one index.
//
// It is the JAX package's uniform_bits
// (src/repro/kernels/extent_write/kernel.py): a deterministic uniform
// uint32 for (seed, flat index, bit plane),
//   u = fmix32((index * 2654435761) ^ (plane * 0x9E3779B9) ^ seed),
// with murmur3's fmix32 finaliser. It sees only the flat index, so any
// thread/block decomposition draws the same bits as the TPU kernels and
// the plain PyTorch twins (repro_torch/kernels/extent_write/ref.py).
#pragma once

#include <cstdint>

namespace counter_hash {

constexpr uint32_t kElem = 2654435761u;  // Knuth multiplicative, per index
constexpr uint32_t kBit = 0x9E3779B9u;   // golden-ratio increment, per plane

constexpr uint32_t kMix1 = 0x85EBCA6Bu;  // murmur3 fmix32's multipliers
constexpr uint32_t kMix2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMix1;
  x ^= x >> 13;
  x *= kMix2;
  x ^= x >> 16;
  return x;
}

// The index's part of the hash input, computed once per element: the
// draw for plane b is then fmix32(base ^ (b * kBit)).
__device__ __forceinline__ uint32_t hash_base(uint32_t index, uint32_t seed) {
  return index * kElem ^ seed;
}

__device__ __forceinline__ uint32_t uniform_bits(uint32_t base, int plane) {
  return fmix32(base ^ ((uint32_t)plane * kBit));
}

// The folded draw: the second entry point, for kernels that hash many
// planes of one index. fmix32 starts with x ^= x >> 16, and that step
// distributes over ^: fold(a ^ b) = fold(a) ^ fold(b) for
// fold(v) = v ^ (v >> 16). So with base = index * kElem ^ seed and
//   folded = fold(index * kElem) ^ fold(seed) ^ fold(b * kBit),
//   m      = fmix32_mid(folded),
// uniform_bits(base, b) == m ^ (m >> 16) bit for bit. fold(index * kElem)
// is computed once per index and fold(seed) ^ fold(b * kBit) once per
// plane, so a draw costs one ^ before fmix32_mid.
__host__ __device__ constexpr uint32_t fold(uint32_t v) {
  return v ^ (v >> 16);
}

// fmix32 after its first xorshift, up to but not including its last one.
__device__ __forceinline__ uint32_t fmix32_mid(uint32_t folded) {
  uint32_t x = folded * kMix1;
  x ^= x >> 13;
  return x * kMix2;
}

// The draw held against a threshold without fmix32's last xorshift:
//   (m ^ (m >> 16)) < thr  <=>  (m ^ (thr >> 16)) < thr.
// Both left-hand values have m's upper half. If it is below thr's upper
// half, both are below thr; if above, neither is; if equal, m >> 16 ==
// thr >> 16 and the two values are the same. So the draw of `folded`
// fails (falls below thr) exactly when draw_key(folded, thr >> 16) < thr.
__device__ __forceinline__ uint32_t draw_key(uint32_t folded,
                                             uint32_t thr_hi) {
  return fmix32_mid(folded) ^ thr_hi;
}

// 2 acc + (u >= thr), which collects the outcomes of many draws into one
// word: the subtraction's carry is set when u does not fall below thr,
// and the multiply-add takes it in (IADD3 and IMAD.X in SASS, so no
// select or predicated or per draw).
__device__ __forceinline__ uint32_t collect(uint32_t acc, uint32_t u,
                                            uint32_t thr) {
  uint32_t out;
  asm("{\n\t.reg .u32 d;\n\tsub.cc.u32 d, %1, %2;\n\t"
      "madc.lo.u32 %0, %3, 2, 0;\n\t}"
      : "=r"(out) : "r"(u), "r"(thr), "r"(acc));
  return out;
}

}  // namespace counter_hash
