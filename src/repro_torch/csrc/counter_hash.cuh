// The counter hash shared by every kernel of the port that draws a
// stochastic write failure (extent_write.cu, scrub.cu, kv_quant.cu).
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

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
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

}  // namespace counter_hash
