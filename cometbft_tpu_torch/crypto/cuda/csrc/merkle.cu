// merkle_level: one level of an RFC-6962 tree, one thread per output node.
//
// Replaces the tree part of cometbft_tpu/crypto/tpu/merkle.py
// (_tree_reduce, :103, inside _tree_kernel and _leaves_and_tree_kernel,
// :135-141). in u32[m, 8] digests (big-endian words) -> out
// u32[(m+1)/2, 8]: node t < m/2 is SHA-256(0x01 || in[2t] || in[2t+1]),
// two blocks of the 65-byte message; when m is odd the last digest is
// carried up unhashed. Repeating the level until one node is left gives
// the tree of crypto/merkle.py (split at the largest power of two below
// n) for every n.
//
// What bounds it on this card: at the validator-set sizes (a few hundred
// leaves) one level is a few hundred threads on a 132-SM card, so the
// launch and its dependency on the level before bound it, not arithmetic
// or bytes; the host launches log2(n) levels back to back. The TPU kernel
// ran a fixed log2(P) levels over padded lanes in one program; a fused
// single-launch tree (one block, levels separated by __syncthreads) is a
// later step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

__global__ void merkle_level_kernel(const uint32_t *__restrict__ in,
                                    uint32_t *__restrict__ out, int m) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int pairs = m / 2;
  if (t < pairs) {
    uint32_t l[8], r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l[j] = in[(size_t)(2 * t) * 8 + j];
      r[j] = in[(size_t)(2 * t + 1) * 8 + j];
    }
    uint32_t w[16], st[8];
    // block 0: 0x01 then the first 63 bytes of left || right
    w[0] = (0x01u << 24) | (l[0] >> 8);
#pragma unroll
    for (int j = 1; j < 8; ++j) w[j] = (l[j - 1] << 24) | (l[j] >> 8);
    w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
    for (int j = 1; j < 8; ++j) w[8 + j] = (r[j - 1] << 24) | (r[j] >> 8);
    sha256_init(st);
    sha256_compress(st, w);
    // block 1: the last byte, the 0x80 terminator, the 520-bit length
    w[0] = (r[7] << 24) | (0x80u << 16);
#pragma unroll
    for (int j = 1; j < 15; ++j) w[j] = 0;
    w[15] = 65 * 8;
    sha256_compress(st, w);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(size_t)t * 8 + j] = st[j];
  } else if (t == pairs && (m & 1)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(size_t)t * 8 + j] = in[(size_t)(m - 1) * 8 + j];
  }
}

extern "C" int cbt_merkle_level(const void *in, void *out, int m, void *stream) {
  const int threads = 128;
  const int n_out = (m + 1) / 2;
  const int grid = (n_out + threads - 1) / threads;
  merkle_level_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)in, (uint32_t *)out, m);
  return (int)cudaGetLastError();
}
