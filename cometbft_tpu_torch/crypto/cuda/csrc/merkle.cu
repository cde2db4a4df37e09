// RFC-6962 Merkle trees on the card: merkle_level (one level, one thread
// per output node) and merkle_tree (leaves and every level in one launch).
//
// merkle_level replaces the tree part of cometbft_tpu/crypto/tpu/merkle.py
// (_tree_reduce, :103, inside _tree_kernel, :135): in u32[m, 8] digests
// (big-endian words) -> out u32[(m+1)/2, 8]: node t < m/2 is
// SHA-256(0x01 || in[2t] || in[2t+1]), two blocks of the 65-byte message;
// when m is odd the last digest is carried up unhashed. Repeating the
// level until one node is left gives the tree of crypto/merkle.py (split
// at the largest power of two below n) for every n.
//
// merkle_tree replaces _leaves_and_tree_kernel (:141): the padded
// 0x00 || item leaf blocks u32[n, nb, 16] and their live block counts
// int32[n] -> the root u32[8], the ragged leaf hashing and every level
// with no host round trip between them.
//
// What bounds them on this card: at the validator-set sizes (a few
// hundred leaves) a level is a few hundred threads on a 132-SM card, so
// the latency of the levels' dependent hashes and of each launch bound
// the tree, not arithmetic or bytes: merkle_level took 8 launches for a
// 180-leaf tree and the leaves a ninth. merkle_tree runs the whole tree
// in one block of TREE_THREADS threads: the leaves, then each level, with
// __syncthreads between them, every level in shared memory once it holds
// at most SMEM_NODES nodes. A larger tree's first levels go through a
// global scratch buffer of n + (n+1)/2 nodes, two halves taken in turn,
// still in the one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

#define TREE_THREADS 1024
#define SMEM_NODES 1024  // 32 KB of shared memory, 32 bytes a node
static_assert(2 * TREE_THREADS >= SMEM_NODES, "a level in shared memory takes one thread a node above it");

// out = SHA-256(0x01 || l || r), the three as big-endian words.
__device__ __forceinline__ void inner_hash(uint32_t out[8], const uint32_t l[8], const uint32_t r[8]) {
  uint32_t w[16];
  // block 0: 0x01 then the first 63 bytes of left || right
  w[0] = (0x01u << 24) | (l[0] >> 8);
#pragma unroll
  for (int j = 1; j < 8; ++j) w[j] = (l[j - 1] << 24) | (l[j] >> 8);
  w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
  for (int j = 1; j < 8; ++j) w[8 + j] = (r[j - 1] << 24) | (r[j] >> 8);
  sha256_init(out);
  sha256_compress(out, w);
  // block 1: the last byte, the 0x80 terminator, the 520-bit length
  w[0] = (r[7] << 24) | (0x80u << 16);
#pragma unroll
  for (int j = 1; j < 15; ++j) w[j] = 0;
  w[15] = 65 * 8;
  sha256_compress(out, w);
}

__global__ void merkle_level_kernel(const uint32_t *__restrict__ in,
                                    uint32_t *__restrict__ out, int m) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int pairs = m / 2;
  if (t < pairs) {
    uint32_t l[8], r[8], st[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l[j] = in[(size_t)(2 * t) * 8 + j];
      r[j] = in[(size_t)(2 * t + 1) * 8 + j];
    }
    inner_hash(st, l, r);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(size_t)t * 8 + j] = st[j];
  } else if (t == pairs && (m & 1)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(size_t)t * 8 + j] = in[(size_t)(m - 1) * 8 + j];
  }
}

// --- merkle_tree ----------------------------------------------------------

// Leaf i's digest: its first n_live[i] (clamped to [0, nb]) blocks. A call
// of its own, so that the loop over a thread's leaves holds no second loop.
__device__ __noinline__ void leaf_digest(uint32_t *dst, const uint32_t *__restrict__ blocks,
                                         const int32_t *__restrict__ n_live, int nb, int i) {
  const int live = min(max(n_live[i], 0), nb);
  const uint32_t *msg = blocks + (size_t)i * nb * 16;
  uint32_t st[8];
  sha256_init(st);
  for (int blk = 0; blk < live; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = msg[blk * 16 + j];
    sha256_compress(st, w);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = st[j];
}

// Node t of the level above the m nodes at src: the pair's hash, or the
// odd tail carried up.
__device__ __forceinline__ void parent(uint32_t out[8], const uint32_t *src, int m, int t) {
  uint32_t l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) l[j] = src[(size_t)(2 * t) * 8 + j];
  if (2 * t + 1 < m) {
    uint32_t r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = src[(size_t)(2 * t + 1) * 8 + j];
    inner_hash(out, l, r);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = l[j];
  }
}

__global__ void __launch_bounds__(TREE_THREADS)
merkle_tree_kernel(const uint32_t *__restrict__ blocks, const int32_t *__restrict__ n_live,
                   int n, int nb, uint32_t *scratch, uint32_t *__restrict__ root) {
  __shared__ uint32_t s_nodes[SMEM_NODES * 8];
  const int tid = threadIdx.x;

  // the leaves, into shared memory or (a larger tree) the scratch's first half
  uint32_t *leaves = n <= SMEM_NODES ? s_nodes : scratch;
  for (int i = tid; i < n; i += blockDim.x) leaf_digest(leaves + (size_t)i * 8, blocks, n_live, nb, i);
  __syncthreads();

  // levels of more than SMEM_NODES nodes: scratch half to half, the first
  // level that fits written to shared memory
  int m = n;
  uint32_t *src = scratch, *other = scratch + (size_t)n * 8;
  while (m > SMEM_NODES) {
    const int up = (m + 1) / 2;
    uint32_t *dst = up <= SMEM_NODES ? s_nodes : other;
    for (int t = tid; t < up; t += blockDim.x) {
      uint32_t node[8];
      parent(node, src, m, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(size_t)t * 8 + j] = node[j];
    }
    __syncthreads();
    other = src;
    src = dst;
    m = up;
  }

  // levels in shared memory, one node a thread: read, barrier, write
  while (m > 1) {
    const int up = (m + 1) / 2;
    uint32_t node[8];
    if (tid < up) parent(node, s_nodes, m, tid);
    __syncthreads();
    if (tid < up) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s_nodes[tid * 8 + j] = node[j];
    }
    __syncthreads();
    m = up;
  }
  if (tid < 8) root[tid] = s_nodes[tid];
}

extern "C" int cbt_merkle_level(const void *in, void *out, int m, void *stream) {
  const int threads = 128;
  const int n_out = (m + 1) / 2;
  const int grid = (n_out + threads - 1) / threads;
  merkle_level_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)in, (uint32_t *)out, m);
  return (int)cudaGetLastError();
}

// scratch: u32[n + (n+1)/2, 8], read and written only when n > SMEM_NODES.
extern "C" int cbt_merkle_tree(const void *blocks, const void *n_live, int n, int nb,
                               void *scratch, void *root, void *stream) {
  if (n < 1 || nb < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  merkle_tree_kernel<<<1, TREE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)blocks, (const int32_t *)n_live, n, nb, (uint32_t *)scratch,
      (uint32_t *)root);
  return (int)cudaGetLastError();
}
