// sha256_blocks: SHA-256 of pre-padded messages, one thread per message.
//
// Replaces cometbft_tpu/crypto/tpu/sha256_pallas.py::_kernel (through
// _build_call and sha256_blocks, the package's only pl.pallas_call) and
// the XLA programs with the same contract, sha256.py::_sha256_blocks_xla
// and sha256_blocks_ragged. blocks u32[B, n_blocks, 16] (big-endian words)
// -> digests u32[B, 8]; with n_live (int32[B]) each lane compresses only
// its first n_live blocks, the ragged form.
//
// What bounds it on this card: integer operations, about 3,000 32-bit
// operations per block against 64 bytes read, so well above the card's
// operations-per-byte line. The Pallas kernel's grid of 128-lane tiles in
// VMEM becomes one thread per message with the schedule in registers
// (sha256.cuh); a lane that is done stops, where the TPU lanes all ran
// every block and masked. Thread b reads its own 64-byte rows, so the
// loads of a warp are strided, not coalesced: a later version could stage
// the blocks through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

__global__ void sha256_blocks_kernel(const uint32_t *__restrict__ blocks,
                                     const int32_t *__restrict__ n_live,
                                     uint32_t *__restrict__ out, int B,
                                     int n_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int n = n_blocks;
  if (n_live != nullptr) n = min(max(n_live[b], 0), n_blocks);
  uint32_t st[8];
  sha256_init(st);
  const uint32_t *msg = blocks + (size_t)b * n_blocks * 16;
  for (int blk = 0; blk < n; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = msg[blk * 16 + j];
    sha256_compress(st, w);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) out[(size_t)b * 8 + j] = st[j];
}

extern "C" int cbt_sha256_blocks(const void *blocks, const void *n_live,
                                 void *out, int B, int n_blocks, void *stream) {
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  sha256_blocks_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)blocks, (const int32_t *)n_live, (uint32_t *)out, B,
      n_blocks);
  return (int)cudaGetLastError();
}
