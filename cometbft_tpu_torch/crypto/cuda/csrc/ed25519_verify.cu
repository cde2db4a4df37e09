// Cofactorless Ed25519 verification on the wire-key routes: four kernels
// over one core, G threads a lane.
//
// verify_lane replaces cometbft_tpu/crypto/tpu/ed25519_batch.py::
// _verify_unpacked (:274), the group math that every jitted verify
// program of the reference ends in. The kernels differ only in where a
// lane finds A, R, s and h:
//
// * ed25519_verify_compact replaces _verify_core_compact
//   (verify_kernel_compact, :338-347): the compact wire u8[128, B],
//   byte-major (row r of lane b at r * B + b): rows 0:32 A, 32:64 R,
//   64:96 S, 96:128 h = SHA-512(R||A||M) mod L, all little-endian.
// * The resident routes (_verify_core_resident :805, _verify_core_indexed
//   :395) are not here: ed25519_resident.cu verifies them against comb
//   tables of each key built once at upload.
// * ed25519_verify_full_compact replaces verify_full_kernel_compact
//   (:370): wire u8[96, B] rows A, R, S, the message plane u8[MP, B]
//   (sha512.py::stage_ragged_np, prefix_len 64) and int32[B] lengths. Each
//   lane rebuilds R || A || M's SHA-512 blocks from the wire and the plane
//   in registers (the padding of sha512.py::blocks_from_bytes, :202),
//   compresses only its live blocks (sha512.cuh), reduces mod L exactly
//   (sc25519.cuh) and enters verify_lane.
// * ed25519_verify_words replaces _verify_core (verify_kernel, :328-335),
//   the u32 word wire (CBFT_TPU_WIRE=words): u32[32, B] row-major (word j
//   of lane b at j * B + b), rows 0:8 A, 8:16 R, 16:24 S, 24:32 h, all
//   little-endian words.
// * ed25519_verify_full_words replaces verify_full_kernel (:351): u32[24,
//   B] words of A, R, S, and R || A || M padded into SHA-512 blocks on the
//   host, as big-endian hi and lo halves u32[NB, 16, B] of each 64-bit
//   word, with int32[B] live block counts (clamped to [0, NB], as the
//   reference's mask over its NB blocks does). It compresses the live
//   blocks, reduces mod L and enters verify_lane.
//
// G threads verify a lane (G = 4 or 1, the wrapper's choice; 2 works
// too; ge25519_group.cuh). At G = 4 a block holds one warp of groups (8
// lanes) for a batch of up to 1,024 lanes, else 32 lanes and four; the
// threads after them, one a lane, decompress R and compute [s]B by the
// comb over B's tables, while each group computes [h](-A) with its table
// in shared memory; the group then adds [s]B. At G = 1 a block is 128
// lanes, one thread each, running the first design's joint loop
// (straus_one) and then R's decompression. Every thread of a group runs
// the loads and A's decompression on the same inputs, so nothing of them
// crosses the group; h, which the two
// device-hash kernels compute, is hashed by the thread beside the group
// and reaches the group through shared memory (barrier 1), which waits for
// it only after its table is built. No inversion:
// encode(P) equals R's bytes exactly when R's y (its low 255 bits) is below
// p, R decompresses, R is not x = 0 with the sign bit set, and X = x_R Z
// and Y = y_R Z, which thread 0 of the group checks. verify_lane is
// compiled once, not inlined into each kernel: it holds nearly all of a
// lane's work, and inlined copies multiply the build time.
//
// Output: u8[B], 1 where encode([s]B + [h](-A)) equals R byte for byte
// and A decompressed. The host ANDs it with its validity mask (s < L,
// lengths, absent lanes), exactly as the reference does.
//
// What bounds it on this card: at a commit (B = 180, G = 4) the latency
// of the group's chain: A's decompression (251 squarings), the table (14
// additions) and 256 doublings and 64 additions at one squaring or two
// products a round on each thread, with the operand exchanges between
// them: about 0.33 M instructions against the first design's 0.96 M
// (chip_smoke.py counts them). At a window (G = 1), integer operations,
// about 0.92 M a lane (the first design's 0.96 M less the carries of sums
// that feed only products), against 100 to 129 bytes moved; SHA-512 of
// two blocks and the reduction add under 2%.
//
// Semantics (reference :33-42): A's y is taken mod p and not rejected; a
// failed decompression rejects; -0 decodes as 0; a non-canonical R never
// matches. s >= L is rejected on the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "ge25519_group.cuh"
#include "sc25519.cuh"
#include "sha512.cuh"

// encode([s]B + [h](-A)) == R and A decompresses, from the little-endian
// u32 words of A, R, s and h; the verdict is the one of thread 0 of a live
// lane's group. Every thread of the block calls it; btab is B's comb
// tables (read at G = 2 and 4).
__device__ __noinline__ bool verify_lane(const uint32_t aw[8], const uint32_t rw[8],
                                         const uint32_t sw[8], const uint32_t hw[8],
                                         const uint32_t *__restrict__ btab, bool h_beside, lane_role r,
                                         int G) {
  extern __shared__ uint32_t s_tab[];  // the lanes' tables of -A at G = 2 and 4
  __shared__ uint32_t s_h[GROUP_LANES][8];  // h, when the threads beside the groups hashed
  __shared__ uint32_t s_rx[GROUP_LANES][10], s_ry[GROUP_LANES][10], s_rok[GROUP_LANES];
  __shared__ uint32_t s_sb[GROUP_LANES][4 * 10];  // [s]B, cached in the group's layout

  fe X, Y, Z, part[2];
  bool ok_a = false;
  if (r.r_warp) {
    if (h_beside) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s_h[r.g][j] = hw[j];
      h_arrive();
    }
    // R, then [s]B, beside the groups
    fe xc, yc;
    fe_zero(xc);
    fe_zero(yc);
    const bool ok = r.live && decode_r(xc, yc, rw);
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      s_rx[r.g][i] = xc.v[i];
      s_ry[r.g][i] = yc.v[i];
    }
    s_rok[r.g] = ok ? 1u : 0u;
    ge sb;
    ge_identity(sb);
    if (r.live) fixed_base(sb, sw, btab);
    cache_one(s_sb[r.g], sb);
  } else {
    if (G == 1 && !r.live) return false;  // no barrier at G = 1
    // -A = (-x, y), y taken mod p
    fe y, x, nx;
    fe_from_words(y, aw);
    ok_a = decompress(x, y, aw[7] >> 31);
    fe_neg(nx, x);
    if (G == 1) {
      ge neg_a, acc;
      neg_a.X = nx;
      neg_a.Y = y;
      fe_one(neg_a.Z);
      fe_mul(neg_a.T, nx, y);
      straus_one(acc, neg_a, sw, hw);
      X = acc.X;
      Y = acc.Y;
      Z = acc.Z;
    } else {
      variable_base_g(part, nx, y, h_beside ? s_h[r.g] : hw, h_beside, s_tab, r, G);
    }
  }
  if (G > 1) {
    __syncthreads();
    if (!r.r_warp) finish_group_g(X, Y, Z, part, s_sb[r.g], r, G);
  }
  if (r.r_warp || r.t != 0 || !r.live) return false;
  fe rx, ry, rz;
  bool same = ok_a;
  if (G == 1) {
    same &= decode_r(rx, ry, rw);
  } else {
    same &= s_rok[r.g] != 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      rx.v[i] = s_rx[r.g][i];
      ry.v[i] = s_ry[r.g][i];
    }
  }
  fe_mul(rz, rx, Z);
  same &= fe_eq(X, rz);
  fe_mul(rz, ry, Z);
  same &= fe_eq(Y, rz);
  return same;
}

__global__ void __launch_bounds__(MAX_THREADS)
ed25519_verify_compact_kernel(const uint8_t *__restrict__ wire, const uint32_t *__restrict__ btab,
                              uint8_t *__restrict__ out, int B, int G) {
  const lane_role r = lane_role_of(G, B);
  uint32_t aw[8] = {0}, rw[8] = {0}, sw[8] = {0}, hw[8] = {0};
  if (r.live) {
    load_words(aw, wire, 0, B, r.b);
    load_words(rw, wire, 32, B, r.b);
    load_words(sw, wire, 64, B, r.b);
    load_words(hw, wire, 96, B, r.b);
  }
  const bool ok = verify_lane(aw, rw, sw, hw, btab, false, r, G);
  if (!r.r_warp && r.t == 0 && r.live) out[r.b] = ok ? 1 : 0;
}

// Byte pos (>= 64) of lane b's padded stream R || A || M || 0x80 || 0 ||
// 128-bit big-endian bit length, as sha512.py::blocks_from_bytes lays it:
// the length field wins, then the message, then the terminator.
__device__ __forceinline__ uint64_t stream_byte(int pos, int tlen, int end,
                                                uint64_t bit_len,
                                                const uint8_t *__restrict__ msg,
                                                int B, int b) {
  if (pos >= end - 16) {
    const int shift = (end - 1 - pos) * 8;
    return shift < 64 ? (bit_len >> shift) & 0xFFu : 0u;
  }
  if (pos < tlen) return msg[(size_t)(pos - 64) * B + b];
  return pos == tlen ? 0x80u : 0u;
}

// h = SHA-512(R || A || M) mod L for lane b, as eight little-endian
// words. The message plane holds MP = 128 * max_blocks - 64 rows; mlen is
// clamped to [0, MP] and the live block count to max_blocks, so no read
// leaves the plane.
__device__ __forceinline__ void challenge_words(uint32_t hw[8],
                                                const uint32_t rw[8],
                                                const uint32_t aw[8],
                                                const uint8_t *__restrict__ msg,
                                                int MP, int mlen, int B, int b) {
  const int tlen = 64 + min(max(mlen, 0), MP);
  const int n_live = min((tlen + 17 + 127) >> 7, (64 + MP) >> 7);
  const int end = n_live * 128;
  const uint64_t bit_len = (uint64_t)tlen * 8;
  uint64_t st[8];
  sha512_init(st);
#pragma unroll 1
  for (int blk = 0; blk < n_live; ++blk) {
    uint64_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint64_t v = 0;
      if (blk == 0 && j < 8) {
        // the 64-byte prefix R || A, big-endian words of the LE bytes
        const uint32_t *src = j < 4 ? rw : aw;
        const int q = 2 * (j & 3);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v = (v << 8) | ((src[q + (k >> 2)] >> (8 * (k & 3))) & 0xFFu);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v = (v << 8) | stream_byte(blk * 128 + j * 8 + k, tlen, end, bit_len,
                                     msg, B, b);
      }
      w[j] = v;
    }
    sha512_compress(st, w);
  }
  sc_reduce_digest(hw, st);
}

__global__ void __launch_bounds__(MAX_THREADS)
ed25519_verify_full_compact_kernel(const uint8_t *__restrict__ wire,
                                   const uint8_t *__restrict__ msg, int MP,
                                   const int32_t *__restrict__ mlen, const uint32_t *__restrict__ btab,
                                   uint8_t *__restrict__ out, int B, int G) {
  const lane_role r = lane_role_of(G, B);
  uint32_t aw[8] = {0}, rw[8] = {0}, sw[8] = {0}, hw[8] = {0};
  if (r.live) {
    load_words(aw, wire, 0, B, r.b);
    load_words(rw, wire, 32, B, r.b);
    load_words(sw, wire, 64, B, r.b);
    if (r.r_warp || G == 1) challenge_words(hw, rw, aw, msg, MP, mlen[r.b], B, r.b);
  }
  const bool ok = verify_lane(aw, rw, sw, hw, btab, G > 1, r, G);
  if (!r.r_warp && r.t == 0 && r.live) out[r.b] = ok ? 1 : 0;
}

// Eight words of lane b from a row-major u32 word wire, starting at row row0.
__device__ __forceinline__ void load_word_rows(uint32_t w[8],
                                               const uint32_t *__restrict__ wire,
                                               int row0, int B, int b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = wire[(size_t)(row0 + j) * B + b];
}

__global__ void __launch_bounds__(MAX_THREADS)
ed25519_verify_words_kernel(const uint32_t *__restrict__ wire, const uint32_t *__restrict__ btab,
                            uint8_t *__restrict__ out, int B, int G) {
  const lane_role r = lane_role_of(G, B);
  uint32_t aw[8] = {0}, rw[8] = {0}, sw[8] = {0}, hw[8] = {0};
  if (r.live) {
    load_word_rows(aw, wire, 0, B, r.b);
    load_word_rows(rw, wire, 8, B, r.b);
    load_word_rows(sw, wire, 16, B, r.b);
    load_word_rows(hw, wire, 24, B, r.b);
  }
  const bool ok = verify_lane(aw, rw, sw, hw, btab, false, r, G);
  if (!r.r_warp && r.t == 0 && r.live) out[r.b] = ok ? 1 : 0;
}

// h = SHA-512 of lane b's live pre-padded blocks, mod L.
__device__ __forceinline__ void block_challenge(uint32_t hw[8], const uint32_t *__restrict__ msg_hi,
                                                const uint32_t *__restrict__ msg_lo, int NB,
                                                int nblocks, int B, int b) {
  const int n_live = min(max(nblocks, 0), NB);
  uint64_t st[8];
  sha512_init(st);
#pragma unroll 1
  for (int blk = 0; blk < n_live; ++blk) {
    uint64_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const size_t at = ((size_t)blk * 16 + j) * B + b;
      w[j] = ((uint64_t)msg_hi[at] << 32) | msg_lo[at];
    }
    sha512_compress(st, w);
  }
  sc_reduce_digest(hw, st);
}

__global__ void __launch_bounds__(MAX_THREADS)
ed25519_verify_full_words_kernel(const uint32_t *__restrict__ wire,
                                 const uint32_t *__restrict__ msg_hi,
                                 const uint32_t *__restrict__ msg_lo, int NB,
                                 const int32_t *__restrict__ nblocks, const uint32_t *__restrict__ btab,
                                 uint8_t *__restrict__ out, int B, int G) {
  const lane_role r = lane_role_of(G, B);
  uint32_t aw[8] = {0}, rw[8] = {0}, sw[8] = {0}, hw[8] = {0};
  if (r.live) {
    load_word_rows(aw, wire, 0, B, r.b);
    load_word_rows(rw, wire, 8, B, r.b);
    load_word_rows(sw, wire, 16, B, r.b);
    if (r.r_warp || G == 1) block_challenge(hw, msg_hi, msg_lo, NB, nblocks[r.b], B, r.b);
  }
  const bool ok = verify_lane(aw, rw, sw, hw, btab, G > 1, r, G);
  if (!r.r_warp && r.t == 0 && r.live) out[r.b] = ok ? 1 : 0;
}

// kernel at G threads a lane, the tables' shared memory allowed; at G = 1
// (no shared table, 2,560 bytes of table a thread in local memory) the
// cache is split in favour of L1.
#define LAUNCH(kernel, G, B, stream, ...)                                                          \
  do {                                                                                             \
    if ((G) != 1 && (G) != 2 && (G) != 4) return (int)cudaErrorInvalidValue;                      \
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TABLE_SMEM); \
    if (e == cudaSuccess)                                                                          \
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,            \
                               (G) == 1 ? cudaSharedmemCarveoutMaxL1 : cudaSharedmemCarveoutMaxShared); \
    if (e != cudaSuccess) return (int)e;                                                           \
    kernel<<<lane_blocks(B, G), block_threads(B, G), block_smem(B, G), (cudaStream_t)(stream)>>>(  \
        __VA_ARGS__);                                                                              \
    return (int)cudaGetLastError();                                                                \
  } while (0)

// The C entry points take B's comb tables (ed25519_batch.base_tables) as
// base; at G = 1 they are not read.
extern "C" int cbt_ed25519_verify_compact(const void *wire, const void *base, void *out, int B, int G,
                                          void *stream) {
  LAUNCH(ed25519_verify_compact_kernel, G, B, stream, (const uint8_t *)wire, (const uint32_t *)base,
         (uint8_t *)out, B, G);
}

extern "C" int cbt_ed25519_verify_full_compact(const void *wire, const void *msg, int MP, const void *mlen,
                                               const void *base, void *out, int B, int G, void *stream) {
  LAUNCH(ed25519_verify_full_compact_kernel, G, B, stream, (const uint8_t *)wire, (const uint8_t *)msg, MP,
         (const int32_t *)mlen, (const uint32_t *)base, (uint8_t *)out, B, G);
}

extern "C" int cbt_ed25519_verify_words(const void *wire, const void *base, void *out, int B, int G,
                                        void *stream) {
  LAUNCH(ed25519_verify_words_kernel, G, B, stream, (const uint32_t *)wire, (const uint32_t *)base,
         (uint8_t *)out, B, G);
}

extern "C" int cbt_ed25519_verify_full_words(const void *wire, const void *msg_hi, const void *msg_lo, int NB,
                                             const void *nblocks, const void *base, void *out, int B, int G,
                                             void *stream) {
  LAUNCH(ed25519_verify_full_words_kernel, G, B, stream, (const uint32_t *)wire, (const uint32_t *)msg_hi,
         (const uint32_t *)msg_lo, NB, (const int32_t *)nblocks, (const uint32_t *)base, (uint8_t *)out, B, G);
}
