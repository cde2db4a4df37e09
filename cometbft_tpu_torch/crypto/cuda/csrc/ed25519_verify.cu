// Cofactorless Ed25519 verification, one thread per signature: four
// kernels over one core.
//
// verify_core replaces cometbft_tpu/crypto/tpu/ed25519_batch.py::
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
//   tables of each key built once at upload, several threads a lane, and
//   without an inversion.
// * ed25519_verify_full_compact replaces verify_full_kernel_compact
//   (:370): wire u8[96, B] rows A, R, S, the message plane u8[MP, B]
//   (sha512.py::stage_ragged_np, prefix_len 64) and int32[B] lengths. Each
//   lane rebuilds R || A || M's SHA-512 blocks from the wire and the plane
//   in registers (the padding of sha512.py::blocks_from_bytes, :202),
//   compresses only its live blocks (sha512.cuh), reduces mod L exactly
//   (sc25519.cuh) and enters verify_core.
// * ed25519_verify_words replaces _verify_core (verify_kernel, :328-335),
//   the u32 word wire (CBFT_TPU_WIRE=words): u32[32, B] row-major (word j
//   of lane b at j * B + b), rows 0:8 A, 8:16 R, 16:24 S, 24:32 h, all
//   little-endian words.
// * ed25519_verify_full_words replaces verify_full_kernel (:351): u32[24,
//   B] words of A, R, S, and R || A || M padded into SHA-512 blocks on the
//   host, as big-endian hi and lo halves u32[NB, 16, B] of each 64-bit
//   word, with int32[B] live block counts (clamped to [0, NB], as the
//   reference's mask over its NB blocks does). It compresses the live
//   blocks, reduces mod L and enters verify_core.
//
// verify_core is compiled once, not inlined into each kernel: it holds
// nearly all of a lane's work, so one call per lane costs nothing that
// shows, and three inlined copies more than doubled the build time. The
// two word kernels are prologues only. These four kernels keep the first
// design; ed25519_resident.cu shows what a key table built once and a
// group of threads a lane do to the same work.
//
// Output: u8[B], 1 where encode([s]B + [h](-A)) equals R byte for byte
// and A decompressed. The host ANDs it with its validity mask (s < L,
// lengths, absent lanes), exactly as the reference does.
//
// What bounds it on this card: integer operations. A signature costs about
// 2,200 field products and 1,500 squarings (127 x (2 doublings + 1
// addition) in the loop, plus the table, the decompression and the
// inversion), each 100 or 55 32x32->64 multiply-adds plus the carries:
// about 0.96 M 32-bit integer instructions per lane (chip_smoke.py counts
// them), against 100 to 129 bytes moved. SHA-512 of two blocks and the
// reduction add under 2% to that. The design keeps the field elements in
// registers as ten uint32 limbs with uint64 column sums. The TPU's one-hot
// table select (_select_cached, :197) becomes an indexed read:
// verification handles public data only and needs no constant-time
// select. The 16 cached points (2,560 bytes per thread) are indexed by a
// run-time digit and so live in local memory; that spill is the first
// thing a faster version should remove (e.g. a table in shared memory, or
// a warp cooperating on one signature).
//
// Semantics (reference :33-42): A's y is taken mod p and not rejected; a
// failed decompression rejects; -0 decodes as 0; R is compared raw, so a
// non-canonical R never matches. s >= L is rejected on the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "sc25519.cuh"
#include "sha512.cuh"

// Constants in carried (here canonical) limbs; tests/test_torch_ed25519.py
// recomputes each from its definition and checks these literals.
__constant__ uint32_t K_D[10] = {
    0x35978a3, 0x0d37284, 0x3156ebd, 0x06a0a0e, 0x001c029,
    0x179e898, 0x3a03cbb, 0x1ce7198, 0x2e2b6ff, 0x1480db3};
__constant__ uint32_t K_D2[10] = {
    0x2b2f159, 0x1a6e509, 0x22add7a, 0x0d4141d, 0x0038052,
    0x0f3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x0901b67};
__constant__ uint32_t K_SQRT_M1[10] = {
    0x20ea0b0, 0x186c9d2, 0x08f189d, 0x035697f, 0x0bd0c60,
    0x1fbd7a7, 0x2804c9e, 0x1e16569, 0x004fc1d, 0x0ae0c92};
__constant__ uint32_t K_BX[10] = {
    0x325d51a, 0x18b5823, 0x0f6592a, 0x104a92d, 0x1a4b31d,
    0x1d6dc5c, 0x27118fe, 0x07fd814, 0x13cd6e5, 0x085a4db};
__constant__ uint32_t K_BY[10] = {
    0x2666658, 0x1999999, 0x0cccccc, 0x1333333, 0x1999999,
    0x0666666, 0x3333333, 0x0cccccc, 0x2666666, 0x1999999};

#define NUM_DIGITS 127

// y (low 255 bits of A), sign bit -> x with ref10 semantics; false when
// x^2 = (y^2 - 1) / (d y^2 + 1) has no root.
__device__ bool decompress(fe &x, const fe &y, uint32_t sign) {
  fe one, d, yy, u, v, v3, v7, t, vxx, nu, sqrt_m1;
  fe_one(one);
  fe_const(d, K_D);
  fe_sq(yy, y);
  fe_sub(u, yy, one);
  fe_mul(v, yy, d);
  fe_add(v, v, one);
  fe_sq(v3, v);
  fe_mul(v3, v3, v);
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(vxx, x);
  fe_mul(vxx, vxx, v);
  const bool ok_direct = fe_eq(vxx, u);
  fe_neg(nu, u);
  const bool ok_flip = fe_eq(vxx, nu);
  if (ok_flip) {
    fe_const(sqrt_m1, K_SQRT_M1);
    fe_mul(x, x, sqrt_m1);
  }
  fe xc;
  fe_canonical(xc, x);
  if ((xc.v[0] & 1u) != sign) fe_neg(x, x);
  return ok_direct || ok_flip;
}

// encode([s]B + [h](-A)) == R and A decompresses, from the little-endian
// u32 words of A, R, s and h.
__device__ __noinline__ bool verify_core(const uint32_t aw[8],
                                         const uint32_t rw[8],
                                         const uint32_t sw[8],
                                         const uint32_t hw[8]) {
  fe d2;
  fe_const(d2, K_D2);

  // -A = (-x, y, 1, -x y)
  ge neg_a;
  fe_from_words(neg_a.Y, aw);
  fe x;
  const bool ok = decompress(x, neg_a.Y, aw[7] >> 31);
  fe_neg(neg_a.X, x);
  fe_one(neg_a.Z);
  fe_mul(neg_a.T, neg_a.X, neg_a.Y);

  // s_pts: identity, B, 2B, 3B; h_pts: -, -A, -2A, -3A
  ge s_pts[4], h_pts[4];
  fe_zero(s_pts[0].X);
  fe_one(s_pts[0].Y);
  fe_one(s_pts[0].Z);
  fe_zero(s_pts[0].T);
  fe_const(s_pts[1].X, K_BX);
  fe_const(s_pts[1].Y, K_BY);
  fe_one(s_pts[1].Z);
  fe_mul(s_pts[1].T, s_pts[1].X, s_pts[1].Y);
  ge_dbl(s_pts[2], s_pts[1]);
  ge_add(s_pts[3], s_pts[2], s_pts[1], d2);
  h_pts[1] = neg_a;
  ge_dbl(h_pts[2], neg_a);
  ge_add(h_pts[3], h_pts[2], neg_a, d2);

  // table[ds + 4 dh] = ds B + dh (-A), cached
  ge_cached table[16];
#pragma unroll 1
  for (int dh = 0; dh < 4; ++dh) {
#pragma unroll 1
    for (int ds = 0; ds < 4; ++ds) {
      ge pt;
      if (dh == 0) {
        pt = s_pts[ds];
      } else if (ds == 0) {
        pt = h_pts[dh];
      } else {
        ge_add(pt, s_pts[ds], h_pts[dh], d2);
      }
      ge_to_cached(table[ds + 4 * dh], pt, d2);
    }
  }

  // 127 radix-4 steps, digits MSB first: bit pairs 252..0 of s and h
  ge acc = s_pts[0];
#pragma unroll 1
  for (int bit = 2 * (NUM_DIGITS - 1); bit >= 0; bit -= 2) {
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    const uint32_t ds = (sw[bit >> 5] >> (bit & 31)) & 3u;
    const uint32_t dh = (hw[bit >> 5] >> (bit & 31)) & 3u;
    ge_add_cached(acc, acc, table[ds + 4 * dh]);
  }

  fe zinv, ex, ey;
  fe_invert(zinv, acc.Z);
  fe_mul(ex, acc.X, zinv);
  fe_mul(ey, acc.Y, zinv);
  fe_canonical(ex, ex);
  fe_canonical(ey, ey);
  uint32_t enc[8];
  fe_to_words(enc, ey);
  enc[7] |= (ex.v[0] & 1u) << 31;
  bool same = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) same &= enc[j] == rw[j];
  return same && ok;
}

__global__ void __launch_bounds__(128)
ed25519_verify_compact_kernel(const uint8_t *__restrict__ wire,
                              uint8_t *__restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t aw[8], rw[8], sw[8], hw[8];
  load_words(aw, wire, 0, B, b);
  load_words(rw, wire, 32, B, b);
  load_words(sw, wire, 64, B, b);
  load_words(hw, wire, 96, B, b);
  out[b] = verify_core(aw, rw, sw, hw) ? 1 : 0;
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

__global__ void __launch_bounds__(128)
ed25519_verify_full_compact_kernel(const uint8_t *__restrict__ wire,
                                   const uint8_t *__restrict__ msg, int MP,
                                   const int32_t *__restrict__ mlen,
                                   uint8_t *__restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t aw[8], rw[8], sw[8], hw[8];
  load_words(aw, wire, 0, B, b);
  load_words(rw, wire, 32, B, b);
  load_words(sw, wire, 64, B, b);
  challenge_words(hw, rw, aw, msg, MP, mlen[b], B, b);
  out[b] = verify_core(aw, rw, sw, hw) ? 1 : 0;
}

// Eight words of lane b from a row-major u32 word wire, starting at row row0.
__device__ __forceinline__ void load_word_rows(uint32_t w[8],
                                               const uint32_t *__restrict__ wire,
                                               int row0, int B, int b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = wire[(size_t)(row0 + j) * B + b];
}

__global__ void __launch_bounds__(128)
ed25519_verify_words_kernel(const uint32_t *__restrict__ wire,
                            uint8_t *__restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t aw[8], rw[8], sw[8], hw[8];
  load_word_rows(aw, wire, 0, B, b);
  load_word_rows(rw, wire, 8, B, b);
  load_word_rows(sw, wire, 16, B, b);
  load_word_rows(hw, wire, 24, B, b);
  out[b] = verify_core(aw, rw, sw, hw) ? 1 : 0;
}

__global__ void __launch_bounds__(128)
ed25519_verify_full_words_kernel(const uint32_t *__restrict__ wire,
                                 const uint32_t *__restrict__ msg_hi,
                                 const uint32_t *__restrict__ msg_lo, int NB,
                                 const int32_t *__restrict__ nblocks,
                                 uint8_t *__restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t aw[8], rw[8], sw[8], hw[8];
  load_word_rows(aw, wire, 0, B, b);
  load_word_rows(rw, wire, 8, B, b);
  load_word_rows(sw, wire, 16, B, b);
  const int n_live = min(max(nblocks[b], 0), NB);
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
  out[b] = verify_core(aw, rw, sw, hw) ? 1 : 0;
}

extern "C" int cbt_ed25519_verify_compact(const void *wire, void *out, int B,
                                          void *stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  ed25519_verify_compact_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)wire, (uint8_t *)out, B);
  return (int)cudaGetLastError();
}

static inline int grid_for(int B) { return (B + 127) / 128; }

extern "C" int cbt_ed25519_verify_full_compact(const void *wire,
                                               const void *msg, int MP,
                                               const void *mlen, void *out,
                                               int B, void *stream) {
  ed25519_verify_full_compact_kernel<<<grid_for(B), 128, 0,
                                       (cudaStream_t)stream>>>(
      (const uint8_t *)wire, (const uint8_t *)msg, MP, (const int32_t *)mlen,
      (uint8_t *)out, B);
  return (int)cudaGetLastError();
}

extern "C" int cbt_ed25519_verify_words(const void *wire, void *out, int B,
                                        void *stream) {
  ed25519_verify_words_kernel<<<grid_for(B), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)wire, (uint8_t *)out, B);
  return (int)cudaGetLastError();
}

extern "C" int cbt_ed25519_verify_full_words(const void *wire,
                                             const void *msg_hi,
                                             const void *msg_lo, int NB,
                                             const void *nblocks, void *out,
                                             int B, void *stream) {
  ed25519_verify_full_words_kernel<<<grid_for(B), 128, 0,
                                     (cudaStream_t)stream>>>(
      (const uint32_t *)wire, (const uint32_t *)msg_hi,
      (const uint32_t *)msg_lo, NB, (const int32_t *)nblocks, (uint8_t *)out,
      B);
  return (int)cudaGetLastError();
}
