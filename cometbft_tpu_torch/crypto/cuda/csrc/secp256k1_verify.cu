// secp256k1 ECDSA verification, one thread per signature.
//
// secp256k1_verify replaces cometbft_tpu/crypto/tpu/secp256k1_batch.py::
// _verify_core (verify_kernel :198, _verify_math :201). Input: the wire
// u8[128, B], byte-major (byte k of lane b at k * B + b): rows 0:32 qx,
// 32:64 r, 64:96 u1 = e/s, 96:128 u2 = r/s mod n, all little-endian (the
// reference's u32[32, B] words, byte for byte); int32[B] flags, bit 0 the
// key prefix's parity, bit 1 r + n < p. Output: u8[B], 1 where Q
// decompresses and R' = u1 G + u2 Q is finite with x(R') = r or r + n.
// The host ANDs it with its validity mask (lengths, prefix, x < p, r and s
// in [1, n), low S), exactly as the reference does.
//
// Per lane: Q = (x, sqrt(x^3 + 7)) with the prefix's parity, checked by
// squaring (a failure rejects); the 16-entry joint table ds G + dh Q (ds,
// dh in 0..3; 0..3 G are constants, the rest built per lane); 128 steps of
// two doublings and one addition over the 2-bit digits of u1 and u2, most
// significant first. Points are homogeneous (X:Y:Z); Renes-Costello-Batina
// 2015 complete formulas for a = 0 (b3 = 21), Algorithm 7 to add and 9 to
// double, so the identity (0:1:0), inverses and doubling need no branch.
// The last check needs no inversion: Z != 0 and X = r Z, or bit 1 set and
// X = (r + n) Z (mod p). With Z != 0 that is X/Z = r (or r + n), the
// reference's test after its fe.invert (:240-243), so the verdicts are the
// same.
//
// What bounds it on this card: integer operations. A signature costs 3,214
// field products and 769 squarings (the loop's 256 doublings of 6 + 2
// and 128 additions of 12, the table, and the square root's 253
// squarings), each 100 or 55 32x32->64 multiply-adds plus the carries:
// about 2.0 M 32-bit integer instructions a lane (chip_smoke.py counts
// them), against 133 bytes moved. The field elements live in registers as
// ten uint32 limbs with uint64 column sums. The TPU's one-hot table select
// (_select_point, :134) becomes an indexed read: verification handles
// public data only and needs no constant-time select. The 16 table points
// (1,920 bytes a thread) are indexed by a run-time digit and so live in
// local memory; a table in shared memory, or a warp cooperating on one
// signature, is the first thing a faster version should try.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe256k1.cuh"

// G, 2G, 3G (affine x, y) and n, in canonical limbs;
// tests/test_torch_secp256k1.py recomputes each from its definition.
__constant__ uint32_t K_G[3][2][10] = {
    {{0x2f81798, 0x0a056c5, 0x28d959f, 0x36cb738, 0x3029bfc,
      0x3a1c2c1, 0x206295c, 0x2eeb156, 0x27ef9dc, 0x01e6f99},
     {0x310d4b8, 0x1f423fe, 0x14199c4, 0x1229a15, 0x0fd17b4,
      0x384422a, 0x24fbfc0, 0x3119576, 0x27726a3, 0x0120eb6}},
    {{0x0709ee5, 0x3026e57, 0x3ca7aba, 0x12e33bc, 0x05c778e,
      0x1701f36, 0x05406e9, 0x1f5b4c1, 0x39441ed, 0x031811f},
     {0x0cfe52a, 0x10c6a54, 0x10e1236, 0x194c99b, 0x2f7f632,
      0x19b3abb, 0x0584194, 0x30ce68f, 0x0fea63d, 0x006b85a}},
    {{0x0e036f9, 0x07c44ef, 0x19b0860, 0x1160dbe, 0x1b531c8,
      0x227548a, 0x344f85f, 0x30c4124, 0x2019258, 0x03e4c22},
     {0x0b8e672, 0x27f5d61, 0x231b6cb, 0x264d308, 0x26500a9,
      0x28dfcd5, 0x2337e62, 0x3a0503f, 0x30f632d, 0x00e23de}}};
__constant__ uint32_t K_N[10] = {
    0x0364141, 0x097a334, 0x203bbfd, 0x39abd22, 0x2baaedc,
    0x3ffffff, 0x3ffffff, 0x3ffffff, 0x3ffffff, 0x03fffff};

#define NUM_DIGITS 128
#define B3 21u

struct pt {
  fe X, Y, Z;
};

__device__ __forceinline__ void fe_small(fe &out, uint32_t v) {
  out.v[0] = v;
#pragma unroll
  for (int i = 1; i < 10; ++i) out.v[i] = 0;
}

__device__ __forceinline__ void fe_load(fe &out, const uint32_t *c) {
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = c[i];
}

// Algorithm 7 (a = 0); o may alias p or q.
__device__ __noinline__ void pt_add(pt &o, const pt &p, const pt &q) {
  fe t0, t1, t2, t3, t4, x3, y3, z3, u, v;
  fe_mul(t0, p.X, q.X);
  fe_mul(t1, p.Y, q.Y);
  fe_mul(t2, p.Z, q.Z);
  fe_add(u, p.X, p.Y);
  fe_add(v, q.X, q.Y);
  fe_mul(t3, u, v);
  fe_add(u, t0, t1);
  fe_sub(t3, t3, u);
  fe_add(u, p.Y, p.Z);
  fe_add(v, q.Y, q.Z);
  fe_mul(t4, u, v);
  fe_add(u, t1, t2);
  fe_sub(t4, t4, u);
  fe_add(u, p.X, p.Z);
  fe_add(v, q.X, q.Z);
  fe_mul(y3, u, v);
  fe_add(u, t0, t2);
  fe_sub(y3, y3, u);
  fe_add(x3, t0, t0);
  fe_add(x3, x3, t0);
  fe_mul_small(t2, t2, B3);
  fe_add(z3, t1, t2);
  fe_sub(t1, t1, t2);
  fe_mul_small(y3, y3, B3);
  fe_mul(u, t3, t1);
  fe_mul(v, t4, y3);
  fe_sub(o.X, u, v);
  fe_mul(u, y3, x3);
  fe_mul(v, t1, z3);
  fe_add(o.Y, u, v);
  fe_mul(u, z3, t4);
  fe_mul(v, x3, t3);
  fe_add(o.Z, u, v);
}

// Algorithm 9 (a = 0); o may alias p.
__device__ __noinline__ void pt_dbl(pt &o, const pt &p) {
  fe t0, t1, t2, x3, y3, z3, u;
  fe_sq(t0, p.Y);
  fe_add(z3, t0, t0);
  fe_add(z3, z3, z3);
  fe_add(z3, z3, z3);
  fe_mul(t1, p.Y, p.Z);
  fe_sq(u, p.Z);
  fe_mul_small(t2, u, B3);
  fe_mul(x3, t2, z3);
  fe_add(y3, t0, t2);
  fe_mul(z3, t1, z3);
  fe_add(u, t2, t2);
  fe_add(t2, u, t2);
  fe_sub(t0, t0, t2);
  fe_mul(u, t0, y3);
  fe_add(y3, x3, u);
  fe_mul(u, p.X, p.Y);
  fe_mul(x3, t0, u);
  fe_add(o.X, x3, x3);
  o.Y = y3;
  o.Z = z3;
}

// Limb i of a little-endian 256-bit value: bits 26i..26i+25 (limb 9 bits
// 234..255).
__device__ __forceinline__ void fe_from_words(fe &out, const uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int off = 26 * i, j = off >> 5, k = off & 31;
    uint32_t v = w[j] >> k;
    if (k + 26 > 32 && j + 1 < 8) v |= w[j + 1] << (32 - k);
    out.v[i] = v & FE_MASK;
  }
}

__device__ __forceinline__ void load_words(uint32_t w[8], const uint8_t *wire,
                                           int row0, int B, int b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint8_t *p = wire + (size_t)(row0 + 4 * j) * B + b;
    w[j] = (uint32_t)p[0] | ((uint32_t)p[(size_t)B] << 8) |
           ((uint32_t)p[2 * (size_t)B] << 16) | ((uint32_t)p[3 * (size_t)B] << 24);
  }
}

__device__ __noinline__ bool verify_lane(const uint32_t qw[8], const uint32_t rw[8],
                                         const uint32_t u1w[8], const uint32_t u2w[8],
                                         int32_t flags) {
  // Q from x and the prefix's parity
  fe x, y, rhs, t;
  fe_from_words(x, qw);
  fe_sq(t, x);
  fe_mul(t, t, x);
  fe_small(rhs, 7);
  fe_add(rhs, t, rhs);
  fe_sqrt_candidate(y, rhs);
  fe_sq(t, y);
  const bool on_curve = fe_eq(t, rhs);
  fe_canonical(t, y);
  if ((int32_t)(t.v[0] & 1u) != (flags & 1)) fe_neg(y, y);

  // entry[ds + 4 dh] = ds G + dh Q
  pt tab[16];
  fe_small(tab[0].X, 0);
  fe_small(tab[0].Y, 1);
  fe_small(tab[0].Z, 0);
#pragma unroll
  for (int ds = 1; ds < 4; ++ds) {
    fe_load(tab[ds].X, K_G[ds - 1][0]);
    fe_load(tab[ds].Y, K_G[ds - 1][1]);
    fe_small(tab[ds].Z, 1);
  }
  tab[4].X = x;
  tab[4].Y = y;
  fe_small(tab[4].Z, 1);
  pt_dbl(tab[8], tab[4]);
  pt_add(tab[12], tab[8], tab[4]);
#pragma unroll 1
  for (int dh = 1; dh < 4; ++dh) {
#pragma unroll 1
    for (int ds = 1; ds < 4; ++ds) pt_add(tab[4 * dh + ds], tab[ds], tab[4 * dh]);
  }

  pt acc = tab[0];
#pragma unroll 1
  for (int d = 0; d < NUM_DIGITS; ++d) {
    pt_dbl(acc, acc);
    pt_dbl(acc, acc);
    const int bit = 2 * (NUM_DIGITS - 1 - d);
    const uint32_t ds = (u1w[bit >> 5] >> (bit & 31)) & 3u;
    const uint32_t dh = (u2w[bit >> 5] >> (bit & 31)) & 3u;
    pt_add(acc, acc, tab[ds + 4 * dh]);
  }

  // x(R') = X/Z against r and, when r + n < p, r + n
  fe r, rz, n;
  fe_from_words(r, rw);
  fe_mul(rz, r, acc.Z);
  bool match = fe_eq(acc.X, rz);
  fe_load(n, K_N);
  fe_add(r, r, n);
  fe_mul(rz, r, acc.Z);
  match |= (flags & 2) != 0 && fe_eq(acc.X, rz);
  return on_curve && !fe_is_zero(acc.Z) && match;
}

__global__ void __launch_bounds__(128)
secp256k1_verify_kernel(const uint8_t *__restrict__ wire,
                        const int32_t *__restrict__ flags,
                        uint8_t *__restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t qw[8], rw[8], u1w[8], u2w[8];
  load_words(qw, wire, 0, B, b);
  load_words(rw, wire, 32, B, b);
  load_words(u1w, wire, 64, B, b);
  load_words(u2w, wire, 96, B, b);
  out[b] = verify_lane(qw, rw, u1w, u2w, flags[b]) ? 1 : 0;
}

extern "C" int cbt_secp256k1_verify(const void *wire, const void *flags, void *out,
                                    int B, void *stream) {
  secp256k1_verify_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)wire, (const int32_t *)flags, (uint8_t *)out, B);
  return (int)cudaGetLastError();
}
