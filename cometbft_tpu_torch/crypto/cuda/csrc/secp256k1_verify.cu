// secp256k1 ECDSA verification, a group of G threads a signature, with
// the GLV split on the card.
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
// What bounded the first design (one thread a signature): latency.
// At a commit (B = 180) two blocks ran on 2 of 132 SMs and each lane ran
// about 2.0 M dependent 32-bit integer instructions: the square root of
// x^3 + 7, a 16-entry joint table in local memory, and 128 steps of two
// doublings and one addition through __noinline__ point functions that
// moved their structs through the stack. What the design does about it:
//
// * u2 is reduced mod n and split by the GLV endomorphism
//   lambda (x, y) = (beta x, y): u2 = k1 + k2 lambda (mod n) with |k1|,
//   |k2| < 2^128, from the lattice constants libsecp256k1 uses
//   (scalar_split_lambda: c_i = round(u2 g_i / 2^384), k1 = u2 - c1 a1 -
//   c2 a2, k2 = -c1 b1 - c2 b2, exact 256-bit integer arithmetic). A
//   negative k negates the point's y. u1 is cut into two 128-bit halves.
// * R' is the sum of four terms, each a 128-bit scalar times a point:
//   |k1| (+-Q), |k2| (+-lambda Q), u1_lo G and u1_hi 2^128 G, each over 33
//   signed radix-16 windows (digits in [-7, 8]: tables of 0..8 times the
//   point, a negative digit negating y). Q's table is built per lane (4
//   doublings, 3 additions); lambda Q's entries are Q's with X times beta;
//   the tables of G and 2^128 G are constants in device memory
//   (K_GTAB, read through the L1 cache; no per-lane table of G).
// * A group of G threads in one warp verifies a lane, thread t taking
//   terms t, t + G, ...: at G = 4 each thread runs 32 windows of four
//   doublings and one addition, about 0.87 M instructions with the
//   square root, against 2.0 M; G = 1 where the batch fills the card alone
//   (the four terms then share one doubling chain). The partial sums meet
//   in log2 G additions over __shfl_xor_sync. Every point function is
//   inlined, so points stay in registers.
// * Points are homogeneous (X:Y:Z) with the complete Renes-Costello-Batina
//   2015 formulas for a = 0 (b3 = 21), Algorithm 7 to add and 9 to double:
//   partial sums that are equal, opposite or the identity (reachable from
//   a signer's r and s) need no branch. The last check needs no
//   inversion: Z != 0 and X = r Z, or bit 1 set and X = (r + n) Z (mod
//   p), the reference's test after its fe.invert (:240-243).
//
// What bounds it now: at a commit, the latency of one Q thread's chain
// (the square root, Q's table and 128 doublings); at a window, integer
// operations (chip_smoke.py counts them). Splitting adds work: at G = 4
// each term runs its own 128 doublings, four chains where G = 1 runs one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe256k1.cuh"

#define TERMS 4
#define WINDOWS 33
#define TABLE_SIZE 9
#define MAX_GROUP 4
#define BLOCK_THREADS 128
#define B3 21u

// d G and d 2^128 G for d = 0..8 as (X, Y, Z) in canonical limbs, the
// identity (0:1:0) first; tests/test_torch_secp256k1.py recomputes them.
__device__ const uint32_t K_GTAB[2 * TABLE_SIZE * 3 * 10] = {
    // 0 G
    0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 1 G
    0x2f81798, 0x0a056c5, 0x28d959f, 0x36cb738, 0x3029bfc, 0x3a1c2c1, 0x206295c, 0x2eeb156, 0x27ef9dc, 0x01e6f99,
    0x310d4b8, 0x1f423fe, 0x14199c4, 0x1229a15, 0x0fd17b4, 0x384422a, 0x24fbfc0, 0x3119576, 0x27726a3, 0x0120eb6,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 2 G
    0x0709ee5, 0x3026e57, 0x3ca7aba, 0x12e33bc, 0x05c778e, 0x1701f36, 0x05406e9, 0x1f5b4c1, 0x39441ed, 0x031811f,
    0x0cfe52a, 0x10c6a54, 0x10e1236, 0x194c99b, 0x2f7f632, 0x19b3abb, 0x0584194, 0x30ce68f, 0x0fea63d, 0x006b85a,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 3 G
    0x0e036f9, 0x07c44ef, 0x19b0860, 0x1160dbe, 0x1b531c8, 0x227548a, 0x344f85f, 0x30c4124, 0x2019258, 0x03e4c22,
    0x0b8e672, 0x27f5d61, 0x231b6cb, 0x264d308, 0x26500a9, 0x28dfcd5, 0x2337e62, 0x3a0503f, 0x30f632d, 0x00e23de,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 4 G
    0x0c4cd13, 0x2a52afa, 0x358474f, 0x2403b81, 0x0cc6c13, 0x0c2c501, 0x1e49049, 0x203cd60, 0x3f1c10d, 0x03924f6,
    0x3739922, 0x25ef711, 0x3e40cfe, 0x0cefef7, 0x0d967ae, 0x3a94512, 0x02e2098, 0x156dd59, 0x13ea0d4, 0x0147b66,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 5 G
    0x240efe4, 0x2355a6c, 0x1ab7cba, 0x2f77186, 0x0e88b84, 0x297144a, 0x34a7250, 0x0824d56, 0x24d1a07, 0x00be2f7,
    0x2ac62d6, 0x21f4ea9, 0x2840dca, 0x06eac35, 0x2f78827, 0x1b27109, 0x1ba9dda, 0x38f5b53, 0x22636e5, 0x0362b08,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 6 G
    0x0297556, 0x15e8518, 0x218b2f0, 0x0be15a2, 0x382f647, 0x1548d74, 0x053a143, 0x3ba9081, 0x3d5755e, 0x03ffe5e,
    0x075f297, 0x1c30dac, 0x24a03c8, 0x3d9463f, 0x0de80f0, 0x3d17158, 0x3e96017, 0x2d883ce, 0x37aacfb, 0x02b849d,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 7 G
    0x2c4f9bc, 0x2f77b72, 0x239ce92, 0x1f80cc3, 0x23d419b, 0x0ba9e83, 0x18f365f, 0x2d3aa8e, 0x0646e5d, 0x0172f7c,
    0x07264da, 0x2098a02, 0x27b5a50, 0x2e04ff7, 0x3a813d0, 0x1869536, 0x178d6d8, 0x165828c, 0x240ba25, 0x01abaf2,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 8 G
    0x10a2a01, 0x213bcf8, 0x088a677, 0x01796be, 0x30a1bdd, 0x1c3cf0b, 0x33843fb, 0x0d476bf, 0x1e15cca, 0x00bc079,
    0x0bde904, 0x28b2ddb, 0x3617b5d, 0x35ae96d, 0x0c2e213, 0x0cb44ed, 0x3d082a1, 0x26524a4, 0x0a74153, 0x017136a,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 0 2^128 G
    0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 1 2^128 G
    0x2c4c0da, 0x2d11327, 0x23351b7, 0x1e1c8fa, 0x2e88c56, 0x207c58b, 0x39c1ad9, 0x17cce48, 0x1d2f63b, 0x023da2e,
    0x01fff82, 0x32fde54, 0x0bfdf23, 0x3fa5544, 0x1bbea2c, 0x1af8857, 0x1d90c2b, 0x0e61b78, 0x32dba06, 0x0198aa7,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 2 2^128 G
    0x0f27076, 0x11f7e13, 0x3eaee68, 0x2b79d89, 0x1d89858, 0x3f66bd6, 0x2febe77, 0x20563f2, 0x2fd784e, 0x013526b,
    0x3aa781e, 0x02d9880, 0x18466b9, 0x069f7d3, 0x06e0f2d, 0x16729bc, 0x23f2103, 0x344d79c, 0x059a10d, 0x0334cbf,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 3 2^128 G
    0x23809fa, 0x0ae3b74, 0x14be18e, 0x2cd4765, 0x0fd845c, 0x09147c2, 0x293363f, 0x27c8a2e, 0x1be2e50, 0x00e0e07,
    0x31fed52, 0x01d460c, 0x324dbd7, 0x32ccb63, 0x03681fc, 0x083ac73, 0x1405a55, 0x05f72c2, 0x10a0fb9, 0x03928cb,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 4 2^128 G
    0x1b62026, 0x2f2d5ca, 0x1d4ee8d, 0x3822274, 0x38d2a3d, 0x3d716a9, 0x16619e1, 0x1be14df, 0x39e85d5, 0x01d5914,
    0x2ce0cf3, 0x0b23eb6, 0x1f33417, 0x36552de, 0x1684aac, 0x29c8a49, 0x31df524, 0x2cf1948, 0x1413749, 0x03075a1,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 5 2^128 G
    0x3c2a310, 0x1099225, 0x26303ea, 0x2950048, 0x1f186ae, 0x291a668, 0x121b82a, 0x0ab9bda, 0x324e437, 0x0124989,
    0x227ded0, 0x06da057, 0x38ce0c4, 0x04a9d7f, 0x36d1636, 0x1c50c0e, 0x2cfa569, 0x2afe568, 0x373bca7, 0x004cdf9,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 6 2^128 G
    0x3663da4, 0x19b0640, 0x0b81f81, 0x2467d74, 0x3a5a362, 0x3112a8a, 0x08a6ed7, 0x1c179a0, 0x2356aa5, 0x01a9992,
    0x3fc22c4, 0x0c4fecc, 0x04c9c28, 0x049f9b0, 0x1089916, 0x1afc335, 0x386ec19, 0x3a62ca7, 0x25954fd, 0x0112684,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 7 2^128 G
    0x2bd2d31, 0x12c1e73, 0x1b8d138, 0x15bfc1b, 0x04dcc1a, 0x11df8be, 0x2253b3e, 0x0324357, 0x28c1a24, 0x038c195,
    0x2546e44, 0x2d020e4, 0x3826692, 0x10af8dc, 0x2ffbc80, 0x3df436d, 0x0f2b107, 0x1098222, 0x3e37893, 0x003ab1b,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000,
    // 8 2^128 G
    0x3b4a278, 0x136b355, 0x082b536, 0x17c7fd0, 0x078f61a, 0x2b67332, 0x06ff301, 0x09de59d, 0x17ad9df, 0x00842a4,
    0x07b2231, 0x1c4ff43, 0x0bfc7f2, 0x06abfc8, 0x13789e6, 0x2359cdf, 0x39be81f, 0x395ede8, 0x35450b5, 0x019c386,
    0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000};

// n and beta in canonical limbs; n and the GLV lattice constants as
// little-endian u32 words (g1, g2: 256 bits; a1, -b1, b2: 128; a2: 129).
// tests/test_torch_secp256k1.py recomputes each from its definition.
__constant__ uint32_t K_N[10] = {
    0x0364141, 0x097a334, 0x203bbfd, 0x39abd22, 0x2baaedc,
    0x3ffffff, 0x3ffffff, 0x3ffffff, 0x3ffffff, 0x03fffff};
__constant__ uint32_t K_BETA[10] = {
    0x19501ee, 0x25b0a1c, 0x0995c13, 0x1d44bd6, 0x19cf049,
    0x30d0d3a, 0x24479ea, 0x01c41b9, 0x22b657c, 0x01eba5a};
__constant__ uint32_t K_N_WORDS[8] = {
    0xd0364141, 0xbfd25e8c, 0xaf48a03b, 0xbaaedce6,
    0xfffffffe, 0xffffffff, 0xffffffff, 0xffffffff};
__constant__ uint32_t K_GLV_G1[8] = {
    0x45dbb031, 0xe893209a, 0x71e8ca7f, 0x3daa8a14,
    0x9284eb15, 0xe86c90e4, 0xa7d46bcd, 0x3086d221};
__constant__ uint32_t K_GLV_G2[8] = {
    0x8ac47f71, 0x1571b4ae, 0x9df506c6, 0x221208ac,
    0x0abfe4c4, 0x6f547fa9, 0x010e8828, 0xe4437ed6};
__constant__ uint32_t K_GLV_A1[4] = {0x9284eb15, 0xe86c90e4, 0xa7d46bcd, 0x3086d221};
__constant__ uint32_t K_GLV_A2[5] = {0x9d44cfd8, 0x57c1108d, 0xa8e2f3f6, 0x14ca50f7, 0x00000001};
__constant__ uint32_t K_GLV_MB1[4] = {0x0abfe4c3, 0x6f547fa9, 0x010e8828, 0xe4437ed6};
__constant__ uint32_t K_GLV_B2[4] = {0x9284eb15, 0xe86c90e4, 0xa7d46bcd, 0x3086d221};

struct pt {
  fe X, Y, Z;
};

FE_FN void fe_small(fe &out, uint32_t v) {
  out.v[0] = v;
#pragma unroll
  for (int i = 1; i < 10; ++i) out.v[i] = 0;
}

FE_FN void fe_load(fe &out, const uint32_t *c) {
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = c[i];
}

FE_FN void pt_identity(pt &p) {
  fe_small(p.X, 0);
  fe_small(p.Y, 1);
  fe_small(p.Z, 0);
}

// Algorithm 7 (a = 0); o may alias p or q.
FE_FN void pt_add(pt &o, const pt &p, const pt &q) {
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
FE_FN void pt_dbl(pt &o, const pt &p) {
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
FE_FN void fe_from_words(fe &out, const uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int off = 26 * i, j = off >> 5, k = off & 31;
    uint32_t v = w[j] >> k;
    if (k + 26 > 32 && j + 1 < 8) v |= w[j + 1] << (32 - k);
    out.v[i] = v & FE_MASK;
  }
}

FE_FN void load_words(uint32_t w[8], const uint8_t *wire, int row0, int B, int b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint8_t *p = wire + (size_t)(row0 + 4 * j) * B + b;
    w[j] = (uint32_t)p[0] | ((uint32_t)p[(size_t)B] << 8) |
           ((uint32_t)p[2 * (size_t)B] << 16) | ((uint32_t)p[3 * (size_t)B] << 24);
  }
}

// --- integers as little-endian u32 words ---------------------------------------

// r = a b (NA + NB words).
template <int NA, int NB>
FE_FN void mul_words(uint32_t *r, const uint32_t *a, const uint32_t *b) {
#pragma unroll
  for (int i = 0; i < NA + NB; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint64_t t = (uint64_t)a[i] * b[j] + r[i + j] + carry;
      r[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    r[i + NB] = (uint32_t)carry;
  }
}

// r = a - b mod 2^256; returns the borrow out (a < b).
FE_FN uint32_t sub_words(uint32_t r[8], const uint32_t a[8], const uint32_t *b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// round(a / 2^384) for a 512-bit a whose quotient is below 2^128.
FE_FN void round_shift_384(uint32_t c[4], const uint32_t a[16]) {
  uint64_t t = (uint64_t)a[12] + (a[11] >> 31);
  c[0] = (uint32_t)t;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    t = (uint64_t)a[12 + i] + (t >> 32);
    c[i] = (uint32_t)t;
  }
}

// The magnitude (low four words) of a value read as a signed 256-bit
// integer whose absolute value is below 2^128; returns its sign.
FE_FN bool signed_magnitude(uint32_t m[4], const uint32_t v[8]) {
  const bool neg = (v[7] >> 31) != 0;
  uint32_t carry = neg ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t t = (uint64_t)(neg ? ~v[i] : v[i]) + carry;
    m[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return neg;
}

// k in [0, n) -> |k1|, |k2| and their signs, k1 + k2 lambda = k (mod n).
FE_FN void glv_split(uint32_t m1[4], bool &neg1, uint32_t m2[4], bool &neg2,
                     const uint32_t k[8]) {
  uint32_t prod[16], c1[4], c2[4], t[9], r1[8], r2[8];
  mul_words<8, 8>(prod, k, K_GLV_G1);
  round_shift_384(c1, prod);
  mul_words<8, 8>(prod, k, K_GLV_G2);
  round_shift_384(c2, prod);
  mul_words<4, 4>(t, c1, K_GLV_A1);
  sub_words(r1, k, t);
  mul_words<4, 5>(t, c2, K_GLV_A2);
  sub_words(r1, r1, t);
  mul_words<4, 4>(r2, c1, K_GLV_MB1);
  mul_words<4, 4>(t, c2, K_GLV_B2);
  sub_words(r2, r2, t);
  neg1 = signed_magnitude(m1, r1);
  neg2 = signed_magnitude(m2, r2);
}

// Signed radix-16 digits of a value below 2^128, least significant first:
// v = sum_i d_i 16^i with d_i in [-7, 8].
FE_FN void recode(int8_t *d, const uint32_t m[4]) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < WINDOWS - 1; ++i) {
    const int v = (int)((m[i >> 3] >> (4 * (i & 7))) & 15u) + carry;
    carry = v > 8;
    d[i] = (int8_t)(v - 16 * carry);
  }
  d[WINDOWS - 1] = (int8_t)carry;
}

FE_FN void shfl_fe(fe &o, const fe &a, int mask) {
#pragma unroll
  for (int i = 0; i < 10; ++i) o.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], mask);
}

// Block: BLOCK_THREADS / G lanes, thread g * G + t being thread t of lane
// g. The windows are one loop over (window, term) steps: a loop over a
// thread's terms nested in the window loop around the inlined point code
// crashes the CUDA compiler's front end (cicc).
__global__ void __launch_bounds__(BLOCK_THREADS)
secp256k1_verify_kernel(const uint8_t *__restrict__ wire,
                        const int32_t *__restrict__ flags,
                        uint8_t *__restrict__ out, int B, int G) {
  __shared__ int8_t s_dig[BLOCK_THREADS][TERMS][WINDOWS];
  __shared__ uint8_t s_neg[BLOCK_THREADS][2];

  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const int b = blockIdx.x * (BLOCK_THREADS / G) + g;
  const bool live = b < B;

  if (t == 0) {
    // the four terms' digits: |k1|, |k2| (u2 mod n, split), u1's halves
    uint32_t u1[8], u2[8], k[8], m1[4], m2[4];
    bool neg1 = false, neg2 = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) u1[j] = u2[j] = 0;
    if (live) {
      load_words(u1, wire, 64, B, b);
      load_words(u2, wire, 96, B, b);
    }
    if (!sub_words(k, u2, K_N_WORDS)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) u2[j] = k[j];
    }
    glv_split(m1, neg1, m2, neg2, u2);
    recode(s_dig[g][0], m1);
    recode(s_dig[g][1], m2);
    recode(s_dig[g][2], u1);
    recode(s_dig[g][3], u1 + 4);
    s_neg[g][0] = neg1;
    s_neg[g][1] = neg2;
  }
  __syncwarp();

  // threads 0 and 1 hold the Q terms (G = 1: thread 0 both)
  pt qtab[TABLE_SIZE];
  bool on_curve = false;
  int32_t fl = 0;
  if (t < 2) {
    uint32_t qw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) qw[j] = 0;
    if (live) {
      load_words(qw, wire, 0, B, b);
      fl = flags[b];
    }
    // Q from x and the prefix's parity, checked by squaring
    fe x, y, rhs, s;
    fe_from_words(x, qw);
    fe_sq(s, x);
    fe_mul(s, s, x);
    fe_small(rhs, 7);
    fe_add(rhs, s, rhs);
    fe_sqrt_candidate(y, rhs);
    fe_sq(s, y);
    on_curve = fe_eq(s, rhs);
    fe_canonical(s, y);
    if ((int32_t)(s.v[0] & 1u) != (fl & 1)) fe_neg(y, y);
    // 0..8 Q
    pt_identity(qtab[0]);
    qtab[1].X = x;
    qtab[1].Y = y;
    fe_small(qtab[1].Z, 1);
    pt_dbl(qtab[2], qtab[1]);
    pt_add(qtab[3], qtab[2], qtab[1]);
    pt_dbl(qtab[4], qtab[2]);
    pt_add(qtab[5], qtab[4], qtab[1]);
    pt_dbl(qtab[6], qtab[3]);
    pt_add(qtab[7], qtab[6], qtab[1]);
    pt_dbl(qtab[8], qtab[4]);
  }

  fe beta;
  fe_load(beta, K_BETA);
  pt acc;
  pt_identity(acc);
  const int nterms = TERMS / G;
#pragma unroll 1
  for (int step = 0; step < WINDOWS * nterms; ++step) {
    const int w = WINDOWS - 1 - step / nterms, j = step % nterms;
    if (j == 0 && w < WINDOWS - 1) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k) pt_dbl(acc, acc);
    }
    {
      const int term = t + j * G;
      const int d = s_dig[g][term][w];
      const int a = d < 0 ? -d : d;
      bool neg = d < 0;
      pt e;
      if (term < 2) {
        e = qtab[a];
        if (term == 1) fe_mul(e.X, e.X, beta);
        neg ^= s_neg[g][term] != 0;
      } else {
        const uint32_t *src = K_GTAB + ((term - 2) * TABLE_SIZE + a) * 30;
        fe_load(e.X, src);
        fe_load(e.Y, src + 10);
        fe_load(e.Z, src + 20);
      }
      fe ny;
      fe_neg(ny, e.Y);
      if (neg) e.Y = ny;
      pt_add(acc, acc, e);
    }
  }
#pragma unroll 1
  for (int m = 1; m < G; m <<= 1) {
    pt o;
    shfl_fe(o.X, acc.X, m);
    shfl_fe(o.Y, acc.Y, m);
    shfl_fe(o.Z, acc.Z, m);
    pt_add(acc, acc, o);
  }

  if (t == 0 && live) {
    // x(R') = X/Z against r and, when r + n < p, r + n
    uint32_t rw[8];
    load_words(rw, wire, 32, B, b);
    fe r, rz, n;
    fe_from_words(r, rw);
    fe_mul(rz, r, acc.Z);
    bool match = fe_eq(acc.X, rz);
    fe_load(n, K_N);
    fe_add(r, r, n);
    fe_mul(rz, r, acc.Z);
    match |= (fl & 2) != 0 && fe_eq(acc.X, rz);
    out[b] = on_curve && !fe_is_zero(acc.Z) && match ? 1 : 0;
  }
}

extern "C" int cbt_secp256k1_verify(const void *wire, const void *flags, void *out,
                                    int B, int G, void *stream) {
  if (G != 1 && G != 2 && G != 4) return (int)cudaErrorInvalidValue;
  const int lanes = BLOCK_THREADS / G;
  secp256k1_verify_kernel<<<(B + lanes - 1) / lanes, BLOCK_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t *)wire, (const int32_t *)flags, (uint8_t *)out, B, G);
  return (int)cudaGetLastError();
}
