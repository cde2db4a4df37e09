// GF(2^255-19) and edwards25519 point arithmetic for one CUDA thread.
//
// Replaces the limb arithmetic of cometbft_tpu/crypto/tpu/field.py and the
// point layer of cometbft_tpu/crypto/tpu/ed25519_batch.py (:119-213). The
// TPU form is int32[17,B] radix-2^15 signed limbs because its vector lanes
// have no 32x32->64 multiply; Hopper has one (IMAD.WIDE.U32), so this file
// uses ref10's ten limbs of 26/25 bits held as uint32, with uint64 column
// sums. The same arithmetic, limb for limb, is the torch twin in
// crypto/cuda/field.py, which the CPU tests hold against Python ints.
//
// Invariant ("carried form"): every limb is below 2^26 (even index) or
// 2^25 (odd index), except limb 1, which may exceed 2^25 by at most 2^15.
// fe_sub adds 2p before subtracting, so nothing goes negative; a product
// column is at most ten terms below 2^57 each, so it stays below 2^61.

#pragma once
#include <stdint.h>

#define FE_FN __device__ __forceinline__

struct fe {
  uint32_t v[10];
};

// 2p, limb by limb: sub(a, b) = a + 2p - b stays non-negative in carried form
#define FE_2P_EVEN 0x7FFFFFEu  // 2 * (2^26 - 1), limbs 2, 4, 6, 8
#define FE_2P_ODD 0x3FFFFFEu   // 2 * (2^25 - 1)
#define FE_2P_0 0x7FFFFDAu     // 2 * (2^26 - 19)

FE_FN void fe_const(fe &out, const uint32_t *c) {
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = c[i];
}

FE_FN void fe_zero(fe &out) {
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = 0;
}

FE_FN void fe_one(fe &out) {
  out.v[0] = 1;
#pragma unroll
  for (int i = 1; i < 10; ++i) out.v[i] = 0;
}

// Eight little-endian u32 words of lane b from a byte-major wire u8[rows, B]
// (row r of lane b at r * B + b), starting at row row0.
FE_FN void load_words(uint32_t w[8], const uint8_t *wire, int row0, int B, int b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint8_t *p = wire + (size_t)(row0 + 4 * j) * B + b;
    w[j] = (uint32_t)p[0] | ((uint32_t)p[(size_t)B] << 8) |
           ((uint32_t)p[2 * (size_t)B] << 16) | ((uint32_t)p[3 * (size_t)B] << 24);
  }
}

// One sequential floor-carry pass; the carry out of limb 9 folds back as
// 19 (2^255 = 19 mod p), then limb 0 carries once more into limb 1.
FE_FN void fe_carry64(fe &out, uint64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = (i & 1) ? 25 : 26;
    h[i + 1] += h[i] >> w;
    h[i] &= (1ull << w) - 1;
  }
  const uint64_t c9 = h[9] >> 25;
  h[9] &= (1ull << 25) - 1;
  h[0] += 19 * c9;
  h[1] += h[0] >> 26;
  h[0] &= (1ull << 26) - 1;
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = (uint32_t)h[i];
}

FE_FN void fe_carry32(fe &out, uint32_t h[10]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = (i & 1) ? 25 : 26;
    h[i + 1] += h[i] >> w;
    h[i] &= (1u << w) - 1;
  }
  const uint32_t c9 = h[9] >> 25;
  h[9] &= (1u << 25) - 1;
  h[0] += 19 * c9;
  h[1] += h[0] >> 26;
  h[0] &= (1u << 26) - 1;
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = h[i];
}

FE_FN void fe_add(fe &out, const fe &a, const fe &b) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + b.v[i];
  fe_carry32(out, h);
}

FE_FN void fe_sub(fe &out, const fe &a, const fe &b) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t two_p = (i == 0) ? FE_2P_0 : ((i & 1) ? FE_2P_ODD : FE_2P_EVEN);
    h[i] = a.v[i] + two_p - b.v[i];
  }
  fe_carry32(out, h);
}

FE_FN void fe_neg(fe &out, const fe &a) {
  fe zero;
#pragma unroll
  for (int i = 0; i < 10; ++i) zero.v[i] = 0;
  fe_sub(out, zero, a);
}

// Schoolbook 10x10 product's columns: a product of two odd limbs lands one
// bit high (x2), a product past limb 9 wraps with 2^255 = 19 (x19).
FE_FN void fe_mul_columns(uint64_t h[10], const fe &f, const fe &g) {
  uint32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    g19[i] = 19u * g.v[i];
    f2[i] = (i & 1) ? 2u * f.v[i] : f.v[i];
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const uint32_t fi = (i & 1) && (j & 1) ? f2[i] : f.v[i];
      const uint32_t gj = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (uint64_t)fi * gj;
    }
  }
}

FE_FN void fe_mul(fe &out, const fe &f, const fe &g) {
  uint64_t h[10];
  fe_mul_columns(h, f, g);
  fe_carry64(out, h);
}

// The same columns as fe_mul(f, f) from 55 products instead of 100: each
// pair i < j is taken once and doubled. The multiplier m * f[j] stays below
// 2^32 (m <= 76, f[j] < 2^25 + 2^18 where m has the odd-pair factor 2, as
// in ge25519_group.cuh's nearly carried form).
FE_FN void fe_sq_columns(uint64_t h[10], const fe &f) {
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      uint32_t m = (i == j) ? 1u : 2u;
      if ((i & 1) && (j & 1)) m *= 2u;
      if (i + j >= 10) m *= 19u;
      h[(i + j) % 10] += (uint64_t)f.v[i] * (m * f.v[j]);
    }
  }
}

FE_FN void fe_sq(fe &out, const fe &f) {
  uint64_t h[10];
  fe_sq_columns(h, f);
  fe_carry64(out, h);
}

FE_FN void fe_sq_n(fe &out, const fe &f, int n) {
  fe_sq(out, f);
  for (int i = 1; i < n; ++i) fe_sq(out, out);
}

// x^(p-2), ref10's addition chain.
FE_FN void fe_invert(fe &out, const fe &x) {
  fe t0, t1, t2, t3;
  fe_sq(t0, x);             // 2
  fe_sq_n(t1, t0, 2);       // 8
  fe_mul(t1, x, t1);        // 9
  fe_mul(t2, t0, t1);       // 11
  fe_sq(t3, t2);            // 22
  fe_mul(t3, t1, t3);       // 2^5 - 1
  fe_sq_n(t0, t3, 5);
  fe_mul(t1, t0, t3);       // t4 = 2^10 - 1
  fe_sq_n(t0, t1, 10);
  fe_mul(t3, t0, t1);       // t5 = 2^20 - 1
  fe_sq_n(t0, t3, 20);
  fe_mul(t0, t0, t3);       // t6 = 2^40 - 1
  fe_sq_n(t0, t0, 10);
  fe_mul(t3, t0, t1);       // t5 = 2^50 - 1
  fe_sq_n(t0, t3, 50);
  fe_mul(t1, t0, t3);       // t6 = 2^100 - 1
  fe_sq_n(t0, t1, 100);
  fe_mul(t0, t0, t1);       // t7 = 2^200 - 1
  fe_sq_n(t0, t0, 50);
  fe_mul(t0, t0, t3);       // t6 = 2^250 - 1
  fe_sq_n(t0, t0, 5);
  fe_mul(out, t0, t2);      // 2^255 - 21
}

// x^((p-5)/8) = x^(2^252-3), ref10's fe_pow22523 chain.
FE_FN void fe_pow_p58(fe &out, const fe &x) {
  fe t0, t1, t2, t3;
  fe_sq(t0, x);             // 2
  fe_sq_n(t1, t0, 2);       // 8
  fe_mul(t1, x, t1);        // 9
  fe_mul(t0, t0, t1);       // 11
  fe_sq(t0, t0);            // 22
  fe_mul(t0, t1, t0);       // 2^5 - 1
  fe_sq_n(t1, t0, 5);
  fe_mul(t1, t1, t0);       // 2^10 - 1
  fe_sq_n(t2, t1, 10);
  fe_mul(t2, t2, t1);       // 2^20 - 1
  fe_sq_n(t3, t2, 20);
  fe_mul(t3, t3, t2);       // 2^40 - 1
  fe_sq_n(t2, t3, 10);
  fe_mul(t2, t2, t1);       // 2^50 - 1
  fe_sq_n(t3, t2, 50);
  fe_mul(t3, t3, t2);       // 2^100 - 1
  fe_sq_n(t1, t3, 100);
  fe_mul(t1, t1, t3);       // 2^200 - 1
  fe_sq_n(t1, t1, 50);
  fe_mul(t1, t1, t2);       // 2^250 - 1
  fe_sq_n(t1, t1, 2);
  fe_mul(out, t1, x);       // 2^252 - 3
}

// Carried form -> the unique limbs of the value in [0, p). Two full passes
// leave every limb in range and the value below 2^255 < 2p; then p is
// subtracted once if the value is not below it.
FE_FN void fe_canonical(fe &out, const fe &x) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = x.v[i];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int w = (i & 1) ? 25 : 26;
      h[i + 1] += h[i] >> w;
      h[i] &= (1u << w) - 1;
    }
    const uint32_t c9 = h[9] >> 25;
    h[9] &= (1u << 25) - 1;
    h[0] += 19 * c9;
  }
  uint32_t d[10];
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int w = (i & 1) ? 25 : 26;
    const int32_t p_i = (i == 0) ? 0x3FFFFED : (int32_t)((1u << w) - 1);
    int32_t t = (int32_t)h[i] - p_i - borrow;
    borrow = t < 0;
    d[i] = (uint32_t)(t + (borrow << w));
  }
  // borrow out: the value was below p, keep it
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = borrow ? h[i] : d[i];
}

FE_FN bool fe_eq(const fe &a, const fe &b) {
  fe ca, cb;
  fe_canonical(ca, a);
  fe_canonical(cb, b);
  bool same = true;
#pragma unroll
  for (int i = 0; i < 10; ++i) same &= ca.v[i] == cb.v[i];
  return same;
}

// Eight little-endian u32 words -> limbs of the low 255 bits (bit 255 is
// the sign bit and is left out).
FE_FN void fe_from_words(fe &out, const uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int off = (i * 51 + 1) / 2;  // ceil(25.5 i)
    const int width = (i & 1) ? 25 : 26;
    const int j = off / 32, k = off % 32;
    uint64_t win = w[j];
    if (j + 1 < 8) win |= (uint64_t)w[j + 1] << 32;
    out.v[i] = (uint32_t)(win >> k) & ((1u << width) - 1);
  }
}

// Canonical limbs -> eight little-endian u32 words (bits 0..254).
FE_FN void fe_to_words(uint32_t w[8], const fe &c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int off = (i * 51 + 1) / 2;
    const int j = off / 32, k = off % 32;
    w[j] |= c.v[i] << k;
    if (k != 0 && j + 1 < 8) w[j + 1] |= c.v[i] >> (32 - k);
  }
}

// --- the curve's constants and decompression --------------------------------

// Constants in canonical limbs; tests/test_torch_ed25519.py recomputes each
// from its definition and checks these literals.
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

// y (low 255 bits), sign bit -> x with ref10 semantics; false when
// x^2 = (y^2 - 1) / (d y^2 + 1) has no root. Compiled once: a kernel
// decompresses in several places, and each inlined copy of its 251
// squarings adds seconds to the build.
__device__ __noinline__ bool decompress(fe &x, const fe &y, uint32_t sign) {
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

// R as encode() could give it: y (the low 255 bits) below p, a root, and
// not x = 0 with the sign bit set; (x, y) canonical. encode(P) of a point
// P equals R's bytes exactly when this holds and P = (x, y).
FE_FN bool decode_r(fe &xc, fe &yc, const uint32_t rw[8]) {
  fe y, x;
  fe_from_words(y, rw);
  fe_canonical(yc, y);
  bool canon = true;
#pragma unroll
  for (int i = 0; i < 10; ++i) canon &= yc.v[i] == y.v[i];
  const uint32_t sign = rw[7] >> 31;
  const bool root = decompress(x, yc, sign);
  fe_canonical(xc, x);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) any |= xc.v[i];
  return canon && root && !(any == 0 && sign != 0);
}

// --- points: extended (X, Y, Z, T), a = -1 ----------------------------------

struct ge {
  fe X, Y, Z, T;
};

struct ge_cached {
  fe YplusX, YminusX, T2d, Z2;
};

// dbl-2008-hwcd; valid for every input, identity included.
FE_FN void ge_dbl(ge &r, const ge &p) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(t, p.Z);
  fe_add(c, t, t);
  fe_neg(d, a);
  fe_add(t, p.X, p.Y);
  fe_sq(e, t);
  fe_sub(e, e, a);
  fe_sub(e, e, b);
  fe_add(g, d, b);
  fe_sub(f, g, c);
  fe_sub(h, d, b);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// add-2008-hwcd-3 with q cached; complete on edwards25519.
FE_FN void ge_add_cached(ge &r, const ge &p, const ge_cached &q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, q.YminusX);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, q.YplusX);
  fe_mul(c, p.T, q.T2d);
  fe_mul(d, p.Z, q.Z2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

FE_FN void ge_to_cached(ge_cached &r, const ge &p, const fe &d2) {
  fe_add(r.YplusX, p.Y, p.X);
  fe_sub(r.YminusX, p.Y, p.X);
  fe_mul(r.T2d, p.T, d2);
  fe_add(r.Z2, p.Z, p.Z);
}

FE_FN void ge_add(ge &r, const ge &p, const ge &q, const fe &d2) {
  ge_cached qc;
  ge_to_cached(qc, q, d2);
  ge_add_cached(r, p, qc);
}

// --- helpers of the resident comb (ed25519_resident.cu) ---------------------

// A point in affine Niels form (y+x, y-x, 2d x y): what a precomputed
// table holds, one product cheaper to add than ge_cached.
struct ge_niels {
  fe yp, ym, t2d;
};

FE_FN void ge_identity(ge &r) {
  fe_zero(r.X);
  fe_one(r.Y);
  fe_one(r.Z);
  fe_zero(r.T);
}

// ref10's ge_madd: add-2008-hwcd-3 with Z2 = 1; complete on edwards25519.
// r may alias p.
FE_FN void ge_madd(ge &r, const ge &p, const ge_niels &q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, q.ym);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, q.yp);
  fe_mul(c, p.T, q.t2d);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// ge_dbl without T (dbl-2008-hwcd reads no T): for a run of doublings
// whose intermediate points are only doubled again. r may alias p.
FE_FN void ge_dbl_xyz(ge &r, const ge &p) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(t, p.Z);
  fe_add(c, t, t);
  fe_neg(d, a);
  fe_add(t, p.X, p.Y);
  fe_sq(e, t);
  fe_sub(e, e, a);
  fe_sub(e, e, b);
  fe_add(g, d, b);
  fe_sub(f, g, c);
  fe_sub(h, d, b);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
}

// --- comb tables (ed25519_resident.cu builds them; the resident kernel and
// the wire-key kernels' fixed-base half read them) ---------------------------

// A key's tables: for slice t in 0..3 and j in 0..15, row 16 t + j holds
// sum_i j_i 2^(64 i + 16 t) P in affine Niels form (canonical limbs of
// y+x, y-x, 2d x y); row FLAG_ROW word 0 is the key's validity flag.
#define COMB_SLICES 4
#define COMB_COLUMNS 16
#define SLICE_ENTRIES 16
#define ENTRY_WORDS 32  // y+x, y-x, 2d x y (ten limbs each), two words of padding
#define FLAG_ROW (COMB_SLICES * SLICE_ENTRIES)
#define KEY_WORDS ((FLAG_ROW + 1) * ENTRY_WORDS)

// Comb digit (slice u, column c) of the scalar in words w[0..8): bits
// 64 i + 16 u + c, i = 0..3.
FE_FN uint32_t comb_digit(const uint32_t *w, int u, int c) {
  const int bit = 16 * u + c;
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) d |= ((w[2 * i + (bit >> 5)] >> (bit & 31)) & 1u) << i;
  return d;
}

FE_FN void load_niels(ge_niels &q, const uint32_t *__restrict__ e) {
  const uint4 *e4 = reinterpret_cast<const uint4 *>(e);
  uint32_t w[32];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint4 v = __ldg(e4 + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    q.yp.v[i] = w[i];
    q.ym.v[i] = w[10 + i];
    q.t2d.v[i] = w[20 + i];
  }
}
