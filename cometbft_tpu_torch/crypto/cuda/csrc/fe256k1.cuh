// GF(p), p = 2^256 - 2^32 - 977, for one CUDA thread.
//
// Replaces the limb arithmetic of cometbft_tpu/crypto/tpu/secp_field.py
// (mul :174, _fold_v :145, sq :183, to_canonical :197, _borrow_sub :224,
// sqrt_candidate :266). The TPU form is int32[19,B] radix-2^14 limbs
// because its vector lanes have no 32x32->64 multiply; Hopper has one
// (IMAD.WIDE.U32), so an element here is ten 26-bit limbs (limb i at bit
// 26 i) held as uint32, with uint64 column sums. The same arithmetic,
// limb for limb, is the torch twin in crypto/cuda/secp_field.py, which the
// CPU tests hold against Python ints.
//
// Reduction rests on 2^256 = 2^32 + 977 (mod p), so 2^260 = 0x1000003D10
// = 0x400 * 2^26 + 0x3D10: a carry out of limb 9 (weight 2^260) folds back
// as 0x3D10 into limb 0 and 0x400 into limb 1.
//
// Invariant ("carried form"): every limb is below 2^26, except limb 1,
// which may exceed 2^26 by less than 2^15. fe_sub adds 32p (every limb of
// it at least 2^26 + 2^15) before subtracting, so nothing goes negative;
// after fe_add, fe_sub or fe_mul_small (x21) a limb is below 2^32, so their
// carry pass runs in uint32. A product column is at most ten terms below
// (2^26 + 2^15)^2, so it stays below 2^56.

#pragma once
#include <stdint.h>

#define FE_FN __device__ __forceinline__
#define FE_MASK 0x3FFFFFFu
#define FE_FOLD_LO 0x3D10u  // 2^260 mod p = FE_FOLD_HI * 2^26 + FE_FOLD_LO
#define FE_FOLD_HI 0x400u

struct fe {
  uint32_t v[10];
};

// p and 32p, limb by limb (tests/test_torch_secp256k1.py recomputes both)
__constant__ uint32_t K_P[10] = {
    0x3fffc2f, 0x3ffffbf, 0x3ffffff, 0x3ffffff, 0x3ffffff,
    0x3ffffff, 0x3ffffff, 0x3ffffff, 0x3ffffff, 0x03fffff};
__constant__ uint32_t K_SUB[10] = {
    0x7fff85e0, 0x7ffff7e0, 0x7fffffe0, 0x7fffffe0, 0x7fffffe0,
    0x7fffffe0, 0x7fffffe0, 0x7fffffe0, 0x7fffffe0, 0x7ffffe0};

// One floor-carry pass, the carry out of limb 9 folded back, then one more
// carry out of limb 0. T is uint32_t (fe_add, fe_sub, fe_mul_small) or
// uint64_t (the end of fe_reduce).
template <typename T>
FE_FN void fe_carry(fe &out, T h[10]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    h[i + 1] += h[i] >> 26;
    h[i] &= FE_MASK;
  }
  const T top = h[9] >> 26;
  h[9] &= FE_MASK;
  h[0] += top * FE_FOLD_LO;
  h[1] += top * FE_FOLD_HI + (h[0] >> 26);
  h[0] &= FE_MASK;
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = (uint32_t)h[i];
}

FE_FN void fe_add(fe &out, const fe &a, const fe &b) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + b.v[i];
  fe_carry(out, h);
}

FE_FN void fe_sub(fe &out, const fe &a, const fe &b) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + K_SUB[i] - b.v[i];
  fe_carry(out, h);
}

FE_FN void fe_neg(fe &out, const fe &a) {
  fe zero;
#pragma unroll
  for (int i = 0; i < 10; ++i) zero.v[i] = 0;
  fe_sub(out, zero, a);
}

FE_FN void fe_mul_small(fe &out, const fe &a, uint32_t k) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] * k;
  fe_carry(out, h);
}

// 19 product columns -> carried form: their 20 digits of 26 bits (digit
// 19 keeps the rest), digits 10..19 folded down (digit 10 + m adds 0x3D10
// at limb m and 0x400 at limb m + 1), one carry pass with the fold, and
// fe_carry.
FE_FN void fe_reduce(fe &out, const uint64_t c[19]) {
  uint64_t d[20];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 19; ++k) {
    const uint64_t t = c[k] + carry;
    d[k] = t & FE_MASK;
    carry = t >> 26;
  }
  d[19] = carry;
  uint64_t h[10];
  h[0] = d[0] + d[10] * FE_FOLD_LO;
#pragma unroll
  for (int k = 1; k < 10; ++k) h[k] = d[k] + d[10 + k] * FE_FOLD_LO + d[9 + k] * FE_FOLD_HI;
  uint64_t top = d[19] * FE_FOLD_HI;  // weight 2^260
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    h[i + 1] += h[i] >> 26;
    h[i] &= FE_MASK;
  }
  top += h[9] >> 26;
  h[9] &= FE_MASK;
  h[0] += top * FE_FOLD_LO;
  h[1] += top * FE_FOLD_HI;
  fe_carry(out, h);
}

// Schoolbook 10x10 product into 19 columns.
FE_FN void fe_mul(fe &out, const fe &a, const fe &b) {
  uint64_t c[19];
#pragma unroll
  for (int k = 0; k < 19; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) c[i + j] += (uint64_t)a.v[i] * b.v[j];
  }
  fe_reduce(out, c);
}

// The columns of fe_mul(a, a) from 55 products: each pair i < j once, with
// 2 a[i] (below 2^28) as the multiplier.
FE_FN void fe_sq(fe &out, const fe &a) {
  uint64_t c[19];
#pragma unroll
  for (int k = 0; k < 19; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    c[2 * i] += (uint64_t)a.v[i] * a.v[i];
    const uint32_t a2 = 2u * a.v[i];
#pragma unroll
    for (int j = i + 1; j < 10; ++j) c[i + j] += (uint64_t)a2 * a.v[j];
  }
  fe_reduce(out, c);
}

FE_FN void fe_sq_n(fe &out, const fe &a, int n) {
  out = a;
#pragma unroll 1
  for (int k = 0; k < n; ++k) fe_sq(out, out);
}

// a^((p+1)/4) by libsecp256k1's addition chain (253 squarings, 13
// products): a square root of a when one exists, p = 3 mod 4.
FE_FN void fe_sqrt_candidate(fe &out, const fe &a) {
  fe x2, x3, x6, x9, x11, x22, x44, x88, x176, x220, x223, t;
  fe_sq(t, a);
  fe_mul(x2, t, a);
  fe_sq(t, x2);
  fe_mul(x3, t, a);
  fe_sq_n(t, x3, 3);
  fe_mul(x6, t, x3);
  fe_sq_n(t, x6, 3);
  fe_mul(x9, t, x3);
  fe_sq_n(t, x9, 2);
  fe_mul(x11, t, x2);
  fe_sq_n(t, x11, 11);
  fe_mul(x22, t, x11);
  fe_sq_n(t, x22, 22);
  fe_mul(x44, t, x22);
  fe_sq_n(t, x44, 44);
  fe_mul(x88, t, x44);
  fe_sq_n(t, x88, 88);
  fe_mul(x176, t, x88);
  fe_sq_n(t, x176, 44);
  fe_mul(x220, t, x44);
  fe_sq_n(t, x220, 3);
  fe_mul(x223, t, x3);
  fe_sq_n(t, x223, 23);
  fe_mul(t, t, x22);
  fe_sq_n(t, t, 6);
  fe_mul(t, t, x2);
  fe_sq_n(out, t, 2);
}

// Carried form -> the unique limbs in [0, p). Two passes fold the bits
// above 2^256 (limb 9 keeps 22 bits) as 0x3D1 into limb 0 and 0x40 into
// limb 1, each ending with a carry out of limb 0; the value is then below
// 2^256 < 2p with every limb in range, and one conditional subtraction of
// p finishes.
FE_FN void fe_canonical(fe &out, const fe &a) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      h[i + 1] += h[i] >> 26;
      h[i] &= FE_MASK;
    }
    const uint32_t c = h[9] >> 22;
    h[9] &= (1u << 22) - 1;
    h[0] += c * 0x3D1u;
    h[1] += c * 0x40u + (h[0] >> 26);
    h[0] &= FE_MASK;
  }
  uint32_t d[10];
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    int32_t t = (int32_t)h[i] - (int32_t)K_P[i] - borrow;
    borrow = t < 0;
    d[i] = (uint32_t)(t + (borrow << (i == 9 ? 22 : 26)));
  }
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

FE_FN bool fe_is_zero(const fe &a) {
  fe c;
  fe_canonical(c, a);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) any |= c.v[i];
  return any == 0;
}
