// Scalars mod L = 2^252 + 27742317777372353535851937790883648493 for one
// CUDA thread: ref10's sc_reduce on a SHA-512 digest.
//
// Replaces cometbft_tpu/crypto/tpu/scalar.py (digest_to_limbs :148,
// sc_reduce :97; the digits of :180 are read by verify_core itself). The
// reduction must be exact: cofactorless verification computes [h](-A),
// and on a key with a torsion component h and h + kL give different
// verdicts. The TPU form folds radix-2^15 limbs in int32; here the
// 512-bit value is split into 24 signed 21-bit limbs in int64_t (limb 23
// holds the top 29 bits) and reduced exactly as ref10's sc_reduce does:
// 2^252 = -c (mod L) folded in as the six signed 21-bit digits of -c,
// rounded carries between the folds, two floor-carry passes at the end,
// which leave the canonical residue in [0, L). Every loop below is fully
// unrolled, so each limb index is a constant and the limbs stay in
// registers. The torch twin, step for step, is crypto/cuda/scalar.py,
// held against Python's int % L.

#pragma once
#include <stdint.h>

#include "sha512.cuh"

#define SC_FN __device__ __forceinline__

SC_FN void sc_fold(int64_t s[24], int k) {
  const int64_t c = s[k];
  s[k - 12] += c * 666643;
  s[k - 11] += c * 470296;
  s[k - 10] += c * 654183;
  s[k - 9] -= c * 997805;
  s[k - 8] += c * 136657;
  s[k - 7] -= c * 683901;
  s[k] = 0;
}

SC_FN void sc_carry_round(int64_t s[24], int i) {
  const int64_t c = (s[i] + (1ll << 20)) >> 21;
  s[i + 1] += c;
  s[i] -= c * (1ll << 21);
}

SC_FN void sc_carry_floor(int64_t s[24], int i) {
  const int64_t c = s[i] >> 21;
  s[i + 1] += c;
  s[i] -= c * (1ll << 21);
}

// h = digest mod L, the digest read as a little-endian 512-bit integer,
// out as eight little-endian u32 words.
SC_FN void sc_reduce_digest(uint32_t hw[8], const uint64_t st[8]) {
  int64_t s[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int bit = 21 * i, n = bit >> 3, off = bit & 7;
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (n + k < 64) v |= (uint64_t)sha512_digest_byte(st, n + k) << (8 * k);
    }
    v >>= off;
    s[i] = (int64_t)(i < 23 ? (v & 0x1FFFFFull) : v);
  }
#pragma unroll
  for (int k = 23; k >= 18; --k) sc_fold(s, k);
#pragma unroll
  for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int k = 17; k >= 12; --k) sc_fold(s, k);
#pragma unroll
  for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i <= 11; ++i) sc_carry_floor(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i <= 10; ++i) sc_carry_floor(s, i);

  // limbs 0..10 are now in [0, 2^21), limb 11 in [0, 2^22): pack
  uint64_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int off = 21 * i, j = off >> 6, k = off & 63;
    const uint64_t limb = (uint64_t)s[i];
    v[j] |= limb << k;
    if (k + 22 > 64) v[j + 1] |= limb >> (64 - k);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    hw[2 * j] = (uint32_t)v[j];
    hw[2 * j + 1] = (uint32_t)(v[j] >> 32);
  }
}
