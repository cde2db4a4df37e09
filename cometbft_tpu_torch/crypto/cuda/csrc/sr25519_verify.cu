// sr25519 (schnorrkel over ristretto255) verification, one thread per
// signature.
//
// sr25519_verify replaces cometbft_tpu/crypto/tpu/sr25519_batch.py::
// _verify_core (verify_kernel, :88-140) with ristretto_decode (:65),
// _sqrt_ratio_m1 (:48) and _is_neg (:43). Input: the wire u8[128, B],
// byte-major (row r of lane b at r * B + b): rows 0:32 A, 32:64 R, 64:96 s
// (the format bit cleared), 96:128 the merlin challenge k, all
// little-endian. Output: u8[B], 1 where A and R decode and
// P = s B + k (-A) equals R under ristretto equality. The host ANDs it
// with its validity mask (lengths, the format bit, s < L, A and R
// canonical and even), exactly as the reference does.
//
// sr25519 rides the Ed25519 curve, so the field and the point layer are
// fe25519.cuh's, and the joint table ds B + dh (-A) and the 127-step
// radix-4 Straus loop are those of ed25519_verify.cu's verify_core. What
// differs is the wrapping: A and R are ristretto255 encodings, decoded per
// RFC 9496 4.3.1 (SQRT_RATIO_M1 over fe_pow_p58; ok when the ratio was a
// square, t = x y is non-negative and y != 0), and the check is ristretto
// equality against affine R, X y_R == Y x_R or Y y_R == X x_R (RFC 9496
// 4.5, a = -1): a cross-multiplication, so no inversion.
//
// What bounds it on this card: integer operations, as the Ed25519 core. A
// signature costs two decodes (each one fe_pow_p58, 251 squarings and 11
// products, plus about 20 products), the 16-entry table and 127 steps of
// two doublings and one cached addition, and four products for the check:
// about 0.9 M 32-bit integer instructions (chip_smoke.py counts them)
// against 129 bytes moved. Field elements stay in registers as ten uint32
// limbs; the 16 cached points are indexed by a run-time digit and live in
// local memory, as in the Ed25519 core.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

// Constants in canonical limbs; tests/test_torch_sr25519.py recomputes each
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

#define NUM_DIGITS 127

// Ristretto's "negative": the canonical representative is odd.
__device__ __forceinline__ bool fe_is_neg(const fe &x) {
  fe c;
  fe_canonical(c, x);
  return (c.v[0] & 1u) != 0;
}

__device__ __forceinline__ bool fe_is_zero(const fe &x) {
  fe c;
  fe_canonical(c, x);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) any |= c.v[i];
  return any == 0;
}

// RFC 9496 SQRT_RATIO_M1: r = the non-negative root of u/v, or of i u/v
// when u/v is not a square; returns was_square.
__device__ bool sqrt_ratio_m1(fe &r, const fe &u, const fe &v) {
  fe v3, v7, t, check, neg_u, neg_u_i, sqrt_m1;
  fe_const(sqrt_m1, K_SQRT_M1);
  fe_sq(v3, v);
  fe_mul(v3, v3, v);
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(r, u, v3);
  fe_mul(r, r, t);
  fe_sq(check, r);
  fe_mul(check, v, check);
  fe_neg(neg_u, u);
  fe_mul(neg_u_i, neg_u, sqrt_m1);
  const bool correct = fe_eq(check, u);
  const bool flipped = fe_eq(check, neg_u);
  const bool flipped_i = fe_eq(check, neg_u_i);
  if (flipped || flipped_i) fe_mul(r, r, sqrt_m1);
  if (fe_is_neg(r)) fe_neg(r, r);
  return correct || flipped;
}

// RFC 9496 4.3.1 on the low 255 bits of an encoding (the host has checked
// it is canonical and even): affine (x, y); false when it does not decode.
__device__ bool ristretto_decode(fe &x, fe &y, const uint32_t w[8]) {
  fe s, one, d, ss, u1, u2, u2_sqr, v, t, invsqrt, den_x, den_y;
  fe_from_words(s, w);
  fe_one(one);
  fe_const(d, K_D);
  fe_sq(ss, s);
  fe_sub(u1, one, ss);
  fe_add(u2, one, ss);
  fe_sq(u2_sqr, u2);
  fe_mul(t, d, u1);
  fe_mul(t, t, u1);
  fe_neg(t, t);
  fe_sub(v, t, u2_sqr);
  fe_mul(t, v, u2_sqr);
  const bool was_square = sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den_x, invsqrt, u2);
  fe_mul(den_y, invsqrt, den_x);
  fe_mul(den_y, den_y, v);
  fe_add(t, s, s);
  fe_mul(x, t, den_x);
  if (fe_is_neg(x)) fe_neg(x, x);
  fe_mul(y, u1, den_y);
  fe_mul(t, x, y);
  return was_square && !fe_is_neg(t) && !fe_is_zero(y);
}

// s B + k (-A) equals R under ristretto equality, and A and R decode.
__device__ bool sr25519_core(const uint32_t aw[8], const uint32_t rw[8],
                             const uint32_t sw[8], const uint32_t kw[8]) {
  fe d2;
  fe_const(d2, K_D2);

  ge neg_a;
  fe ax, rx, ry;
  const bool ok_a = ristretto_decode(ax, neg_a.Y, aw);
  const bool ok_r = ristretto_decode(rx, ry, rw);
  fe_neg(neg_a.X, ax);
  fe_one(neg_a.Z);
  fe_mul(neg_a.T, neg_a.X, neg_a.Y);

  // s_pts: identity, B, 2B, 3B; k_pts: -, -A, -2A, -3A
  ge s_pts[4], k_pts[4];
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
  k_pts[1] = neg_a;
  ge_dbl(k_pts[2], neg_a);
  ge_add(k_pts[3], k_pts[2], neg_a, d2);

  // table[ds + 4 dk] = ds B + dk (-A), cached
  ge_cached table[16];
#pragma unroll 1
  for (int dk = 0; dk < 4; ++dk) {
#pragma unroll 1
    for (int ds = 0; ds < 4; ++ds) {
      ge pt;
      if (dk == 0) {
        pt = s_pts[ds];
      } else if (ds == 0) {
        pt = k_pts[dk];
      } else {
        ge_add(pt, s_pts[ds], k_pts[dk], d2);
      }
      ge_to_cached(table[ds + 4 * dk], pt, d2);
    }
  }

  // 127 radix-4 steps, digits MSB first: bit pairs 252..0 of s and k
  ge acc = s_pts[0];
#pragma unroll 1
  for (int bit = 2 * (NUM_DIGITS - 1); bit >= 0; bit -= 2) {
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    const uint32_t ds = (sw[bit >> 5] >> (bit & 31)) & 3u;
    const uint32_t dk = (kw[bit >> 5] >> (bit & 31)) & 3u;
    ge_add_cached(acc, acc, table[ds + 4 * dk]);
  }

  fe l, r;
  fe_mul(l, acc.X, ry);
  fe_mul(r, acc.Y, rx);
  const bool eq1 = fe_eq(l, r);
  fe_mul(l, acc.Y, ry);
  fe_mul(r, acc.X, rx);
  const bool eq2 = fe_eq(l, r);
  return (eq1 || eq2) && ok_a && ok_r;
}

__global__ void __launch_bounds__(128)
sr25519_verify_kernel(const uint8_t *__restrict__ wire,
                      uint8_t *__restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  uint32_t aw[8], rw[8], sw[8], kw[8];
  load_words(aw, wire, 0, B, b);
  load_words(rw, wire, 32, B, b);
  load_words(sw, wire, 64, B, b);
  load_words(kw, wire, 96, B, b);
  out[b] = sr25519_core(aw, rw, sw, kw) ? 1 : 0;
}

extern "C" int cbt_sr25519_verify(const void *wire, void *out, int B,
                                  void *stream) {
  sr25519_verify_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)wire, (uint8_t *)out, B);
  return (int)cudaGetLastError();
}
