// sr25519 (schnorrkel over ristretto255) verification, G threads a
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
// sr25519 rides the Ed25519 curve, so the field, the point layer, the
// Straus core and the block are those of ed25519_verify.cu (fe25519.cuh,
// ge25519_group.cuh): G = 4 threads a lane at a flush and at a window
// chunk, each group computing [h](-A) (here [k](-A)) while the thread
// beside it decodes R and computes [s]B by B's comb tables; G = 1 runs
// the first design's joint loop. What differs is the wrapping: A and R are
// ristretto255 encodings, decoded per RFC 9496 4.3.1 (SQRT_RATIO_M1 over
// fe_pow_p58; ok when the ratio was a square, t = x y is non-negative and
// y != 0). Every thread of a group decodes A. The check is ristretto
// equality against affine R, X y_R == Y x_R or Y y_R == X x_R (RFC 9496
// 4.5, a = -1): a cross-multiplication, so no inversion.
//
// What bounds it on this card: as the Ed25519 core. At a flush of 180
// lanes (G = 4) the latency of the group's chain: A's decode (251
// squarings), the table and 256 doublings and 64 additions at one squaring
// or two products a round on each thread. At G = 1 integer operations:
// two decodes (each fe_pow_p58 and about 30 products), the joint table,
// 127 steps of two doublings and one cached addition, and four products
// for the check, about 0.93 M 32-bit integer instructions a lane
// (chip_smoke.py counts them) against 129 bytes moved.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "ge25519_group.cuh"

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
__device__ __forceinline__ bool sqrt_ratio_m1(fe &r, const fe &u, const fe &v) {
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
__device__ __noinline__ bool ristretto_decode(fe &x, fe &y, const uint32_t w[8]) {
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

// s B + k (-A) equals R under ristretto equality, and A and R decode; the
// verdict is the one of thread 0 of a live lane's group. Every thread of
// the block calls it; btab is B's comb tables (read at G = 2 and 4).
__device__ __noinline__ bool verify_lane(const uint32_t aw[8], const uint32_t rw[8],
                                         const uint32_t sw[8], const uint32_t kw[8],
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
      for (int j = 0; j < 8; ++j) s_h[r.g][j] = kw[j];
      h_arrive();
    }
    // R, then [s]B, beside the groups
    fe xc, yc;
    fe_zero(xc);
    fe_zero(yc);
    const bool ok = r.live && ristretto_decode(xc, yc, rw);
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
    fe ax, y, nx;
    ok_a = ristretto_decode(ax, y, aw);
    fe_neg(nx, ax);
    if (G == 1) {
      ge neg_a, acc;
      neg_a.X = nx;
      neg_a.Y = y;
      fe_one(neg_a.Z);
      fe_mul(neg_a.T, nx, y);
      straus_one(acc, neg_a, sw, kw);
      X = acc.X;
      Y = acc.Y;
      Z = acc.Z;
    } else {
      variable_base_g(part, nx, y, h_beside ? s_h[r.g] : kw, h_beside, s_tab, r, G);
    }
  }
  if (G > 1) {
    __syncthreads();
    if (!r.r_warp) finish_group_g(X, Y, Z, part, s_sb[r.g], r, G);
  }
  if (r.r_warp || r.t != 0 || !r.live) return false;
  fe rx, ry, l, rr;
  bool ok_r;
  if (G == 1) {
    ok_r = ristretto_decode(rx, ry, rw);
  } else {
    ok_r = s_rok[r.g] != 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      rx.v[i] = s_rx[r.g][i];
      ry.v[i] = s_ry[r.g][i];
    }
  }
  fe_mul(l, X, ry);
  fe_mul(rr, Y, rx);
  const bool eq1 = fe_eq(l, rr);
  fe_mul(l, Y, ry);
  fe_mul(rr, X, rx);
  const bool eq2 = fe_eq(l, rr);
  return (eq1 || eq2) && ok_a && ok_r;
}

__global__ void __launch_bounds__(MAX_THREADS)
sr25519_verify_kernel(const uint8_t *__restrict__ wire, const uint32_t *__restrict__ btab,
                      uint8_t *__restrict__ out, int B, int G) {
  const lane_role r = lane_role_of(G, B);
  uint32_t aw[8] = {0}, rw[8] = {0}, sw[8] = {0}, kw[8] = {0};
  if (r.live) {
    load_words(aw, wire, 0, B, r.b);
    load_words(rw, wire, 32, B, r.b);
    load_words(sw, wire, 64, B, r.b);
    load_words(kw, wire, 96, B, r.b);
  }
  const bool ok = verify_lane(aw, rw, sw, kw, btab, false, r, G);
  if (!r.r_warp && r.t == 0 && r.live) out[r.b] = ok ? 1 : 0;
}

// base: B's comb tables (ed25519_batch.base_tables); at G = 1 not read.
extern "C" int cbt_sr25519_verify(const void *wire, const void *base, void *out, int B, int G,
                                  void *stream) {
  if (G != 1 && G != 2 && G != 4) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(sr25519_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TABLE_SMEM);
  if (e == cudaSuccess)  // at G = 1 the tables sit in local memory: favour L1
    e = cudaFuncSetAttribute(sr25519_verify_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             G == 1 ? cudaSharedmemCarveoutMaxL1 : cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  sr25519_verify_kernel<<<lane_blocks(B, G), block_threads(B, G), block_smem(B, G), (cudaStream_t)stream>>>(
      (const uint8_t *)wire, (const uint32_t *)base, (uint8_t *)out, B, G);
  return (int)cudaGetLastError();
}
