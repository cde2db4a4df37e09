// The Straus core of the wire-key kernels (ed25519_verify.cu's four
// Ed25519 kernels and sr25519_verify.cu): [s]B + [h](-A) from -A's affine
// coordinates and the scalars' words, by one thread a lane or by a group
// of G threads of one warp with a further thread beside it.
//
// * G = 1, straus_one: the first design's joint table ds B + dh (-A) in
//   cached form (local memory, 2,560 bytes a thread, indexed by a run-time
//   digit) and 127 radix-4 steps, digits most significant first, of two
//   doublings (dbl-2008-hwcd) and one cached addition (add-2008-hwcd-3), as
//   the reference's _verify_unpacked (cometbft_tpu/crypto/tpu/
//   ed25519_batch.py:274) does. At a window the card is full of lanes, and
//   this keeps the least work a lane.
// * G = 2 and 4: the two halves run side by side. The thread beside the
//   group (the block's R warp, which also decodes R) computes [s]B by the
//   comb over B's tables (fixed_base: 16 columns of one doubling and four
//   Niels additions). The group computes [h](-A) (variable_base): a table
//   of j (-A), j = 0..15, in shared memory, then 64 steps of four doublings
//   and one addition over h's 4-bit windows; then finish_group adds [s]B.
//   The group splits each point operation four ways (Hisil, Wong, Carter
//   and Dawson, "Twisted Edwards Curves Revisited", 2008): thread t holds
//   coordinate t of every point (X, Y, Z, T), and at G = 2 coordinate
//   t + 2 too (its slot 1). A doubling is two rounds, the four squarings
//   X^2, Y^2, Z^2 and (X+Y)^2, then the four products E F, G H, F G and
//   E H; an addition is two rounds of four products. Each thread takes the
//   products of its coordinates, and the operands a round needs (X and Y,
//   or all four results of the round before) cross the group by
//   __shfl_sync. The chain of a doubling falls from 4 squarings and 4
//   products to 1 and 1 at G = 4, of an addition from 8 products to 2. The
//   table is entry-major, coordinate c of entry e at (4 e + c) * 10 words;
//   only the thread that owns coordinate c ever reads or writes it, so it
//   needs no barrier. The loops are flat: a loop over a thread's
//   coordinates or doublings nested in the step loop around inlined point
//   code crashes the CUDA compiler's front end, so slot 1 is an
//   `if constexpr` and the window loop runs 320 phases of one operation.
//
// The group's chain is bound by latency, not by issue, so its field
// arithmetic trades instructions for depth: a product's columns are
// carried in two parallel passes (every limb's carry taken at once)
// instead of fe25519.cuh's sequential pass of eleven steps, a sum that
// feeds only a product is not carried at all (straus_one's formulas too),
// and any other sum is carried in one parallel pass. Values stay "nearly
// carried": every limb below 2^26 (even) or 2^25 (odd) plus 2^18, which
// fe25519.cuh's products, squarings and comparisons take as they are; a sum
// that is not carried stays below 3 2^26 + 2^18 a limb, which a product
// still takes (19 g below 2^32, each column below 2^63).

#pragma once
#include <stdint.h>

#include "fe25519.cuh"

#define NUM_DIGITS 127
#define TABLE_ENTRIES 16
#define TABLE_WORDS (TABLE_ENTRIES * 4 * 10)  // one lane's table: 2,560 bytes
#define GROUP_LANES 32                        // lanes of a block at G = 2 and 4
#define ONE_LANES 128                         // lanes (and threads) of a block at G = 1
#define MAX_THREADS (GROUP_LANES * 5)         // G = 4: four warps of groups, one for R
#define TABLE_SMEM (GROUP_LANES * TABLE_WORDS * 4)  // dynamic shared memory at G = 2 and 4

// 4p, limb by limb: u - a - b = u + 4p - a - b stays non-negative
#define FE_4P_EVEN 0xFFFFFFCu  // 4 * (2^26 - 1), limbs 2, 4, 6, 8
#define FE_4P_ODD 0x7FFFFFCu   // 4 * (2^25 - 1)
#define FE_4P_0 0xFFFFFB4u     // 4 * (2^26 - 19)

// What a thread of a block is. At G = 1 a block is ONE_LANES threads, one
// a lane, and each decodes its own R. At G = 2 and 4 it is L lanes (L G a
// multiple of 32, L at most GROUP_LANES; blockDim.x = L (G + 1)): threads
// 0..L G - 1 hold the lanes' groups (thread g G + t is thread t of lane
// g), and the L threads after them decode the lanes' R values meanwhile.
struct lane_role {
  int g, t, b;
  bool r_warp, live;
};

__device__ __forceinline__ lane_role lane_role_of(int G, int B) {
  lane_role r;
  const int tid = threadIdx.x;
  if (G == 1) {
    r.r_warp = false;
    r.g = tid;
    r.t = 0;
    r.b = blockIdx.x * ONE_LANES + tid;
  } else {
    const int lanes = blockDim.x / (G + 1);
    r.r_warp = tid >= lanes * G;
    r.g = r.r_warp ? tid - lanes * G : tid / G;
    r.t = r.r_warp ? 0 : tid % G;
    r.b = blockIdx.x * lanes + r.g;
  }
  r.live = r.b < B;
  return r;
}

// Lanes of a block: at G = 2 and 4, one warp of groups for a small batch
// (up to SMALL_BATCH lanes; the warp beside it then has a scheduler of its
// own), else GROUP_LANES.
#define SMALL_BATCH 1024

static inline int block_lanes(int B, int G) {
  if (G == 1) return ONE_LANES;
  return B <= SMALL_BATCH ? 32 / G : GROUP_LANES;
}

static inline int lane_blocks(int B, int G) { return (B + block_lanes(B, G) - 1) / block_lanes(B, G); }

static inline int block_threads(int B, int G) { return G == 1 ? ONE_LANES : block_lanes(B, G) * (G + 1); }

static inline int block_smem(int B, int G) { return G == 1 ? 0 : block_lanes(B, G) * TABLE_WORDS * 4; }

// o = c ? a : b
FE_FN void fe_sel(fe &o, bool c, const fe &a, const fe &b) {
#pragma unroll
  for (int i = 0; i < 10; ++i) o.v[i] = c ? a.v[i] : b.v[i];
}

FE_FN void fe_small(fe &o, uint32_t v) {
  o.v[0] = v;
#pragma unroll
  for (int i = 1; i < 10; ++i) o.v[i] = 0;
}

// Barrier 1 of the block (barrier 0 is __syncthreads): the threads beside
// the groups arrive once h is in shared memory, the groups wait for it.
// n counts whole warps.
FE_FN int block_warp_threads() { return (blockDim.x + 31) & ~31; }

FE_FN void h_arrive() { asm volatile("bar.arrive 1, %0;" ::"r"(block_warp_threads()) : "memory"); }

FE_FN void h_wait() { asm volatile("bar.sync 1, %0;" ::"r"(block_warp_threads()) : "memory"); }

// --- the grouped core's field arithmetic -------------------------------------

// Column sums (each below 2^63) -> nearly carried limbs: two parallel
// passes, the carry out of limb 9 folded into limb 0 as 19.
FE_FN void carry_wide(fe &out, const uint64_t h[10]) {
  uint64_t g[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int wi = (i & 1) ? 25 : 26;
    const int j = i == 0 ? 9 : i - 1, wj = (j & 1) ? 25 : 26;
    const uint64_t c = h[j] >> wj;
    g[i] = (h[i] & ((1ull << wi) - 1)) + (i == 0 ? 19 * c : c);
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int wi = (i & 1) ? 25 : 26;
    const int j = i == 0 ? 9 : i - 1, wj = (j & 1) ? 25 : 26;
    const uint32_t c = (uint32_t)(g[j] >> wj);
    out.v[i] = ((uint32_t)g[i] & ((1u << wi) - 1)) + (i == 0 ? 19 * c : c);
  }
}

// Limb sums below 2^30 -> nearly carried limbs: one parallel pass.
FE_FN void carry_once(fe &out, const uint32_t h[10]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int wi = (i & 1) ? 25 : 26;
    const int j = i == 0 ? 9 : i - 1, wj = (j & 1) ? 25 : 26;
    const uint32_t c = h[j] >> wj;
    out.v[i] = (h[i] & ((1u << wi) - 1)) + (i == 0 ? 19 * c : c);
  }
}

// fe_mul and fe_sq with their columns carried by carry_wide.
FE_FN void gmul(fe &out, const fe &f, const fe &g) {
  uint64_t h[10];
  fe_mul_columns(h, f, g);
  carry_wide(out, h);
}

FE_FN void gsq(fe &out, const fe &f) {
  uint64_t h[10];
  fe_sq_columns(h, f);
  carry_wide(out, h);
}

// u - a - b, nearly carried
FE_FN void gsub2(fe &o, const fe &u, const fe &a, const fe &b) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t four_p = (i == 0) ? FE_4P_0 : ((i & 1) ? FE_4P_ODD : FE_4P_EVEN);
    h[i] = u.v[i] + four_p - a.v[i] - b.v[i];
  }
  carry_once(o, h);
}

// neg ? u - v : u + v, not carried: only ever a product's operand
FE_FN void gaddsub(fe &o, const fe &u, const fe &v, bool neg) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t two_p = (i == 0) ? FE_2P_0 : ((i & 1) ? FE_2P_ODD : FE_2P_EVEN);
    o.v[i] = u.v[i] + (neg ? two_p - v.v[i] : v.v[i]);
  }
}

// --- one thread a lane ---------------------------------------------------------

// dbl-2008-hwcd (a = -1) with the sums that feed only products left
// uncarried; r may alias p.
FE_FN void ge_dbl_lazy(ge &r, const ge &p) {
  fe a, b, c, s, xy, e, f, g, h, zero;
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = p.X.v[i] + p.Y.v[i];
  carry_once(xy, t);
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_sq(s, xy);
#pragma unroll
  for (int i = 0; i < 10; ++i) c.v[i] <<= 1;  // 2 Z^2, only subtracted
  fe_small(zero, 0);
  gsub2(e, s, a, b);      // E = (X+Y)^2 - A - B
  gsub2(f, b, a, c);      // F = G - C
  gaddsub(g, b, a, true);  // G = B - A
  gsub2(h, zero, a, b);   // H = -A - B
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// add-2008-hwcd-3 with q cached, the sums left uncarried (each feeds only
// a product); r may alias p.
FE_FN void ge_add_lazy(ge &r, const ge &p, const ge_cached &q) {
  fe t, a, b, c, d, e, f, g, h;
  gaddsub(t, p.Y, p.X, true);
  fe_mul(a, t, q.YminusX);
  gaddsub(t, p.Y, p.X, false);
  fe_mul(b, t, q.YplusX);
  fe_mul(c, p.T, q.T2d);
  fe_mul(d, p.Z, q.Z2);
  gaddsub(e, b, a, true);
  gaddsub(f, d, c, true);
  gaddsub(g, d, c, false);
  gaddsub(h, b, a, false);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// [s]B + [h](-A) by the first design's joint table (local memory) and
// 127 radix-4 steps, digits MSB first: bit pairs 252..0 of s and h.
// Inlined into its caller: as a call of its own its loop ran 7% slower.
__device__ __forceinline__ void straus_one(ge &acc, const ge &neg_a, const uint32_t sw[8],
                                        const uint32_t hw[8]) {
  fe d2;
  fe_const(d2, K_D2);

  // s_pts: identity, B, 2B, 3B; h_pts: -, -A, -2A, -3A
  ge s_pts[4], h_pts[4];
  ge_cached cq;
  ge_identity(s_pts[0]);
  fe_const(s_pts[1].X, K_BX);
  fe_const(s_pts[1].Y, K_BY);
  fe_one(s_pts[1].Z);
  fe_mul(s_pts[1].T, s_pts[1].X, s_pts[1].Y);
  ge_dbl_lazy(s_pts[2], s_pts[1]);
  ge_to_cached(cq, s_pts[1], d2);
  ge_add_lazy(s_pts[3], s_pts[2], cq);
  h_pts[1] = neg_a;
  ge_dbl_lazy(h_pts[2], neg_a);
  ge_to_cached(cq, neg_a, d2);
  ge_add_lazy(h_pts[3], h_pts[2], cq);

  // table[ds + 4 dh] = ds B + dh (-A), cached
  ge_cached table[TABLE_ENTRIES];
#pragma unroll 1
  for (int e = 0; e < TABLE_ENTRIES; ++e) {
    const int ds = e & 3, dh = e >> 2;
    ge pt;
    if (dh == 0) {
      pt = s_pts[ds];
    } else if (ds == 0) {
      pt = h_pts[dh];
    } else {
      ge_to_cached(cq, h_pts[dh], d2);
      ge_add_lazy(pt, s_pts[ds], cq);
    }
    ge_to_cached(table[e], pt, d2);
  }

  acc = s_pts[0];
#pragma unroll 1
  for (int bit = 2 * (NUM_DIGITS - 1); bit >= 0; bit -= 2) {
    ge_dbl_lazy(acc, acc);
    ge_dbl_lazy(acc, acc);
    const uint32_t ds = (sw[bit >> 5] >> (bit & 31)) & 3u;
    const uint32_t dh = (hw[bit >> 5] >> (bit & 31)) & 3u;
    ge_add_lazy(acc, acc, table[ds + 4 * dh]);
  }
}

// [s]B for the scalar's words (taken mod 2^254, the bits the joint loop
// reads) by the comb over B's tables btab (fe25519.cuh's layout,
// ed25519_batch.base_tables): 16 columns of one doubling and four table
// additions. One thread: the R warp's, beside the groups' loop.
__device__ __noinline__ void fixed_base(ge &acc, const uint32_t sw[8], const uint32_t *__restrict__ btab) {
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = sw[j];
  w[7] &= 0x3FFFFFFFu;
  ge_identity(acc);
#pragma unroll 1
  for (int step = 0; step < COMB_COLUMNS * COMB_SLICES; ++step) {
    const int c = COMB_COLUMNS - 1 - step / COMB_SLICES, u = step % COMB_SLICES;
    if (u == 0 && c < COMB_COLUMNS - 1) ge_dbl(acc, acc);
    ge_niels q;
    load_niels(q, btab + (u * SLICE_ENTRIES + comb_digit(w, u, c)) * ENTRY_WORDS);
    ge_madd(acc, acc, q);
  }
}

// --- G threads a lane ------------------------------------------------------------

struct group {
  int base;  // warp lane of the group's thread 0
  int t;     // this thread's place in the group: its slot 0 is coordinate t
};

// A point spread over the group: this thread's coordinates, t and (at
// G = 2) t + 2.
template <int G>
struct gpt {
  fe s[4 / G];
};

FE_FN void shfl_fe(fe &o, const fe &a, int src) {
#pragma unroll
  for (int i = 0; i < 10; ++i) o.v[i] = __shfl_sync(0xffffffffu, a.v[i], src);
}

// Coordinate k of p, in every thread of the group.
template <int G>
FE_FN void gather(fe &o, const gpt<G> &p, const group &g, int k) {
  shfl_fe(o, p.s[k / G], g.base + k % G);
}

// Doubling, round 1, coordinate c: X^2, Y^2, 2 Z^2, (X+Y)^2. 2 Z^2 is
// not carried (below 2^27 + 2^19 a limb): it is only ever subtracted.
FE_FN void dbl_square(fe &o, const fe &mine, const fe &xy, int c) {
  fe in;
  fe_sel(in, c == 3, xy, mine);
  gsq(o, in);
  const int sh = c == 2 ? 1 : 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) o.v[i] <<= sh;
}

// Doubling, round 2, coordinate c, from S = (X^2, Y^2, 2 Z^2, (X+Y)^2):
// with E = S3 - S0 - S1, F = S1 - S0 - S2, G = S1 - S0, H = -S0 - S1
// (a = -1), the coordinates E F, G H, F G, E H. Each operand is
// u - S0 - v.
FE_FN void dbl_product(fe &o, const fe S[4], int c) {
  fe zero, u, v, op1, op2;
  fe_small(zero, 0);
  fe_sel(u, c == 0 || c == 3, S[3], S[1]);
  fe_sel(v, c == 2, S[2], S[1]);
  fe_sel(v, c == 1, zero, v);
  gsub2(op1, u, S[0], v);
  fe_sel(u, (c & 1) != 0, zero, S[1]);
  fe_sel(v, c == 0, S[2], S[1]);
  fe_sel(v, c == 2, zero, v);
  gsub2(op2, u, S[0], v);
  gmul(o, op1, op2);
}

template <int G>
FE_FN void dbl_group(gpt<G> &p, const group &g) {
  fe x, y, xy;
  shfl_fe(x, p.s[0], g.base);
  shfl_fe(y, p.s[0], g.base + 1);
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = x.v[i] + y.v[i];
  carry_once(xy, h);
  gpt<G> q;
  dbl_square(q.s[0], p.s[0], xy, g.t);
  if constexpr (G == 2) dbl_square(q.s[1], p.s[1], xy, g.t + 2);
  fe S[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) gather<G>(S[k], q, g, k);
  dbl_product(p.s[0], S, g.t);
  if constexpr (G == 2) dbl_product(p.s[1], S, g.t + 2);
}

// A cached entry's coordinates by slot: Y - X, Y + X, 2 Z, 2 d T, so that
// round 1 of an addition multiplies coordinate c by (Y - X, Y + X, Z, T)[c].
// Each thread loads and stores only its own coordinates.
FE_FN void load_coord(fe &o, const uint32_t *e, int c) {
#pragma unroll
  for (int i = 0; i < 10; ++i) o.v[i] = e[10 * c + i];
}

FE_FN void store_coord(uint32_t *e, int c, const fe &a) {
#pragma unroll
  for (int i = 0; i < 10; ++i) e[10 * c + i] = a.v[i];
}

template <int G>
FE_FN void load_group(gpt<G> &q, const uint32_t *e, const group &g) {
  load_coord(q.s[0], e, g.t);
  if constexpr (G == 2) load_coord(q.s[1], e, g.t + 2);
}

// Addition, round 1, coordinate c: (Y - X)(Y2 - X2), (Y + X)(Y2 + X2),
// Z 2 Z2, T 2 d T2, with q coordinate c of the cached addend.
FE_FN void add_first(fe &o, const fe &mine, const fe &x, const fe &y, const fe &q, int c) {
  fe yx, op;
  gaddsub(yx, y, x, c == 0);
  fe_sel(op, c < 2, yx, mine);
  gmul(o, op, q);
}

// Addition, round 2, coordinate c, from S = (a, b, d, c') of round 1: with
// E = b - a, F = d - c', G = d + c', H = b + a, the coordinates E F, G H,
// F G, E H.
FE_FN void add_product(fe &o, const fe S[4], int c) {
  fe u, v, op1, op2;
  const bool ba1 = c == 0 || c == 3;
  fe_sel(u, ba1, S[1], S[2]);
  fe_sel(v, ba1, S[0], S[3]);
  gaddsub(op1, u, v, c != 1);
  const bool ba2 = (c & 1) != 0;
  fe_sel(u, ba2, S[1], S[2]);
  fe_sel(v, ba2, S[0], S[3]);
  gaddsub(op2, u, v, c == 0);
  gmul(o, op1, op2);
}

// p += q, a cached point spread as p is (complete on edwards25519,
// doublings included).
template <int G>
FE_FN void add_group(gpt<G> &p, const gpt<G> &q, const group &g) {
  fe x, y;
  shfl_fe(x, p.s[0], g.base);
  shfl_fe(y, p.s[0], g.base + 1);
  gpt<G> r;
  add_first(r.s[0], p.s[0], x, y, q.s[0], g.t);
  if constexpr (G == 2) add_first(r.s[1], p.s[1], x, y, q.s[1], g.t + 2);
  fe S[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) gather<G>(S[k], r, g, k);
  add_product(p.s[0], S, g.t);
  if constexpr (G == 2) add_product(p.s[1], S, g.t + 2);
}

// The cached form of p, coordinate c, into the entry at e.
FE_FN void cache_coord(uint32_t *e, const fe &mine, const fe &x, const fe &y, const fe &d2, int c) {
  fe yx, zz, op, m, one, r;
  gaddsub(yx, y, x, c == 0);
  gaddsub(zz, mine, mine, false);
  fe_sel(op, c == 2, zz, mine);
  fe_sel(op, c < 2, yx, op);
  fe_one(one);
  fe_sel(m, c == 3, d2, one);
  gmul(r, op, m);
  store_coord(e, c, r);
}

template <int G>
FE_FN void cache_group(uint32_t *e, const gpt<G> &p, const fe &d2, const group &g) {
  fe x, y;
  shfl_fe(x, p.s[0], g.base);
  shfl_fe(y, p.s[0], g.base + 1);
  cache_coord(e, p.s[0], x, y, d2, g.t);
  if constexpr (G == 2) cache_coord(e, p.s[1], x, y, d2, g.t + 2);
}

// Coordinate c of the point (x, y, 1, t).
FE_FN void affine_coord(fe &o, const fe &x, const fe &y, const fe &t, int c) {
  fe one;
  fe_one(one);
  fe_sel(o, c == 2, one, t);
  fe_sel(o, c == 1, y, o);
  fe_sel(o, c == 0, x, o);
}

template <int G>
FE_FN void affine_group(gpt<G> &p, const fe &x, const fe &y, const fe &t, const group &g) {
  affine_coord(p.s[0], x, y, t, g.t);
  if constexpr (G == 2) affine_coord(p.s[1], x, y, t, g.t + 2);
}

template <int G>
FE_FN void identity_group(gpt<G> &p, const group &g) {
  fe_small(p.s[0], (g.t == 1 || g.t == 2) ? 1u : 0u);
  if constexpr (G == 2) fe_small(p.s[1], g.t + 2 == 2 ? 1u : 0u);
}

// [h](-A) from -A = (nx, y) affine, by the group g, into this thread's
// coordinates out[0..4/G): a table of j (-A), j = 0..15, in tab (the
// lane's TABLE_WORDS words of shared memory), then (h taken from hw, or,
// when h_shared, from shared memory after barrier 1) 64 steps of four
// doublings and one addition over h's 4-bit windows (h taken mod 2^254,
// the bits the joint loop reads), most significant first, as one flat
// loop of 320 phases (one doubling's code, not four). Each window's entry
// is loaded before its doublings.
template <int G>
__device__ __noinline__ void variable_base(fe out[2], const fe &nx, const fe &y, const uint32_t *hw,
                                           bool h_shared, uint32_t *tab, group g) {
  fe d2, t;
  fe_const(d2, K_D2);

  // entry 0 the identity, entry 1 -A, entry j entry j - 1 plus -A
  gpt<G> p, q;
  identity_group(p, g);
  cache_group(tab, p, d2, g);
  gmul(t, nx, y);
  affine_group(p, nx, y, t, g);
  cache_group(tab + 4 * 10, p, d2, g);
  load_group(q, tab + 4 * 10, g);
#pragma unroll 1
  for (int e = 2; e < TABLE_ENTRIES; ++e) {
    add_group(p, q, g);
    cache_group(tab + e * 4 * 10, p, d2, g);
  }

  if (h_shared) h_wait();
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = hw[j];
  w[7] &= 0x3FFFFFFFu;
  identity_group(p, g);
#pragma unroll 1
  for (int i = 0; i < 64 * 5; ++i) {  // one flat loop: phases 0..3 double, 4 adds
    const int bit = 252 - 4 * (i / 5), phase = i % 5;
    if (phase == 0) load_group(q, tab + ((w[bit >> 5] >> (bit & 31)) & 15u) * 4 * 10, g);
    if (phase < 4) {
      dbl_group(p, g);
    } else {
      add_group(p, q, g);
    }
  }
  out[0] = p.s[0];
  if constexpr (G == 2) out[1] = p.s[1];
}

// The group's [h](-A) (this thread's coordinates in part[0..4/G)) plus
// [s]B, cached at e in the group's layout; X, Y and Z of the sum (nearly
// carried) in every thread of the group.
template <int G>
__device__ __noinline__ void finish_group(fe &X, fe &Y, fe &Z, const fe part[2], const uint32_t *e, group g) {
  gpt<G> p, q;
  p.s[0] = part[0];
  if constexpr (G == 2) p.s[1] = part[1];
  load_group(q, e, g);
  add_group(p, q, g);
  gather<G>(X, p, g, 0);
  gather<G>(Y, p, g, 1);
  gather<G>(Z, p, g, 2);
}

// [s]B cached into the group's layout at e, from one thread.
FE_FN void cache_one(uint32_t *e, const ge &p) {
  fe d2, v;
  fe_const(d2, K_D2);
  fe_sub(v, p.Y, p.X);
  store_coord(e, 0, v);
  fe_add(v, p.Y, p.X);
  store_coord(e, 1, v);
  fe_add(v, p.Z, p.Z);
  store_coord(e, 2, v);
  fe_mul(v, p.T, d2);
  store_coord(e, 3, v);
}

// The group of lane role r at G = 2 or 4.
FE_FN group group_of(const lane_role &r, int G) {
  group g;
  g.base = (r.g * G) & 31;
  g.t = r.t;
  return g;
}

FE_FN void variable_base_g(fe part[2], const fe &nx, const fe &y, const uint32_t *hw, bool h_shared,
                           uint32_t *tables, const lane_role &r, int G) {
  if (G == 2) {
    variable_base<2>(part, nx, y, hw, h_shared, tables + r.g * TABLE_WORDS, group_of(r, G));
  } else {
    variable_base<4>(part, nx, y, hw, h_shared, tables + r.g * TABLE_WORDS, group_of(r, G));
  }
}

FE_FN void finish_group_g(fe &X, fe &Y, fe &Z, const fe part[2], const uint32_t *e, const lane_role &r, int G) {
  if (G == 2) {
    finish_group<2>(X, Y, Z, part, e, group_of(r, G));
  } else {
    finish_group<4>(X, Y, Z, part, e, group_of(r, G));
  }
}

