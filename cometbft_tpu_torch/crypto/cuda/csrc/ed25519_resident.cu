// Ed25519 verification against a resident validator set: the per-key comb
// tables (ed25519_key_tables, built once when a set is uploaded) and the
// verify kernel that reads them (ed25519_verify_resident).
//
// ed25519_verify_resident replaces cometbft_tpu/crypto/tpu/
// ed25519_batch.py::_verify_core_resident (:805) and _verify_core_indexed
// (:395): A from the key store, row b for lane b (the resident commit,
// idx null) or row idx[b] (the indexed flush), and u8[96, B] rows R, S,
// h (byte-major: row r of lane b at r * B + b). Every index is
// bounds-checked: a row outside [0, N) rejects the lane and is never
// read. ed25519_key_tables replaces no reference program: the reference
// decompresses A and builds its table in every call; the port does that
// once a validator set.
//
// What bounded the first design (one thread a signature): latency.
// At a commit (B = 180) the launch filled 2 of 132 SMs, one warp a
// scheduler, and each lane ran about 0.96 M dependent 32-bit integer
// instructions: decompress A (fe_pow_p58), build a 16-entry table in
// local memory, 127 radix-4 steps of two doublings and one addition, and
// an inversion to encode. What the design does about it:
//
// * The key store keeps, beside each key's 32 bytes, comb tables of -A
//   (KEY_WORDS words a key, 8,320 bytes): for slice t in 0..3 and j in
//   0..15, T_t[j] = sum_i j_i 2^(64 i + 16 t) (-A) in affine Niels form
//   (y+x, y-x, 2d x y), canonical limbs, and a validity flag. A is
//   decompressed once a set (reference semantics, ed25519_batch.py:33-42:
//   y taken mod p, -0 decodes as 0; a key that does not decompress gets
//   flag 0 and identity entries, and all its lanes reject). The base point
//   has the same tables, built by the same kernel from -B's encoding and
//   kept in device memory (read through the L1 cache; not __constant__,
//   whose cache serializes reads that differ across a warp).
// * [s]B + [h](-A) = sum over columns c of 2^c (sum_t T^B_t[s digit] +
//   T^A_t[h digit]), where digit (t, c) of a scalar is bits 64 i + 16 t + c,
//   i = 0..3: 16 columns, one doubling each, two table additions (7
//   products, ge_madd) for each slice, no table to build a call. A group
//   of G threads in one warp verifies one lane, thread t taking slices
//   t, t + G, ...; the G partial sums meet in log2 G complete additions
//   over __shfl_xor_sync. G = 4 at a commit (16 columns of one doubling
//   and two additions a thread, about 0.1 M instructions), G = 2 at a
//   16,384-lane window (build.group_size: splitting adds only 15
//   doublings a thread, and two warps a scheduler hide latency).
// * No inversion: one more warp of the block decompresses the block's 32
//   R values while the loop runs, and the loop threads compare in
//   projective form. encode(P) equals R's bytes exactly when R's y (its
//   low 255 bits) is below p, R decompresses, R is not x = 0 with the sign
//   bit set, and X = x_R Z and Y = y_R Z.
//
// What bounds it now: at a commit, still the latency of one thread's
// chain (the loop and the combine), about a ninth of the first design's;
// at a window, integer operations, about 0.36 M a lane at G = 1 against
// 0.96 M (chip_smoke.py counts them). The key table kernel is bounded by
// its longest chain of doublings (240, to 2^240 (-A)), once a set.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

#define LANES_PER_BLOCK 32
#define MAX_GROUP 4

// n doublings, T computed only by the last (n >= 1).
__device__ __forceinline__ void ge_dbl_n(ge &p, int n) {
#pragma unroll 1
  for (int k = 1; k < n; ++k) ge_dbl_xyz(p, p);
  ge_dbl(p, p);
}

// --- ed25519_key_tables: one thread a (key, slice) ----------------------------

__global__ void __launch_bounds__(128)
ed25519_key_tables_kernel(const uint8_t *__restrict__ keys, int n,
                          uint32_t *__restrict__ out) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n * COMB_SLICES) return;
  const int key = gid / COMB_SLICES, t = gid % COMB_SLICES;

  uint32_t aw[8];
  const uint8_t *p8 = keys + (size_t)key * 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    aw[j] = (uint32_t)p8[4 * j] | ((uint32_t)p8[4 * j + 1] << 8) |
            ((uint32_t)p8[4 * j + 2] << 16) | ((uint32_t)p8[4 * j + 3] << 24);
  fe d2;
  fe_const(d2, K_D2);

  // -A = (-x, y, 1, -x y)
  ge p;
  fe_from_words(p.Y, aw);
  fe x;
  const bool ok = decompress(x, p.Y, aw[7] >> 31);
  fe_neg(p.X, x);
  fe_one(p.Z);
  fe_mul(p.T, p.X, p.Y);

  // base[i] = 2^(64 i + 16 t) (-A)
  ge base[4];
  if (t > 0) ge_dbl_n(p, 16 * t);
  base[0] = p;
#pragma unroll 1
  for (int i = 1; i < 4; ++i) {
    ge_dbl_n(p, 64);
    base[i] = p;
  }

  // ent[j] = sum_i j_i base[i]
  ge ent[SLICE_ENTRIES];
  ge_identity(ent[0]);
#pragma unroll 1
  for (int j = 1; j < SLICE_ENTRIES; ++j) {
    const int low = __ffs(j) - 1;
    if (j == (1 << low)) {
      ent[j] = base[low];
    } else {
      ge_add(ent[j], ent[j & (j - 1)], base[low], d2);
    }
  }

  // affine by one inversion (Montgomery's trick), then Niels, canonical
  fe pre[SLICE_ENTRIES];
  pre[0] = ent[0].Z;
#pragma unroll 1
  for (int j = 1; j < SLICE_ENTRIES; ++j) fe_mul(pre[j], pre[j - 1], ent[j].Z);
  fe inv;
  fe_invert(inv, pre[SLICE_ENTRIES - 1]);
  uint32_t *dst = out + (size_t)key * KEY_WORDS + (size_t)t * SLICE_ENTRIES * ENTRY_WORDS;
#pragma unroll 1
  for (int j = SLICE_ENTRIES - 1; j >= 0; --j) {
    fe zi, ax, ay, v[3];
    if (j > 0) {
      fe_mul(zi, inv, pre[j - 1]);
      fe_mul(inv, inv, ent[j].Z);
    } else {
      zi = inv;
    }
    fe_mul(ax, ent[j].X, zi);
    fe_mul(ay, ent[j].Y, zi);
    fe_add(v[0], ay, ax);
    fe_sub(v[1], ay, ax);
    fe_mul(v[2], ax, ay);
    fe_mul(v[2], v[2], d2);
    if (!ok) {  // identity entries for a key that does not decompress
      fe_one(v[0]);
      fe_one(v[1]);
      fe_zero(v[2]);
    }
    uint32_t *e = dst + j * ENTRY_WORDS;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fe c;
      fe_canonical(c, v[k]);
#pragma unroll
      for (int i = 0; i < 10; ++i) e[10 * k + i] = c.v[i];
    }
    e[30] = 0;
    e[31] = 0;
  }
  if (t == 0) {
    uint32_t *flag = out + (size_t)key * KEY_WORDS + FLAG_ROW * ENTRY_WORDS;
    flag[0] = ok ? 1u : 0u;
#pragma unroll 1
    for (int k = 1; k < ENTRY_WORDS; ++k) flag[k] = 0;
  }
}

// --- ed25519_verify_resident: G threads a lane, one warp for R ---------------

__device__ __forceinline__ void shfl_fe(fe &o, const fe &a, int mask) {
#pragma unroll
  for (int i = 0; i < 10; ++i) o.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], mask);
}

// Block: LANES_PER_BLOCK lanes; warps 0..G-1 run the comb (thread
// g * G + t is slice thread t of lane g), warp G decompresses R. The comb
// is one loop over (column, slice) steps: a loop over a thread's slices
// nested in the column loop (its trip count known only at run time, or
// unrolled by a template) around the inlined point code crashes the CUDA
// compiler's front end (cicc).
__global__ void __launch_bounds__(LANES_PER_BLOCK *(MAX_GROUP + 1))
ed25519_verify_resident_kernel(const uint32_t *__restrict__ keys, int N,
                               const int32_t *__restrict__ idx,
                               const uint8_t *__restrict__ rsh,
                               const uint32_t *__restrict__ base,
                               uint8_t *__restrict__ out, int B, int G) {
  __shared__ uint32_t s_words[LANES_PER_BLOCK][16];  // s, then h
  __shared__ uint32_t s_rx[LANES_PER_BLOCK][10], s_ry[LANES_PER_BLOCK][10];
  __shared__ uint32_t s_rok[LANES_PER_BLOCK];

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * LANES_PER_BLOCK;
  const bool r_warp = (tid >> 5) == G;
  const int g = r_warp ? tid - 32 * G : tid / G;
  const int t = r_warp ? 0 : tid % G;
  const int b = lane0 + g;
  const bool live = b < B;

  ge acc;
  bool have = false, flag = false;
  if (r_warp) {
    bool ok = false;
    fe xc, yc;
    fe_zero(xc);
    fe_zero(yc);
    if (live) {
      uint32_t rw[8];
      load_words(rw, rsh, 0, B, b);
      ok = decode_r(xc, yc, rw);
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      s_rx[g][i] = xc.v[i];
      s_ry[g][i] = yc.v[i];
    }
    s_rok[g] = ok ? 1u : 0u;
  } else {
    // s and h words into shared memory, thread t taking words t, t + G, ...
    for (int w = t; w < 16; w += G) {
      uint32_t v = 0;
      if (live) {
        const uint8_t *p = rsh + (size_t)(32 + 4 * w) * B + b;
        v = (uint32_t)p[0] | ((uint32_t)p[(size_t)B] << 8) |
            ((uint32_t)p[2 * (size_t)B] << 16) | ((uint32_t)p[3 * (size_t)B] << 24);
      }
      s_words[g][w] = v;
    }
    __syncwarp();
    int row = 0;
    if (live) {
      row = idx != nullptr ? idx[b] : b;
      have = row >= 0 && row < N;
    }
    // a lane without a key runs against B's tables and rejects
    const uint32_t *kt = have ? keys + (size_t)row * KEY_WORDS : base;
    flag = have && kt[FLAG_ROW * ENTRY_WORDS] != 0;

    ge_identity(acc);
    const int nslices = COMB_SLICES / G;
#pragma unroll 1
    for (int step = 0; step < COMB_COLUMNS * nslices; ++step) {
      const int c = COMB_COLUMNS - 1 - step / nslices, u = t + (step % nslices) * G;
      if (step % nslices == 0 && c < COMB_COLUMNS - 1) ge_dbl(acc, acc);
      ge_niels q;
      load_niels(q, base + (u * SLICE_ENTRIES + comb_digit(s_words[g], u, c)) * ENTRY_WORDS);
      ge_madd(acc, acc, q);
      load_niels(q, kt + (u * SLICE_ENTRIES + comb_digit(s_words[g] + 8, u, c)) * ENTRY_WORDS);
      ge_madd(acc, acc, q);
    }
    fe d2;
    fe_const(d2, K_D2);
#pragma unroll 1
    for (int m = 1; m < G; m <<= 1) {
      ge o;
      shfl_fe(o.X, acc.X, m);
      shfl_fe(o.Y, acc.Y, m);
      shfl_fe(o.Z, acc.Z, m);
      shfl_fe(o.T, acc.T, m);
      ge_add(acc, acc, o, d2);
    }
  }
  __syncthreads();
  if (!r_warp && t == 0 && live) {
    fe r, rz;
    bool same = flag && s_rok[g] != 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) r.v[i] = s_rx[g][i];
    fe_mul(rz, r, acc.Z);
    same &= fe_eq(acc.X, rz);
#pragma unroll
    for (int i = 0; i < 10; ++i) r.v[i] = s_ry[g][i];
    fe_mul(rz, r, acc.Z);
    same &= fe_eq(acc.Y, rz);
    out[b] = same ? 1 : 0;
  }
}

extern "C" int cbt_ed25519_key_tables(const void *keys, int n, void *out,
                                      void *stream) {
  const int threads = 128;
  const int blocks = (n * COMB_SLICES + threads - 1) / threads;
  ed25519_key_tables_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)keys, n, (uint32_t *)out);
  return (int)cudaGetLastError();
}

extern "C" int cbt_ed25519_verify_resident(const void *keys, int N,
                                           const void *idx, const void *rsh,
                                           const void *base, void *out, int B,
                                           int G, void *stream) {
  if (G != 1 && G != 2 && G != 4) return (int)cudaErrorInvalidValue;
  const int blocks = (B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  ed25519_verify_resident_kernel<<<blocks, LANES_PER_BLOCK * (G + 1), 0,
                                   (cudaStream_t)stream>>>(
      (const uint32_t *)keys, N, (const int32_t *)idx, (const uint8_t *)rsh,
      (const uint32_t *)base, (uint8_t *)out, B, G);
  return (int)cudaGetLastError();
}
