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
// 0.96 M (chip_smoke.py counts them).
//
// ed25519_key_tables, once a set, is bounded by the latency of one key's
// dependent chain: decompress A (fe_pow_p58), 240 doublings to
// 2^240 (-A), an inversion to take the 60 entries to affine form. Its
// first design ran one thread a (key, slice): each decompressed A and
// doubled 16 t + 192 times with its own inversion, about 2,400 dependent
// products for the last slice. This one runs the chain once a key:
//
// * A block holds KT_KEYS keys. Warp 0 holds their chains, a group of four
//   threads a key (ge25519_group.cuh's dbl_group<4>: thread t holds point
//   coordinate t, a doubling is one squaring and one product a thread).
//   The group decompresses A (every thread of it, alike), then doubles
//   -A 240 times; after doubling 16 k it stores base k = 2^(16 k) (-A),
//   slice k % 4's entry 2^(k / 4), in shared memory and, for k >= 4,
//   arrives at named barrier k - 3 without waiting.
// * KT_HELPERS threads a key (warps 1 and 2) build the other entries as
//   their bases arrive: base k completes entries 2^i + r = r + 2^i of
//   slice t (k = 4 i + t, r = 1 .. 2^i - 1), one complete addition each,
//   helper r - 1 taking entry r + 2^i. Slice 3's last base comes with the
//   last doubling; what is left after the chain is one addition.
// * One inversion a key, its product tree across the helpers: helper h
//   keeps the prefix products of the Z of its 6 or 7 early entries (every
//   entry but slice 3's last eight, ready once base 14's additions are
//   done, while the chain still doubles) and then of its late entry (slice
//   3's entry 9 + h, the one it adds last; base 15 itself for helper 7).
//   After the chain each helper forms the product of the other helpers'
//   totals, helper 0 inverts the key's product, and each helper walks its
//   prefixes back (two products an entry) to each entry's 1/Z, then takes
//   the entry to affine Niels form and canonical limbs.
//
// The longest chain: about 255 products to decompress, 240 doublings of
// two, one addition, 8 products and the inversion's 265, then one entry's
// walk and conversion: about 1,050 dependent products a key, against
// about 2,400.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "ge25519_group.cuh"

#define LANES_PER_BLOCK 32
#define MAX_GROUP 4

// --- ed25519_key_tables: one doubling chain a key --------------------------

#define KT_KEYS 8                             // keys a block
#define KT_HELPERS 8                          // entry threads a key
#define KT_THREADS (KT_KEYS * (4 + KT_HELPERS))  // 96: warp 0 the chains, warps 1-2 the helpers
#define KT_SLOTS (COMB_SLICES * SLICE_ENTRIES)  // 64: slot 16 t + j is slice t's entry j
#define KT_SLOT_WORDS 40                      // X, Y, Z, T, ten limbs each
#define KT_PRE 8                              // prefix products a helper keeps
#define KT_EARLY 52                           // entries ready before the last base
#define KT_KEY_WORDS (KT_SLOTS * KT_SLOT_WORDS + KT_HELPERS * KT_PRE * 10 + 10 + 1)
#define KT_SMEM (KT_KEYS * KT_KEY_WORDS * 4)  // dynamic shared memory: 102,752 bytes
#define KT_MAX_DEVICES 64

// Named barrier id (1..15; 0 is __syncthreads) of count threads: producers
// arrive and go on, consumers wait for all of them.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Slot of base k = 2^(16 k) (-A): slice k % 4, entry 2^(k / 4).
__device__ __forceinline__ int base_slot(int k) { return 16 * (k & 3) + (1 << (k >> 2)); }

// Early entry q (0..51) of a key: the slots but the identities (j = 0) and
// slice 3's last eight.
__device__ __forceinline__ int early_slot(int q) { return q + 1 + q / 15; }

// Helper h's early entries: q = h + KT_HELPERS u below KT_EARLY (7 or 6).
__device__ __forceinline__ int early_count(int h) { return (KT_EARLY - h + KT_HELPERS - 1) / KT_HELPERS; }

// Helper h's late entry: slice 3's entry 9 + h, which it adds after the
// last doubling; helper 7's is base 15 itself.
__device__ __forceinline__ int late_slot(int h) { return h < 7 ? 57 + h : 56; }

// Helper h's share of base k's additions: entry 2^i + r = entry r + base k
// of slice t (k = 4 i + t, r = h + 1 < 2^i).
__device__ __noinline__ void helper_add(uint32_t *ent, int k, int h) {
  const int i = k >> 2, t = k & 3, r = h + 1;
  if (r >= (1 << i)) return;
  ge a, b, c;
  const uint32_t *pa = ent + (16 * t + r) * KT_SLOT_WORDS, *pb = ent + base_slot(k) * KT_SLOT_WORDS;
  load_coord(a.X, pa, 0);
  load_coord(a.Y, pa, 1);
  load_coord(a.Z, pa, 2);
  load_coord(a.T, pa, 3);
  load_coord(b.X, pb, 0);
  load_coord(b.Y, pb, 1);
  load_coord(b.Z, pb, 2);
  load_coord(b.T, pb, 3);
  fe d2;
  fe_const(d2, K_D2);
  ge_add(c, a, b, d2);
  uint32_t *pc = ent + (16 * t + (1 << i) + r) * KT_SLOT_WORDS;
  store_coord(pc, 0, c.X);
  store_coord(pc, 1, c.Y);
  store_coord(pc, 2, c.Z);
  store_coord(pc, 3, c.T);
}

// Row e of a key's tables: (X : Y : Z) with 1/Z = zi in affine Niels form
// and canonical limbs, or the identity when the key does not decompress.
__device__ __forceinline__ void store_entry(uint32_t *row, const uint32_t *slot, const fe &zi, bool ok) {
  fe X, Y, ax, ay, v[3];
  load_coord(X, slot, 0);
  load_coord(Y, slot, 1);
  fe_mul(ax, X, zi);
  fe_mul(ay, Y, zi);
  fe_add(v[0], ay, ax);
  fe_sub(v[1], ay, ax);
  fe d2;
  fe_const(d2, K_D2);
  fe_mul(v[2], ax, ay);
  fe_mul(v[2], v[2], d2);
  if (!ok) {
    fe_one(v[0]);
    fe_one(v[1]);
    fe_zero(v[2]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    fe c;
    fe_canonical(c, v[k]);
#pragma unroll
    for (int i = 0; i < 10; ++i) row[10 * k + i] = c.v[i];
  }
  row[30] = 0;
  row[31] = 0;
}

__global__ void __launch_bounds__(KT_THREADS)
ed25519_key_tables_kernel(const uint8_t *__restrict__ keys, int n, uint32_t *__restrict__ out) {
  extern __shared__ uint32_t s_kt[];
  const int tid = threadIdx.x;
  const bool chain = tid < 32;
  const int kk = chain ? tid / 4 : (tid - 32) / KT_HELPERS;  // the block's key
  const int key = blockIdx.x * KT_KEYS + kk;
  const bool live = key < n;
  uint32_t *ent = s_kt + kk * KT_KEY_WORDS;
  uint32_t *pre = ent + KT_SLOTS * KT_SLOT_WORDS;  // [helper][KT_PRE][10]
  uint32_t *inv_w = pre + KT_HELPERS * KT_PRE * 10;
  uint32_t *ok_w = inv_w + 10;
  uint32_t *rows = out + (size_t)key * KEY_WORDS;

  if (chain) {
    group g;
    g.base = tid & ~3;
    g.t = tid & 3;
    uint32_t aw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      aw[j] = 0;
      if (live) {
        const uint8_t *p8 = keys + (size_t)key * 32 + 4 * j;
        aw[j] = (uint32_t)p8[0] | ((uint32_t)p8[1] << 8) | ((uint32_t)p8[2] << 16) | ((uint32_t)p8[3] << 24);
      }
    }
    fe y, x, nx, t;
    fe_from_words(y, aw);
    const bool ok = decompress(x, y, aw[7] >> 31);
    if (g.t == 0) *ok_w = ok ? 1u : 0u;
    if (live) {  // slice t's identity entry; thread 0 the flag row
      uint32_t *e = rows + 16 * g.t * ENTRY_WORDS;
#pragma unroll 1
      for (int w = 0; w < ENTRY_WORDS; ++w) e[w] = (w == 0 || w == 10) ? 1u : 0u;
      if (g.t == 0) {
        uint32_t *flag = rows + FLAG_ROW * ENTRY_WORDS;
#pragma unroll 1
        for (int w = 0; w < ENTRY_WORDS; ++w) flag[w] = (w == 0 && ok) ? 1u : 0u;
      }
    }
    // -A = (-x, y, 1, -x y); base 0
    fe_neg(nx, x);
    fe_mul(t, nx, y);
    gpt<4> p;
    affine_group(p, nx, y, t, g);
    store_coord(ent + base_slot(0) * KT_SLOT_WORDS, g.t, p.s[0]);
#pragma unroll 1
    for (int d = 1; d <= 240; ++d) {
      dbl_group<4>(p, g);
      if ((d & 15) == 0) {
        const int k = d >> 4;
        store_coord(ent + base_slot(k) * KT_SLOT_WORDS, g.t, p.s[0]);
        if (k >= 4) named_arrive(k - 3, KT_THREADS);
      }
    }
    __syncthreads();  // the helpers' products
    __syncthreads();  // the key's inverse
    return;
  }

  const int h = (tid - 32) % KT_HELPERS;
  uint32_t *my_pre = pre + h * KT_PRE * 10;
  // bases 4..14: their additions as they arrive
#pragma unroll 1
  for (int k = 4; k < 15; ++k) {
    named_sync(k - 3, KT_THREADS);
    helper_add(ent, k, h);
  }
  named_sync(13, KT_KEYS * KT_HELPERS);  // every early entry is in place
  const int m = early_count(h);
  fe acc, z;
#pragma unroll 1
  for (int u = 0; u < m; ++u) {
    load_coord(z, ent + early_slot(h + KT_HELPERS * u) * KT_SLOT_WORDS, 2);
    if (u == 0) {
      acc = z;
    } else {
      fe_mul(acc, acc, z);
    }
    store_coord(my_pre, u, acc);
  }
  // base 15, the last doubling's: the late entries
  named_sync(12, KT_THREADS);
  helper_add(ent, 15, h);
  load_coord(z, ent + late_slot(h) * KT_SLOT_WORDS, 2);
  fe_mul(acc, acc, z);
  store_coord(my_pre, m, acc);
  __syncthreads();

  // o = the product of the other helpers' totals; helper 0 inverts the key's
  fe o;
  bool first = true;
#pragma unroll 1
  for (int q = 0; q < KT_HELPERS; ++q) {
    if (q == h) continue;
    load_coord(z, pre + q * KT_PRE * 10, early_count(q));
    if (first) {
      o = z;
    } else {
      fe_mul(o, o, z);
    }
    first = false;
  }
  if (h == 0) {
    fe all, inv;
    fe_mul(all, acc, o);
    fe_invert(inv, all);
    store_coord(inv_w, 0, inv);
  }
  __syncthreads();

  // walk the prefixes back: cur = 1 / (the product up to entry u)
  fe cur, zi;
  load_coord(cur, inv_w, 0);
  fe_mul(cur, cur, o);
  const bool ok = *ok_w != 0;
#pragma unroll 1
  for (int u = m; u >= 0; --u) {
    const int slot = u == m ? late_slot(h) : early_slot(h + KT_HELPERS * u);
    if (u > 0) {
      load_coord(z, my_pre, u - 1);
      fe_mul(zi, cur, z);
      load_coord(z, ent + slot * KT_SLOT_WORDS, 2);
      fe_mul(cur, cur, z);
    } else {
      zi = cur;
    }
    if (live) store_entry(rows + slot * ENTRY_WORDS, ent + slot * KT_SLOT_WORDS, zi, ok);
  }
}

// --- ed25519_verify_resident: G threads a lane, one warp for R ---------------

__device__ __forceinline__ void shfl_xor_fe(fe &o, const fe &a, int mask) {
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
      shfl_xor_fe(o.X, acc.X, m);
      shfl_xor_fe(o.Y, acc.Y, m);
      shfl_xor_fe(o.Z, acc.Z, m);
      shfl_xor_fe(o.T, acc.T, m);
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
  // the shared memory above 48 KB, allowed once a device
  static bool smem_allowed[KT_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= KT_MAX_DEVICES || !smem_allowed[dev]) {
    e = cudaFuncSetAttribute(ed25519_key_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KT_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < KT_MAX_DEVICES) smem_allowed[dev] = true;
  }
  const int blocks = (n + KT_KEYS - 1) / KT_KEYS;
  ed25519_key_tables_kernel<<<blocks, KT_THREADS, KT_SMEM, (cudaStream_t)stream>>>(
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
