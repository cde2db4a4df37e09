"""Batched secp256k1 ECDSA verification on the card: host packing, the
plain torch verifier, and the wrapper around the hand-written CUDA kernel.

Reference: cometbft_tpu/crypto/tpu/secp256k1_batch.py. Its device program
``_verify_core`` (``verify_kernel`` :198, ``_verify_math`` :201) maps
u32[32, B] little-endian words of qx, r, u1 and u2 plus int32[B] flags
(bit 0 the key prefix's parity, bit 1 r + n < p) to bool[B]. The port
ships the same 128 bytes a lane as u8[128, B], byte-major like the
Ed25519 compact wire (row k of lane b is byte k of its record: rows 0:32
qx, 32:64 r, 64:96 u1, 96:128 u2); viewed as little-endian u32 rows it is
the reference's wire word for word. The host packing below is the
reference's ``prepare_batch`` (:259): the structural checks of the CPU
verifier, e = SHA-256(msg) mod n with hashlib, w = s⁻¹ mod n with
``pow``, u1 = e·w and u2 = r·w.

The CUDA kernel (``csrc/secp256k1_verify.cu``) replaces that jitted XLA
program with a group of G threads a signature (``build.group_size``):
decompress Q; reduce u2 mod n and split it by the GLV endomorphism,
u2 ≡ k1 + k2·λ (mod n) with |k1|, |k2| < 2^128 (``glv_split``); cut u1
into two 128-bit halves; sum the four terms |k1|·(±Q), |k2|·(±λQ),
u1_lo·G and u1_hi·2^128·G over 33 signed radix-16 windows (tables of 0..8
times each point; λQ = (β·x, y); the tables of G and 2^128·G are
constants), the group's partial sums meeting by shuffles; and accept iff
Z ≠ 0 and X ≡ r·Z, or bit 1 is set and X ≡ (r + n)·Z (mod p): x = X/Z
equals r or r + n without an inversion. Points are homogeneous (X:Y:Z)
with the complete Renes–Costello–Batina formulas for a = 0 (b3 = 21),
Algorithm 7 to add (reference ``point_add`` :60) and Algorithm 9 to
double; they cover the identity (0:1:0), inverses and doubling alike, so
partial sums that are equal, opposite or zero need no branch.
``verify_plain`` below is the same decomposition and the same terms in
torch ops over the batch (one chain for the four terms, the kernel's
G = 1 order): what a CPU tensor runs, and what the kernel is held
against on the card.

Semantics (reference :19-31): sig r ‖ s big-endian with r, s in [1, n)
and s <= n/2; a 33-byte key with prefix 2 or 3 and x < p (all on the
host, the ``valid`` mask); y recovered on the card, a failed
decompression rejects; the point at infinity rejects.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from cometbft_tpu_torch.crypto import secp256k1 as host
from cometbft_tpu_torch.crypto.cuda import build, mesh, secp_field as fe
from cometbft_tpu_torch.crypto.cuda.ed25519_batch import _words
from cometbft_tpu_torch.crypto.cuda.secp_field import N, P

WIRE_ROWS = 128
MAX_CHUNK = 4096  # the reference's _MAX_CHUNK; CBFT_TPU_MAX_CHUNK overrides
GROUP_THREADS_PER_SM = 128  # the kernel's budget for build.group_size

LAUNCHES = 0  # secp256k1_verify launches (the plain version does not count)


# --- host packing (reference :259) -------------------------------------------


def prepare_batch(
    pub_keys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (wire u8[128, B], flags int32[B], valid bool[B]). A lane that
    fails a structural check (lengths, prefix, x < p, r and s in [1, n),
    low S) is zero-filled with flags 0 and valid False, as the
    reference's is."""
    n = len(pub_keys)
    valid = np.ones(n, bool)
    flags = np.zeros(n, np.int32)
    rows = []
    blank = bytes(WIRE_ROWS)
    for i in range(n):
        pk, sig = bytes(pub_keys[i]), bytes(sigs[i])
        if len(pk) != 33 or pk[0] not in (2, 3) or len(sig) != 64:
            valid[i] = False
            rows.append(blank)
            continue
        x = int.from_bytes(pk[1:], "big")
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if x >= P or not (1 <= r < N) or not (1 <= s < N) or s > N // 2:
            valid[i] = False
            rows.append(blank)
            continue
        e = int.from_bytes(hashlib.sha256(bytes(msgs[i])).digest(), "big") % N
        w = pow(s, -1, N)
        rows.append(
            pk[:0:-1] + sig[31::-1]
            + (e * w % N).to_bytes(32, "little") + (r * w % N).to_bytes(32, "little")
        )
        flags[i] = (pk[0] & 1) | (2 if r + N < P else 0)
    wire = np.frombuffer(b"".join(rows), np.uint8).reshape(n, WIRE_ROWS).T.copy()
    return wire, flags, valid


# --- point layer, homogeneous (X:Y:Z), a = 0 ----------------------------------

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def point_add(p: Point, q: Point) -> Point:
    """Renes–Costello–Batina 2015 Algorithm 7 (a = 0): complete."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = fe.mul(x1, x2)
    t1 = fe.mul(y1, y2)
    t2 = fe.mul(z1, z2)
    t3 = fe.sub(fe.mul(fe.add(x1, y1), fe.add(x2, y2)), fe.add(t0, t1))
    t4 = fe.sub(fe.mul(fe.add(y1, z1), fe.add(y2, z2)), fe.add(t1, t2))
    y3 = fe.sub(fe.mul(fe.add(x1, z1), fe.add(x2, z2)), fe.add(t0, t2))
    x3 = fe.add(fe.add(t0, t0), t0)
    t2 = fe.mul_small(t2, fe.B3)
    z3 = fe.add(t1, t2)
    t1 = fe.sub(t1, t2)
    y3 = fe.mul_small(y3, fe.B3)
    return (
        fe.sub(fe.mul(t3, t1), fe.mul(t4, y3)),
        fe.add(fe.mul(y3, x3), fe.mul(t1, z3)),
        fe.add(fe.mul(z3, t4), fe.mul(x3, t3)),
    )


def point_dbl(p: Point) -> Point:
    """Renes–Costello–Batina 2015 Algorithm 9 (a = 0): complete."""
    x, y, z = p
    t0 = fe.sq(y)
    z3 = fe.add(t0, t0)
    z3 = fe.add(z3, z3)
    z3 = fe.add(z3, z3)
    t1 = fe.mul(y, z)
    t2 = fe.mul_small(fe.sq(z), fe.B3)
    x3 = fe.mul(t2, z3)
    y3 = fe.add(t0, t2)
    z3 = fe.mul(t1, z3)
    t2 = fe.add(fe.add(t2, t2), t2)
    t0 = fe.sub(t0, t2)
    y3 = fe.add(x3, fe.mul(t0, y3))
    x3 = fe.mul(t0, fe.mul(x, y))
    return (fe.add(x3, x3), y3, z3)


def decompress(qx: torch.Tensor, parity: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """qx fe[10, B], parity int64[B] → (y, on_curve): y = (x³ + 7)^((p+1)/4)
    with the prefix's parity, checked by squaring (reference :120)."""
    rhs = fe.add(fe.mul(fe.sq(qx), qx), fe.const(7, qx.device))
    y = fe.sqrt_candidate(rhs)
    ok = fe.eq(fe.sq(y), rhs)
    flip = (fe.to_canonical(y)[0] & 1) != parity
    return fe.select(flip, fe.neg(y), y), ok


# --- GLV: u2·Q = k1·Q + k2·λQ with |k1|, |k2| < 2^128 ----------------------

# The endomorphism (x, y) -> (β·x, y) is multiplication by λ on the curve
# (λ³ ≡ 1 mod n, β³ ≡ 1 mod p). The lattice {(a, b): a + b·λ ≡ 0 mod n}
# has the short basis (a1, b1), (a2, b2); g1 = round(2^384·b2 / n) and
# g2 = round(2^384·(−b1) / n). These are libsecp256k1's constants
# (scalar_split_lambda); tests/test_torch_secp256k1.py recomputes each.
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
GLV_B2 = GLV_A1
GLV_G1 = 0x3086D221A7D46BCDE86C90E49284EB153DAA8A1471E8CA7FE893209A45DBB031
GLV_G2 = 0xE4437ED6010E88286F547FA90ABFE4C4221208AC9DF506C61571B4AE8AC47F71

WINDOW = 4  # signed radix-16 digits in [-7, 8]
NUM_WINDOWS = 33  # 128 bits and the recoding's carry
TABLE_SIZE = 9  # 0..8 times the base


def glv_split_int(k: int) -> Tuple[int, int]:
    """k in [0, n) → (k1, k2), k1 + k2·λ ≡ k (mod n), both below 2^128 in
    absolute value: c_i = round(k·g_i / 2^384), k1 = k − c1·a1 − c2·a2,
    k2 = −c1·b1 − c2·b2. The kernel and ``glv_split`` compute the same
    integers."""
    c1 = (k * GLV_G1 + (1 << 383)) >> 384
    c2 = (k * GLV_G2 + (1 << 383)) >> 384
    return k - c1 * GLV_A1 - c2 * GLV_A2, -c1 * GLV_B1 - c2 * GLV_B2


_L16 = 16  # the plain split's limbs: 16 bits in int64, so products and sums stay exact
_M16 = (1 << _L16) - 1


def _limbs16_of(v: int, n: int) -> List[int]:
    return [(v >> (_L16 * i)) & _M16 for i in range(n)]


def _to16(words: torch.Tensor) -> torch.Tensor:
    """int64[k, B] u32 words → int64[2k, B] 16-bit limbs."""
    return torch.stack([words & _M16, words >> _L16], dim=1).reshape(-1, words.shape[1])


def _carry16(cols: torch.Tensor, n: int) -> torch.Tensor:
    """Columns [m, B] of a non-negative value (or a value mod 2^(16n)) →
    its low n 16-bit limbs."""
    out, carry = [], torch.zeros_like(cols[0])
    for i in range(n):
        v = (cols[i] if i < cols.shape[0] else 0) + carry
        out.append(v & _M16)
        carry = v >> _L16
    return torch.stack(out, dim=0)


def _mul16(a: torch.Tensor, const: int, n_const: int) -> torch.Tensor:
    """a (16-bit limbs [m, B]) × a constant of n_const limbs → product
    columns [m + n_const, B] (each below 2^40, not carried)."""
    c = _limbs16_of(const, n_const)
    cols = torch.zeros((a.shape[0] + n_const,) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device)
    for j, cj in enumerate(c):
        if cj:
            cols[j:j + a.shape[0]] += a * cj
    return cols


def _round_shift_384(cols: torch.Tensor) -> torch.Tensor:
    """Product columns of a 512-bit value → 16-bit limbs [8, B] of
    round(value / 2^384)."""
    limbs = _carry16(cols, 32)
    high = limbs[24:].clone()
    high[0] += limbs[23] >> 15  # bit 383 rounds
    return _carry16(high, 8)


def _signed_256(cols_pos: torch.Tensor, cols_neg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos − neg) mod 2^256 from product columns, read as a signed 256-bit
    integer known to be below 2^128 in absolute value → (16-bit limbs
    [8, B] of its absolute value, bool[B] negative)."""
    diff = _carry16(cols_pos, 16) + (_M16 - _carry16(cols_neg, 16))
    diff[0] += 1
    diff = _carry16(diff, 16)  # pos + (2^256 − 1 − neg) + 1
    negative = (diff[15] >> 15) == 1
    mag = torch.where(negative, _M16 - diff, diff)
    mag[0] += negative.to(torch.int64)
    return _carry16(mag, 8), negative


def glv_split(k_words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """int64[8, B] u32 words of k < n → (|k1|, k1 < 0, |k2|, k2 < 0), the
    magnitudes as int64[4, B] u32 words: ``glv_split_int`` in torch."""
    k = _to16(k_words)
    c1 = _round_shift_384(_mul16(k, GLV_G1, 16))
    c2 = _round_shift_384(_mul16(k, GLV_G2, 16))
    m1, neg1 = _signed_256(k, _mul16(c1, GLV_A1, 8) + _mul16(c2, GLV_A2, 9)[:16])
    m2, neg2 = _signed_256(_mul16(c1, -GLV_B1, 8), _mul16(c2, GLV_B2, 8))

    def words(m):
        return m[0::2] | (m[1::2] << _L16)

    return words(m1), neg1, words(m2), neg2


def reduce_mod_n(words: torch.Tensor) -> torch.Tensor:
    """int64[8, B] u32 words of a value below 2^256 < 2n → the words of
    the value mod n."""
    v = _to16(words)
    n_limbs = torch.tensor(_limbs16_of(N, 16), device=v.device)[:, None]
    d = v + (_M16 - n_limbs)
    d[0] += 1
    d = _carry16(d, 17)  # v + 2^256 − n: limb 16 is 1 exactly when v >= n
    r = torch.where(d[16] == 1, d[:16], v)
    return r[0::2] | (r[1::2] << _L16)


def signed_digits(words: torch.Tensor) -> torch.Tensor:
    """int64[4, B] u32 words of a value below 2^128 → int64[33, B] signed
    radix-16 digits in [-7, 8], least significant first:
    value = Σ_i d_i·16^i."""
    out, carry = [], torch.zeros_like(words[0])
    for i in range(NUM_WINDOWS - 1):
        v = ((words[i // 8] >> (4 * (i % 8))) & 15) + carry
        carry = (v > 8).to(torch.int64)
        out.append(v - 16 * carry)
    out.append(carry)
    return torch.stack(out, dim=0)


def g_tables() -> List[List[Tuple[int, int, int]]]:
    """[d·G for d in 0..8] and [d·2^128·G for d in 0..8] as (X, Y, Z),
    affine with Z = 1, the identity (0:1:0): the kernel's constant tables
    of the two halves of u1."""
    g = (host.GX, host.GY)
    g128 = host._point_mul(1 << 128, g)
    return [
        [(0, 1, 0)] + [(*host._point_mul(d, base), 1) for d in range(1, TABLE_SIZE)]
        for base in (g, g128)
    ]


# --- wire unpacking -------------------------------------------------------------


def unpack_fe(words: torch.Tensor) -> torch.Tensor:
    """int64[8, B] u32 words → fe[10, B]: limb i is bits 26i..26i+25, limb 9
    bits 234..255."""
    limbs = []
    for i in range(fe.NUM_LIMBS):
        off = fe.BITS * i
        j, k = off // 32, off % 32
        v = words[j] >> k
        if k + fe.BITS > 32 and j + 1 < 8:
            v = v | (words[j + 1] << (32 - k))
        limbs.append(v & fe.MASK)
    return torch.stack(limbs, dim=0)


# --- the verifier ---------------------------------------------------------------


def _q_table(q: Point) -> List[Point]:
    """0..8 times q (identity first): 2q, 4q, 8q and 6q by doubling, the
    odd multiples by one addition."""
    tab = [None] * TABLE_SIZE
    tab[1] = q
    tab[2] = point_dbl(q)
    tab[3] = point_add(tab[2], q)
    tab[4] = point_dbl(tab[2])
    tab[5] = point_add(tab[4], q)
    tab[6] = point_dbl(tab[3])
    tab[7] = point_add(tab[6], q)
    tab[8] = point_dbl(tab[4])
    return tab


def verify_plain(wire: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """bool[B] from the wire u8[128, B] and flags int32[B]. The torch twin of
    ``secp256k1_verify`` in csrc/secp256k1_verify.cu: u2 reduced mod n and
    split by GLV, u1 cut into two 128-bit halves, and
    R' = |k1|·(±Q) + |k2|·(±λQ) + u1_lo·G + u1_hi·2^128·G by 33 signed
    radix-16 windows over four terms (tables 0..8 times ±Q, ±λQ, G and
    2^128·G)."""
    dev = wire.device
    batch = wire.shape[1]
    w = _words(wire)  # int64[32, B]
    qx, r_fe = unpack_fe(w[0:8]), unpack_fe(w[8:16])
    k1, neg1, k2, neg2 = glv_split(reduce_mod_n(w[24:32]))
    digits = [signed_digits(k1), signed_digits(k2), signed_digits(w[16:20]), signed_digits(w[20:24])]
    f = flags.to(torch.int64)
    qy, on_curve = decompress(qx, f & 1)
    one = fe.const(1, dev).expand(fe.NUM_LIMBS, batch)
    zero = torch.zeros((fe.NUM_LIMBS, batch), dtype=torch.int64, device=dev)
    ident: Point = (zero, one, zero)
    q_tab = _q_table((qx, qy, one))
    q_tab[0] = ident
    beta = fe.const(BETA, dev)
    tables = [
        torch.stack([torch.stack(pt, dim=0) for pt in q_tab], dim=0),  # [9, 3, 10, B]
        torch.stack([torch.stack((fe.mul(pt[0], beta), pt[1], pt[2]), dim=0) for pt in q_tab], dim=0),
    ] + [
        torch.stack([torch.stack([fe.const(c, dev).expand(fe.NUM_LIMBS, batch) for c in pt], dim=0) for pt in tab], dim=0)
        for tab in g_tables()
    ]
    negs = [neg1, neg2, torch.zeros_like(neg1), torch.zeros_like(neg1)]
    lanes = torch.arange(batch, device=dev)
    acc: Point = ident
    for win in range(NUM_WINDOWS - 1, -1, -1):
        if win < NUM_WINDOWS - 1:
            for _ in range(WINDOW):
                acc = point_dbl(acc)
        for term in range(4):
            d = digits[term][win]
            sel = tables[term][d.abs(), :, :, lanes]  # [B, 3, 10]
            x, y, z = (sel[:, k].T for k in range(3))
            y = fe.select((d < 0) ^ negs[term], fe.neg(y), y)
            acc = point_add(acc, (x, y, z))

    x, _, z = acc
    match = fe.eq(x, fe.mul(r_fe, z))
    rn = fe.add(r_fe, fe.const(N, dev))
    match = match | (((f & 2) != 0) & fe.eq(x, fe.mul(rn, z)))
    return on_curve & ~fe.is_zero(z) & match


# --- the kernel's wrapper ---------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cbt_secp256k1_verify": [_P, _P, _P, _I, _I, _P]}  # wire, flags, out, B, group, stream


def verify_kernel(wire: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """bool[B] from the wire u8[128, B] and flags int32[B].

    On CUDA tensors this launches ``secp256k1_verify`` on the current
    stream with ``build.group_size`` threads a signature, or raises; CPU
    tensors run ``verify_plain``."""
    global LAUNCHES
    if wire.device.type == "cpu":
        return verify_plain(wire, flags)
    build.require_cuda_tensor(wire, "secp256k1 wire", torch.uint8, 2)
    batch = wire.shape[1]
    if wire.shape[0] != WIRE_ROWS:
        raise ValueError(f"secp256k1 wire: expected {WIRE_ROWS} rows, got {wire.shape[0]}")
    build.require_cuda_tensor(flags, "secp256k1 flags", torch.int32, 1)
    if flags.shape[0] != batch or flags.device != wire.device:
        raise ValueError(f"secp256k1 flags: expected [{batch}] on {wire.device}, got {tuple(flags.shape)} on {flags.device}")
    out = torch.empty(batch, dtype=torch.uint8, device=wire.device)
    if batch == 0:
        return out.bool()
    lib = build.load("secp256k1_verify", _SIGNATURES)
    rc = lib.cbt_secp256k1_verify(
        wire.data_ptr(), flags.data_ptr(), out.data_ptr(), batch, build.group_size(batch, wire.device, GROUP_THREADS_PER_SM),
        build.stream_ptr(wire.device),
    )
    build.check(rc, "secp256k1_verify")
    LAUNCHES += 1
    return out.bool()


# --- entry point -------------------------------------------------------------------


def verify_batch(
    pub_keys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes], device="cuda"
) -> List[bool]:
    """Per-signature verdicts on ``device`` (reference :308): chunks of at
    most ``mesh.chunk_cap(MAX_CHUNK)`` lanes through ``mesh.dispatch_batch``,
    chunk i+1 packed while the card verifies chunk i, the result ANDed
    with the packing's validity mask."""
    n = len(pub_keys)
    if n == 0:
        return []
    valid_full = np.ones(n, bool)

    def chunk(start: int, end: int):
        wire, flags, valid = prepare_batch(pub_keys[start:end], msgs[start:end], sigs[start:end])
        valid_full[start:end] = valid
        return [wire, flags]

    out = mesh.dispatch_batch(verify_kernel, chunk, n, MAX_CHUNK, device)
    return [bool(v) for v in out & valid_full]
