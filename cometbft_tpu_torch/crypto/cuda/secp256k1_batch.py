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
program, one thread per signature: decompress Q, build the 16-entry joint
table ds·G + dh·Q (ds, dh in 0..3), run 128 steps of two doublings and
one addition over the 2-bit digits of u1 and u2, and accept iff
Z ≠ 0 and X ≡ r·Z, or bit 1 is set and X ≡ (r + n)·Z (mod p): x = X/Z
equals r or r + n without an inversion. Points are homogeneous (X:Y:Z)
with the complete Renes–Costello–Batina formulas for a = 0 (b3 = 21),
Algorithm 7 to add (reference ``point_add`` :60) and Algorithm 9 to
double; they cover the identity (0:1:0), inverses and doubling alike.
``verify_plain`` below is the same algorithm in torch ops over the
batch: what a CPU tensor runs, and what the kernel is held against on
the card.

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
NUM_DIGITS = 128  # 2-bit digits of a 256-bit scalar
MAX_CHUNK = 4096  # the reference's _MAX_CHUNK; CBFT_TPU_MAX_CHUNK overrides

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


def g_multiples() -> List[Tuple[int, int, int]]:
    """0·G (the identity (0:1:0)), G, 2G and 3G, affine with Z = 1."""
    g = (host.GX, host.GY)
    return [(0, 1, 0)] + [(*host._point_mul(k, g), 1) for k in (1, 2, 3)]


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


def unpack_digits(words: torch.Tensor) -> torch.Tensor:
    """int64[8, B] u32 words of a scalar → int64[128, B] 2-bit digits, most
    significant first."""
    shifts = torch.arange(30, -2, -2, device=words.device)  # 16 digits a word
    digs = (words.flip(0)[:, None, :] >> shifts[None, :, None]) & 3  # [8, 16, B]
    return digs.reshape(NUM_DIGITS, -1)


# --- the verifier ---------------------------------------------------------------


def verify_plain(wire: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """bool[B] from the wire u8[128, B] and flags int32[B]. The torch twin of
    ``secp256k1_verify`` in csrc/secp256k1_verify.cu."""
    dev = wire.device
    batch = wire.shape[1]
    w = _words(wire)  # int64[32, B]
    qx, r_fe = unpack_fe(w[0:8]), unpack_fe(w[8:16])
    u1, u2 = unpack_digits(w[16:24]), unpack_digits(w[24:32])
    f = flags.to(torch.int64)
    qy, on_curve = decompress(qx, f & 1)
    one = fe.const(1, dev).expand(fe.NUM_LIMBS, batch)
    q: Point = (qx, qy, one)

    g_pts = [tuple(fe.const(c, dev).expand(fe.NUM_LIMBS, batch) for c in pt) for pt in g_multiples()]
    q2 = point_dbl(q)
    q_pts = [None, q, q2, point_add(q2, q)]
    entries = []
    for dh in range(4):  # entry[ds + 4·dh] = ds·G + dh·Q
        for ds in range(4):
            if dh == 0:
                pt = g_pts[ds]
            elif ds == 0:
                pt = q_pts[dh]
            else:
                pt = point_add(g_pts[ds], q_pts[dh])
            entries.append(torch.stack(pt, dim=0))  # [3, 10, B]
    table = torch.stack(entries, dim=0)  # [16, 3, 10, B]

    lanes = torch.arange(batch, device=dev)
    acc: Point = g_pts[0]
    for i in range(NUM_DIGITS):
        acc = point_dbl(point_dbl(acc))
        sel = table[u1[i] + 4 * u2[i], :, :, lanes]  # [B, 3, 10]
        acc = point_add(acc, tuple(sel[:, k].T for k in range(3)))

    x, _, z = acc
    match = fe.eq(x, fe.mul(r_fe, z))
    rn = fe.add(r_fe, fe.const(N, dev))
    match = match | (((f & 2) != 0) & fe.eq(x, fe.mul(rn, z)))
    return on_curve & ~fe.is_zero(z) & match


# --- the kernel's wrapper ---------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cbt_secp256k1_verify": [_P, _P, _P, _I, _P]}  # wire, flags, out, B, stream


def verify_kernel(wire: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """bool[B] from the wire u8[128, B] and flags int32[B].

    On CUDA tensors this launches ``secp256k1_verify`` (one thread per
    signature) on the current stream, or raises; CPU tensors run
    ``verify_plain``."""
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
        wire.data_ptr(), flags.data_ptr(), out.data_ptr(), batch, build.stream_ptr(wire.device)
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
