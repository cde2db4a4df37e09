"""Batched Ed25519 verification on the card: host packing, the plain torch
verifier, and the wrapper around the hand-written CUDA kernel.

Reference: cometbft_tpu/crypto/tpu/ed25519_batch.py. Its device program
``_verify_core_compact`` (``verify_kernel_compact``, :338-347) maps the
compact wire u8[128, B] — rows 0:32 A, 32:64 R, 64:96 S, 96:128
h = SHA-512(R‖A‖M) mod L, raw little-endian bytes — to bool[B]. The
port keeps that wire and that contract; the host packing below is a copy
of the reference's (:444-583) in numpy and hashlib.

The CUDA kernel (``csrc/ed25519_verify.cu``) replaces that jitted XLA
program. It runs one thread per signature: decompress A, build the
16-entry table ds·B + dh·(−A) in cached form, run the 127-step radix-4
Straus loop, invert Z, encode and byte-compare with R. ``verify_compact_plain``
below is the same algorithm in torch ops over the batch; it is what a
CPU tensor runs, and what the kernel is held against on the card.

Semantics (reference :33-42): s >= L is rejected on the host (the
``valid`` mask, ANDed with the kernel's verdict); A's y is taken mod p;
a failed decompression rejects; -0 decodes as 0; R is compared as raw
bytes, so a non-canonical R never matches.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from cometbft_tpu_torch.crypto.cuda import build, field as fe
from cometbft_tpu_torch.crypto.cuda.field import L, P

NUM_DIGITS = 127  # 2-bit windows of a 253-bit scalar
WIRE_ROWS = 128

# launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0


# --- host packing (reference ed25519_batch.py:444-583) ----------------------

_L_BYTES_LE = np.frombuffer(L.to_bytes(32, "little"), np.uint8)


def _s_below_l(s_arr: np.ndarray) -> np.ndarray:
    """bool[B]: s < L, compared from the most significant byte down
    (u8[B,32] little-endian in)."""
    n = s_arr.shape[0]
    diff = s_arr.astype(np.int16) - _L_BYTES_LE.astype(np.int16)
    nz_mask = diff != 0
    has_diff = nz_mask.any(axis=1)
    msb_idx = 31 - nz_mask[:, ::-1].argmax(axis=1)
    return has_diff & (diff[np.arange(n), msb_idx] < 0)


def _parse_inputs(pub_keys, sigs):
    """→ (pk_arr u8[B,32], sig_arr u8[B,64], valid) with wrong-length and
    s ≥ L entries masked out (zero-filled placeholders keep the shapes)."""
    n = len(pub_keys)
    valid = np.ones(n, bool)
    pk_parts, sig_parts = [], []
    for i in range(n):
        pk, sig = pub_keys[i], sigs[i]
        if len(pk) != 32 or len(sig) != 64:
            valid[i] = False
            pk_parts.append(b"\x00" * 32)
            sig_parts.append(b"\x00" * 64)
        else:
            pk_parts.append(pk)
            sig_parts.append(sig)
    pk_arr = np.frombuffer(b"".join(pk_parts), np.uint8).reshape(n, 32)
    sig_arr = np.frombuffer(b"".join(sig_parts), np.uint8).reshape(n, 64)
    valid &= _s_below_l(sig_arr[:, 32:])
    return pk_arr, sig_arr, valid


def _challenge_scalars(
    pk_arr: np.ndarray, sig_arr: np.ndarray, msgs, valid: np.ndarray
) -> np.ndarray:
    """h = SHA-512(R ‖ A ‖ M) mod L per valid lane → u8[B,32] little-endian
    (zero on invalid lanes)."""
    n = len(msgs)
    h_arr = np.zeros((n, 32), np.uint8)
    sha = hashlib.sha512
    for i in range(n):
        if not valid[i]:
            continue
        h_int = (
            int.from_bytes(
                sha(
                    sig_arr[i, :32].tobytes() + pk_arr[i].tobytes() + bytes(msgs[i])
                ).digest(),
                "little",
            )
            % L
        )
        h_arr[i] = np.frombuffer(h_int.to_bytes(32, "little"), np.uint8)
    return h_arr


def pack_compact_rows(*row_arrs: np.ndarray) -> np.ndarray:
    """Stack u8[B,k] byte arrays into the byte-major wire u8[Σk,B]."""
    n = row_arrs[0].shape[0]
    rows = sum(a.shape[1] for a in row_arrs)
    wire = np.empty((rows, n), np.uint8)
    at = 0
    for a in row_arrs:
        wire[at : at + a.shape[1]] = a.T
        at += a.shape[1]
    return wire


def prepare_batch_compact(
    pub_keys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (wire u8[128,B], valid bool[B]): rows 0:32 A, 32:64 R, 64:96 S,
    96:128 h, raw little-endian bytes."""
    pk_arr, sig_arr, valid = _parse_inputs(pub_keys, sigs)
    h_arr = _challenge_scalars(pk_arr, sig_arr, msgs, valid)
    wire = pack_compact_rows(pk_arr, sig_arr[:, :32], sig_arr[:, 32:], h_arr)
    return wire, valid


# --- point layer (reference :119-213), extended coordinates, a = -1 --------

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def point_dbl(p: Point) -> Point:
    """dbl-2008-hwcd; valid for every input, identity included."""
    x1, y1, z1, _ = p
    a = fe.sq(x1)
    b = fe.sq(y1)
    zz = fe.sq(z1)
    c = fe.add(zz, zz)
    d = fe.neg(a)
    e = fe.sub(fe.sub(fe.sq(fe.add(x1, y1)), a), b)
    g = fe.add(d, b)
    f = fe.sub(g, c)
    h = fe.sub(d, b)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def cache_point(q: Point) -> Point:
    """(Y+X, Y−X, 2d·T, 2Z), ref10's cached form."""
    x2, y2, z2, t2 = q
    d2 = fe.const(fe.D2, x2.device)
    return (fe.add(y2, x2), fe.sub(y2, x2), fe.mul(t2, d2), fe.add(z2, z2))


def add_cached(p: Point, qc: Point) -> Point:
    """add-2008-hwcd-3 with q in cached form; complete on this curve."""
    x1, y1, z1, t1 = p
    yp, ym, t2d, z2 = qc
    a = fe.mul(fe.sub(y1, x1), ym)
    b = fe.mul(fe.add(y1, x1), yp)
    c = fe.mul(t1, t2d)
    d = fe.mul(z1, z2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_add(p: Point, q: Point) -> Point:
    return add_cached(p, cache_point(q))


def decompress(y: torch.Tensor, sign: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """y fe[10,B] (low 255 bits), sign int64[B] → (x, ok), ref10 semantics:
    y is taken mod p, the root x = (u/v)^((p+3)/8) is checked by
    v·x² ∈ {u, −u}, parity follows the sign bit (negating 0 keeps 0)."""
    dev = y.device
    one = fe.const(1, dev)
    yy = fe.sq(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const(fe.D, dev)), one)
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    t = fe.pow_p58(fe.mul(u, v7))
    x = fe.mul(fe.mul(u, v3), t)
    vxx = fe.mul(v, fe.sq(x))
    ok_direct = fe.eq(vxx, u)
    ok_flip = fe.eq(vxx, fe.neg(u))
    x = fe.select(ok_flip, fe.mul(x, fe.const(fe.SQRT_M1, dev)), x)
    flip = (fe.to_canonical(x)[0] & 1) != sign
    x = fe.select(flip, fe.neg(x), x)
    return x, ok_direct | ok_flip


# --- wire unpacking ---------------------------------------------------------


def _words(rows: torch.Tensor) -> torch.Tensor:
    """u8[4k,B] little-endian bytes → int64[k,B] u32 words."""
    r = rows.to(torch.int64)
    return r[0::4] | (r[1::4] << 8) | (r[2::4] << 16) | (r[3::4] << 24)


def unpack_fe(words: torch.Tensor) -> torch.Tensor:
    """int64[8,B] u32 words → fe[10,B] limbs of the low 255 bits."""
    limbs = []
    for i in range(fe.NUM_LIMBS):
        off, w = fe.OFFSETS[i], fe.WIDTHS[i]
        j, k = off // 32, off % 32
        v = words[j] >> k
        if k + w > 32:
            v = v | (words[j + 1] << (32 - k))
        limbs.append(v & ((1 << w) - 1))
    return torch.stack(limbs, dim=0)


def unpack_digits(words: torch.Tensor) -> torch.Tensor:
    """int64[8,B] scalar words → int64[127,B] radix-4 digits, MSB first."""
    digs = []
    for d in range(NUM_DIGITS):
        bit = 2 * (NUM_DIGITS - 1 - d)
        digs.append((words[bit // 32] >> (bit % 32)) & 3)
    return torch.stack(digs, dim=0)


def encode(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Canonical affine (x, y) → int64[8,B] u32 words of the 32-byte
    encoding: y's 255 bits, x's parity at bit 255."""
    yc = fe.to_canonical(y)
    words = []
    for j in range(8):
        w = torch.zeros_like(yc[0])
        for i in range(fe.NUM_LIMBS):
            off, width = fe.OFFSETS[i], fe.WIDTHS[i]
            lo, hi = max(off, 32 * j), min(off + width, 32 * j + 32)
            if lo >= hi:
                continue
            part = (yc[i] >> (lo - off)) & ((1 << (hi - lo)) - 1)
            w = w | (part << (lo - 32 * j))
        words.append(w)
    words[7] = words[7] | ((fe.to_canonical(x)[0] & 1) << 31)
    return torch.stack(words, dim=0)


# --- the verifier -----------------------------------------------------------


def _base_points(device) -> List[Point]:
    """Identity, B, 2B and 3B as extended points with Z = 1."""
    from cometbft_tpu_torch.crypto import purepy

    pts = [purepy.IDENT, purepy.B]
    pts.append(purepy.pt_dbl(purepy.B))
    pts.append(purepy.pt_add(pts[2], purepy.B))
    out = []
    for x, y, z, _ in pts:
        zinv = pow(z, P - 2, P)
        ax, ay = x * zinv % P, y * zinv % P
        out.append(tuple(fe.const(v, device) for v in (ax, ay, 1, ax * ay % P)))
    return out


def verify_compact_plain(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the compact wire u8[128,B]: encode([s]B + [h](−A)) == R
    and A decompresses. The torch twin of the CUDA kernel."""
    dev = wire.device
    words = _words(wire)  # int64[32,B]
    a_w, r_w, s_w, h_w = words[0:8], words[8:16], words[16:24], words[24:32]
    batch = wire.shape[1]
    ay = unpack_fe(a_w)
    a_sign = (a_w[7] >> 31) & 1
    x, ok = decompress(ay, a_sign)
    nx = fe.neg(x)
    one = fe.const(1, dev).expand(fe.NUM_LIMBS, batch)
    neg_a: Point = (nx, ay, one, fe.mul(nx, ay))

    # entry[ds + 4·dh] = ds·B + dh·(−A), cached
    a2 = point_dbl(neg_a)
    a3 = point_add(a2, neg_a)
    s_pts = [
        tuple(c.expand(fe.NUM_LIMBS, batch) for c in pt) for pt in _base_points(dev)
    ]
    h_pts = [None, neg_a, a2, a3]
    entries = []
    for dh in range(4):
        for ds in range(4):
            if dh == 0:
                pt = s_pts[ds]
            elif ds == 0:
                pt = h_pts[dh]
            else:
                pt = point_add(s_pts[ds], h_pts[dh])
            entries.append(torch.stack(cache_point(pt), dim=0))  # [4,10,B]
    table = torch.stack(entries, dim=0)  # [16,4,10,B]

    s_dig = unpack_digits(s_w)
    h_dig = unpack_digits(h_w)
    lanes = torch.arange(batch, device=dev)
    acc: Point = s_pts[0]
    for i in range(NUM_DIGITS):
        acc = point_dbl(point_dbl(acc))
        idx = s_dig[i] + 4 * h_dig[i]
        sel = table[idx, :, :, lanes]  # [B,4,10]
        acc = add_cached(acc, tuple(sel[:, k].T for k in range(4)))

    rx, ry, rz, _ = acc
    zinv = fe.invert(rz)
    enc = encode(fe.mul(rx, zinv), fe.mul(ry, zinv))
    return (enc == r_w).all(dim=0) & ok


_SIGNATURES = {
    "cbt_ed25519_verify_compact": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    ],
}


def verify_kernel_compact(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the compact wire u8[128,B].

    On a CUDA tensor this launches ``ed25519_verify_compact`` (one thread
    per signature) on the current stream, or raises; a CPU tensor runs
    ``verify_compact_plain``."""
    global LAUNCHES
    if wire.device.type == "cpu":
        return verify_compact_plain(wire)
    build.require_cuda_tensor(wire, "ed25519 wire", torch.uint8, 2)
    if wire.shape[0] != WIRE_ROWS:
        raise ValueError(f"ed25519 wire: expected {WIRE_ROWS} rows, got {wire.shape[0]}")
    batch = wire.shape[1]
    out = torch.empty(batch, dtype=torch.uint8, device=wire.device)
    if batch == 0:
        return out.bool()
    lib = build.load("ed25519_verify", _SIGNATURES)
    rc = lib.cbt_ed25519_verify_compact(
        wire.data_ptr(), out.data_ptr(), batch, build.stream_ptr(wire.device)
    )
    build.check(rc, "ed25519_verify_compact")
    LAUNCHES += 1
    return out.bool()


def verify_batch(
    pub_keys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    device="cuda",
) -> List[bool]:
    """Per-signature verdicts: pack on the host, verify on ``device``, AND
    with the packing's validity mask."""
    if not pub_keys:
        return []
    wire, valid = prepare_batch_compact(pub_keys, msgs, sigs)
    wire_t = torch.from_numpy(wire).to(device)
    ok = verify_kernel_compact(wire_t).cpu().numpy()
    return [bool(v) for v in ok & valid]
