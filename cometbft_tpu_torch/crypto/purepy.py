"""Pure-Python Ed25519 sign and verify — the port's CPU oracle and signer.

Reference: cometbft_tpu/crypto/purepy.py (the last rung of the reference's
``cryptography`` → native → pure-Python ladder). The port keeps only this
rung, because it is the one that runs everywhere the port runs.

Verify semantics are those of the reference's CPU backend on a host with
``cryptography`` (OpenSSL, itself ref10) and of the device kernels
(cometbft_tpu/crypto/tpu/ed25519_batch.py:33-42):

* cofactorless: encode([s]B + [h](-A)) must equal R byte for byte, so a
  non-canonical R never matches;
* s >= L is rejected;
* A's y is taken mod p (a non-canonical encoding is not rejected) and
  x = 0 with the sign bit set decodes as 0 — ref10's ge_frombytes. The
  reference's own pure-Python rung rejects both; OpenSSL accepts both.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]  # extended (X, Y, Z, T), x = X/Z, y = Y/Z


def _recover_x(y: int, sign: int) -> Optional[int]:
    """ref10 square root: y is any residue mod p; None if no root."""
    y %= P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx != u:
        if vxx != (-u) % P:
            return None
        x = x * SQRT_M1 % P
    if (x & 1) != sign:
        x = (-x) % P
    return x


BY = 4 * pow(5, P - 2, P) % P
BX = _recover_x(BY, 0)
B: Point = (BX, BY, 1, BX * BY % P)
IDENT: Point = (0, 1, 1, 0)


def pt_add(p: Point, q: Point) -> Point:
    """add-2008-hwcd-3, complete on edwards25519."""
    px, py, pz, pt = p
    qx, qy, qz, qt = q
    a = (py - px) * (qy - qx) % P
    b = (py + px) * (qy + qx) % P
    c = 2 * pt * qt * D % P
    d = 2 * pz * qz % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_dbl(p: Point) -> Point:
    """dbl-2008-hwcd, a = -1."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = b - a
    f = g - c
    h = -a - b
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_neg(p: Point) -> Point:
    return ((-p[0]) % P, p[1], p[2], (-p[3]) % P)


def pt_mul(s: int, p: Point) -> Point:
    q = IDENT
    for bit in bin(s)[2:] if s else "":
        q = pt_dbl(q)
        if bit == "1":
            q = pt_add(q, p)
    return q


def pt_double_mul(s: int, p: Point, h: int, q: Point) -> Point:
    """[s]p + [h]q by one joint (Straus) double-and-add pass."""
    table = {(0, 1): q, (1, 0): p, (1, 1): pt_add(p, q)}
    acc = IDENT
    for i in range(max(s.bit_length(), h.bit_length()) - 1, -1, -1):
        acc = pt_dbl(acc)
        key = ((s >> i) & 1, (h >> i) & 1)
        if key != (0, 0):
            acc = pt_add(acc, table[key])
    return acc


def pt_encode(p: Point) -> bytes:
    zinv = pow(p[2], P - 2, P)
    x = p[0] * zinv % P
    y = p[1] * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def pt_decode(b: bytes) -> Optional[Point]:
    """ref10 ge_frombytes: y = low 255 bits mod p; None only when x² has
    no root."""
    if len(b) != 32:
        return None
    val = int.from_bytes(b, "little")
    y = (val & ((1 << 255) - 1)) % P
    x = _recover_x(y, val >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def sha512_mod_l(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little") % L


def _clamp(h32: bytes) -> int:
    a = bytearray(h32)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(a, "little")


def ed25519_public_from_seed(seed: bytes) -> bytes:
    a = _clamp(hashlib.sha512(seed).digest()[:32])
    return pt_encode(pt_mul(a, B))


def ed25519_sign(seed: bytes, pub: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6 (Go crypto/ed25519 Sign)."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    r = sha512_mod_l(h[32:], msg)
    r_enc = pt_encode(pt_mul(r, B))
    k = sha512_mod_l(r_enc, pub, msg)
    s = (r + k * a) % L
    return r_enc + int.to_bytes(s, 32, "little")


def ed25519_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactorless verify: encode([s]B + [h](-A)) must byte-equal
    sig[:32]; R is never decoded."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    a_pt = pt_decode(pub)
    if a_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = sha512_mod_l(sig[:32], pub, msg)
    r_prime = pt_double_mul(s, B, h, pt_neg(a_pt))
    return pt_encode(r_prime) == sig[:32]
