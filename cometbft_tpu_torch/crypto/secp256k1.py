"""secp256k1 ECDSA keys — the other validator key type of the v0.34 wire.

Reference: cometbft_tpu/crypto/secp256k1.py (crypto/secp256k1/
secp256k1.go): deterministic RFC 6979 signing with compact 64-byte r ‖ s
signatures normalised to low S, and the Bitcoin-style address
RIPEMD160(SHA256(compressed key)).

Verification is the reference's pure-Python branch only: the machine
that holds the card has no ``cryptography`` package, so the port has no
OpenSSL route. Its checks come in the reference's order: a 64-byte
signature; 1 <= r < n and 1 <= s < n; high S (s > n/2) rejected; a key
that does not decompress rejects; then x(u1·G + u2·Q) mod n == r.

The scalar multiplications run in Jacobian coordinates, u1·G + u2·Q as
one joint double-and-add, where the reference uses affine points and an
inversion per step. They compute the same group elements, so every
verdict, key and signature is the reference's; they are only cheaper,
which the 180 signings and CPU verifications of a commit need.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
from typing import Optional, Tuple

from cometbft_tpu_torch.crypto import PrivKey, PubKey, sha256
from cometbft_tpu_torch.crypto.ripemd160 import ripemd160

KEY_TYPE = "secp256k1"
PUB_KEY_SIZE = 33  # compressed
PRIV_KEY_SIZE = 32
SIG_SIZE = 64

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Affine = Optional[Tuple[int, int]]  # None is the point at infinity
Jacobian = Tuple[int, int, int]  # x = X/Z², y = Y/Z³; Z = 0 at infinity

_INF: Jacobian = (0, 1, 0)


def _jac_dbl(p: Jacobian) -> Jacobian:
    """2p; the point at infinity (Z = 0) doubles to Z = 0."""
    x, y, z = p
    yy = y * y % P
    s = 4 * x * yy % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * yy * yy) % P
    return (x3, y3, 2 * y * z % P)


def _jac_add(p: Jacobian, q: Jacobian) -> Jacobian:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    h, r = (u2 - u1) % P, (s2 - s1) % P
    if h == 0:
        return _jac_dbl(p) if r == 0 else _INF
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    return (x3, y3, h * z1 * z2 % P)


def _to_affine(p: Jacobian) -> Affine:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _point_mul(k: int, pt: Tuple[int, int]) -> Affine:
    """k·pt, double-and-add from the top bit."""
    base: Jacobian = (pt[0], pt[1], 1)
    acc = _INF
    for bit in range(k.bit_length() - 1, -1, -1):
        acc = _jac_dbl(acc)
        if (k >> bit) & 1:
            acc = _jac_add(acc, base)
    return _to_affine(acc)


def _joint_mul(u1: int, u2: int, q: Tuple[int, int]) -> Affine:
    """u1·G + u2·Q in one pass over the bits (Straus–Shamir)."""
    g: Jacobian = (GX, GY, 1)
    qj: Jacobian = (q[0], q[1], 1)
    table = (None, g, qj, _jac_add(g, qj))
    acc = _INF
    for bit in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
        acc = _jac_dbl(acc)
        d = ((u1 >> bit) & 1) | (((u2 >> bit) & 1) << 1)
        if d:
            acc = _jac_add(acc, table[d])
    return _to_affine(acc)


def _compress(pt: Tuple[int, int]) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decompress(data: bytes) -> Tuple[int, int]:
    """Reference :97. Raises ValueError on a bad prefix or length, x >= p,
    or an x whose x³ + 7 is not a square."""
    if len(data) != 33 or data[0] not in (2, 3):
        raise ValueError("bad compressed point")
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("not on curve")
    if (y & 1) != (data[0] & 1):
        y = P - y
    return (x, y)


def _rfc6979_k(priv: int, h1: bytes) -> int:
    """Deterministic nonce per RFC 6979 with SHA-256 (reference :112)."""
    x = priv.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


class PubKeySecp256k1(PubKey):
    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PUB_KEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(key_bytes)

    def address(self) -> bytes:
        """RIPEMD160(SHA256(compressed)) — secp256k1.go:1-25 header."""
        return ripemd160(sha256(self._bytes))

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIG_SIZE:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < N and 1 <= s < N):
            return False
        if s > N // 2:  # high S: the low-S malleability rule
            return False
        try:
            q = _decompress(self._bytes)
        except ValueError:
            return False
        e = int.from_bytes(sha256(msg), "big") % N
        w = pow(s, -1, N)
        pt = _joint_mul(e * w % N, r * w % N, q)
        if pt is None:
            return False
        return pt[0] % N == r

    def __repr__(self) -> str:
        return f"PubKeySecp256k1{{{self._bytes.hex().upper()}}}"


class PrivKeySecp256k1(PrivKey):
    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PRIV_KEY_SIZE:
            raise ValueError(f"secp256k1 privkey must be {PRIV_KEY_SIZE} bytes")
        d = int.from_bytes(key_bytes, "big")
        if not (1 <= d < N):
            raise ValueError("privkey scalar out of range")
        self._bytes = bytes(key_bytes)
        self._d = d

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        """Reference :201: RFC 6979 k, r = x(k·G) mod n, low S."""
        h1 = sha256(msg)
        e = int.from_bytes(h1, "big") % N
        while True:
            k = _rfc6979_k(self._d, h1)
            r = _point_mul(k, (GX, GY))[0] % N
            if r == 0:
                continue
            s = pow(k, -1, N) * (e + r * self._d) % N
            if s == 0:
                continue
            if s > N // 2:
                s = N - s
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> PubKeySecp256k1:
        return PubKeySecp256k1(_compress(_point_mul(self._d, (GX, GY))))

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKeySecp256k1:
    while True:
        b = secrets.token_bytes(32)
        if 1 <= int.from_bytes(b, "big") < N:
            return PrivKeySecp256k1(b)


def gen_priv_key_from_secret(secret: bytes) -> PrivKeySecp256k1:
    """Reference :240 (GenPrivKeySecp256k1): SHA-256 of the secret, hashed
    again until it is a valid scalar."""
    seed = sha256(secret)
    while True:
        if 1 <= int.from_bytes(seed, "big") < N:
            return PrivKeySecp256k1(seed)
        seed = sha256(seed)
