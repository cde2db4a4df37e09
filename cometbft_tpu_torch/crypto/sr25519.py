"""sr25519 — Schnorr signatures over ristretto255 (schnorrkel protocol).

Reference: cometbft_tpu/crypto/sr25519.py, copied as it stands: keys,
signing and the CPU verify (``PubKeySr25519.verify_signature``, which the
card's ``sr25519_verify`` is held against). The signing context is a merlin
transcript labeled "SigningContext" with an EMPTY context string
(go-schnorrkel privkey.go:34, pubkey.go:50); the Schnorr-sig protocol
commits the public key and R, draws the challenge scalar from 64
transcript bytes mod l, and checks s·B = R + k·A over ristretto255
(RFC 9496 decode/encode). The checks come in the reference's order: a
64-byte signature, the format bit (sig[63] & 0x80), s < L after
unmasking, the decode of A and of R (canonical, non-negative, a square),
then the transcript and the group equation.

Private keys are 32-byte mini secrets expanded ExpandEd25519-style
(sha512 → clamped, cofactor-divided scalar + nonce half).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from cometbft_tpu_torch.crypto import PrivKey, PubKey, address_hash
from cometbft_tpu_torch.crypto.merlin import Transcript

KEY_TYPE = "sr25519"
PUB_KEY_SIZE = 32
SIGNATURE_SIZE = 64
PUB_KEY_NAME = "tendermint/PubKeySr25519"
PRIV_KEY_NAME = "tendermint/PrivKeySr25519"

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
# 1 / sqrt(a - d) with a = -1
_INVSQRT_A_MINUS_D = None  # computed below


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """RFC 9496 SQRT_RATIO_M1: (was_square, sqrt(u/v) or sqrt(i·u/v))."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u_neg = (-u) % P
    correct_sign = check == u % P
    flipped_sign = check == u_neg
    flipped_sign_i = check == u_neg * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    if _is_negative(r):
        r = (-r) % P
    return correct_sign or flipped_sign, r


_ok, _INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)
assert _ok


def _decode(b: bytes) -> Optional[Tuple[int, int, int, int]]:
    """Ristretto255 decode (RFC 9496 §4.3.1) → extended (X,Y,Z,T) or None."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = ((-(D * u1 % P * u1)) % P - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = (2 * s % P) * den_x % P
    if _is_negative(x):
        x = (-x) % P
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def _encode(pt: Tuple[int, int, int, int]) -> bytes:
    """Ristretto255 encode (RFC 9496 §4.3.2)."""
    x0, y0, z0, t0 = pt
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_negative(t0 * z_inv % P):
        x, y = y0 * SQRT_M1 % P, x0 * SQRT_M1 % P
        den_inv = den1 * _INVSQRT_A_MINUS_D % P
    else:
        x, y = x0, y0
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (-y) % P
    s = den_inv * ((z0 - y) % P) % P
    if _is_negative(s):
        s = (-s) % P
    return s.to_bytes(32, "little")


# -- edwards arithmetic on python ints (extended coordinates, a = -1) --------


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * 2 % P * D % P * t2 % P
    d = z1 * 2 % P * z2 % P
    e, f, g, h = (b - a) % P, (d - c) % P, (d + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


_BY = 4 * pow(5, P - 2, P) % P
_BX_cand = None
_u = (_BY * _BY - 1) % P
_v = (D * _BY % P * _BY + 1) % P
_sq, _BX_cand = _sqrt_ratio_m1(_u, _v)
assert _sq
_BX = _BX_cand if _BX_cand % 2 == 0 else P - _BX_cand
_BASE = (_BX, _BY, 1, _BX * _BY % P)
_ID = (0, 1, 1, 0)


def _mul(k: int, pt) -> Tuple[int, int, int, int]:
    acc = _ID
    add = pt
    while k:
        if k & 1:
            acc = _add(acc, add)
        add = _add(add, add)
        k >>= 1
    return acc


def _pts_equal(p, q) -> bool:
    """Ristretto255 equality (RFC 9496 §4.5): points are equal when
    X1·Y2 == Y1·X2 or Y1·Y2 == X1·X2 (a = -1) — decode may hand back a
    different coset representative, so edwards equality is too strict."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return (x1 * y2 - y1 * x2) % P == 0 or (y1 * y2 - x1 * x2) % P == 0


# -- schnorrkel transcript protocol ------------------------------------------


def _signing_transcript(msg: bytes) -> Transcript:
    t = Transcript(b"SigningContext")
    t.append_message(b"", b"")  # empty context (privkey.go:34)
    t.append_message(b"sign-bytes", msg)
    return t


def _challenge_scalar(t: Transcript, label: bytes) -> int:
    return int.from_bytes(t.challenge_bytes(label, 64), "little") % L


# -- keys --------------------------------------------------------------------


class PubKeySr25519(PubKey):
    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PUB_KEY_SIZE:
            raise ValueError(f"sr25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(key_bytes)

    def address(self) -> bytes:
        return address_hash(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        # schnorrkel "new" format: s high bit is the format marker
        if sig[63] & 0x80 == 0:
            return False
        s_bytes = bytearray(sig[32:])
        s_bytes[31] &= 0x7F
        s = int.from_bytes(bytes(s_bytes), "little")
        if s >= L:
            return False
        a = _decode(self._bytes)
        r_pt = _decode(sig[:32])
        if a is None or r_pt is None:
            return False
        t = _signing_transcript(msg)
        t.append_message(b"proto-name", b"Schnorr-sig")
        t.append_message(b"sign:pk", self._bytes)
        t.append_message(b"sign:R", sig[:32])
        k = _challenge_scalar(t, b"sign:c")
        # s·B == R + k·A
        lhs = _mul(s, _BASE)
        rhs = _add(r_pt, _mul(k, a))
        return _pts_equal(lhs, rhs)

    def __repr__(self) -> str:
        return f"PubKeySr25519{{{self._bytes.hex().upper()}}}"


class PrivKeySr25519(PrivKey):
    """32-byte mini secret, ExpandEd25519-expanded on use."""

    def __init__(self, mini_secret: bytes):
        if len(mini_secret) != 32:
            raise ValueError("sr25519 mini secret must be 32 bytes")
        self._mini = bytes(mini_secret)
        h = hashlib.sha512(self._mini).digest()
        key = bytearray(h[:32])
        key[0] &= 248
        key[31] &= 63
        key[31] |= 64
        # "divide by cofactor": the scalar is the clamped value >> 3
        self._scalar = (int.from_bytes(bytes(key), "little") >> 3) % L
        self._nonce = h[32:]
        self._pub = _encode(_mul(self._scalar, _BASE))

    def bytes(self) -> bytes:
        return self._mini

    def type(self) -> str:
        return KEY_TYPE

    def pub_key(self) -> PubKeySr25519:
        return PubKeySr25519(self._pub)

    def sign(self, msg: bytes) -> bytes:
        t = _signing_transcript(msg)
        t.append_message(b"proto-name", b"Schnorr-sig")
        t.append_message(b"sign:pk", self._pub)
        # deterministic nonce from the expansion nonce + message (the
        # reference draws from a transcript RNG; any secret-derived,
        # message-bound nonce yields valid signatures)
        r = (
            int.from_bytes(
                hashlib.sha512(self._nonce + msg).digest(), "little"
            )
            % L
        )
        big_r = _encode(_mul(r, _BASE))
        t.append_message(b"sign:R", big_r)
        k = _challenge_scalar(t, b"sign:c")
        s = (k * self._scalar + r) % L
        s_bytes = bytearray(s.to_bytes(32, "little"))
        s_bytes[31] |= 0x80  # schnorrkel signature format marker
        return big_r + bytes(s_bytes)


def gen_priv_key_from_secret(secret: bytes) -> PrivKeySr25519:
    return PrivKeySr25519(hashlib.sha256(secret).digest())


def gen_priv_key() -> PrivKeySr25519:
    import os

    return PrivKeySr25519(os.urandom(32))
