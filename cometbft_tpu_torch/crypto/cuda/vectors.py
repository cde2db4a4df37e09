"""Ed25519, secp256k1 and sr25519 vectors for the verify contracts, made
from a seed.

Each case is (label, public key, message, signature). The Ed25519 cases
cover what the reference's contract names
(cometbft_tpu/crypto/tpu/ed25519_batch.py:33-42) and what its tests
probe: valid signatures; a corrupted R, S or message; a wrong key;
s >= L; a non-canonical A; identity and small-order keys; -0; a
non-canonical R; a key that does not decompress; and a mixed batch.
``secp256k1_cases`` covers the secp256k1 contract
(cometbft_tpu/crypto/tpu/secp256k1_batch.py:19-31), and adds wire-level
lanes for branches no signature reaches. ``sr25519_cases`` covers the
sr25519 contract (cometbft_tpu/crypto/tpu/sr25519_batch.py:19-23) with
every check of the CPU verifier's order (crypto/sr25519.py:186-210) and
each way a ristretto255 decode fails. ``chip_smoke.py`` holds the
kernels against their plain versions and the CPU verifiers on them; the
CPU tests hold the plain versions against the reference package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto import sr25519 as sr

Case = Tuple[str, bytes, bytes, bytes]
# (label, qx, r, u1, u2, flags, verdict): one lane of the secp256k1 wire
WireCase = Tuple[str, int, int, int, int, int, bool]


def _flip(b: bytes, byte: int, mask: int) -> bytes:
    out = bytearray(b)
    out[byte] ^= mask
    return bytes(out)


def _crafted(pk: bytes, s: int) -> bytes:
    """A signature that verifies against a key whose point is the
    identity: R = encode([s]B), S = s (then [h](-A) vanishes)."""
    return purepy.pt_encode(purepy.pt_mul(s, purepy.B)) + s.to_bytes(32, "little")


def edge_cases(seed: int = 7) -> List[Case]:
    rng = np.random.default_rng(seed)
    p = purepy.P
    keys = [ed.gen_priv_key_from_secret(b"edge-%d" % i) for i in range(4)]
    msgs = [rng.bytes(int(rng.integers(0, 120))) for _ in range(4)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    pks = [k.pub_key().bytes() for k in keys]
    ident = (1).to_bytes(32, "little")
    ident_noncanon = (p + 1).to_bytes(32, "little")  # y = p + 1 = 1 mod p
    minus_zero = (1 | (1 << 255)).to_bytes(32, "little")  # x = -0, y = 1
    order2 = (p - 1).to_bytes(32, "little")  # (0, -1)
    order4 = (0).to_bytes(32, "little")  # (±sqrt(-1), 0)
    s_over = int.from_bytes(sigs[0][32:], "little") + purepy.L
    cases: List[Case] = [
        ("valid", pks[0], msgs[0], sigs[0]),
        ("valid", pks[1], msgs[1], sigs[1]),
        ("corrupt_r", pks[0], msgs[0], _flip(sigs[0], 0, 0x01)),
        ("corrupt_s", pks[1], msgs[1], _flip(sigs[1], 40, 0x80)),
        ("corrupt_msg", pks[2], msgs[2] + b"!", sigs[2]),
        ("wrong_key", pks[3], msgs[2], sigs[2]),
        ("s_ge_l", pks[0], msgs[0], sigs[0][:32] + s_over.to_bytes(32, "little")),
        ("identity_key", ident, b"any message", _crafted(ident, 12345)),
        ("noncanonical_key", ident_noncanon, b"any message", _crafted(ident, 12345)),
        ("minus_zero_key", minus_zero, b"any message", _crafted(ident, 777)),
        ("order2_key", order2, b"m", _crafted(ident, 4242)),
        ("order2_key", order2, msgs[3], sigs[3]),
        ("order4_key", order4, b"m", _crafted(ident, 99)),
        ("order4_key_signed", _flip(order4, 31, 0x80), b"m", _crafted(ident, 99)),
        # R = identity encoded canonically (y = 1) and non-canonically
        # (y = p + 1): s = 0 makes [s]B + [h](-identity) the identity
        ("canonical_r", ident, b"r", ident + bytes(32)),
        ("noncanonical_r", ident, b"r", ident_noncanon + bytes(32)),
        ("garbage_key", b"\xff" * 32, msgs[0], sigs[0]),
        ("zero_sig", pks[0], msgs[0], bytes(64)),
    ]
    return cases


def mixed_batch(n: int = 33, seed: int = 3) -> List[Case]:
    """n signatures over random messages; every third has one bit flipped."""
    rng = np.random.default_rng(seed)
    out: List[Case] = []
    for i in range(n):
        k = ed.gen_priv_key_from_secret(bytes([i, 1]))
        m = rng.bytes(int(rng.integers(0, 200)))
        s = k.sign(m)
        label = "valid"
        if i % 3 == 0:
            s = _flip(s, int(rng.integers(0, 64)), 1 << int(rng.integers(0, 8)))
            label = "flipped"
        out.append((label, k.pub_key().bytes(), m, s))
    return out


def _torsion_point() -> purepy.Point:
    """A point of order 8: [L]P for the first y (counting up from 2) on
    the curve whose torsion component has order 8."""
    y = 2
    while True:
        x = purepy._recover_x(y, 0)
        if x is not None:
            t = purepy.pt_mul(purepy.L, (x, y, 1, x * y % purepy.P))
            if purepy.pt_encode(purepy.pt_mul(4, t)) != purepy.pt_encode(purepy.IDENT):
                return t
        y += 1


def _torsioned_signature(a: int, msg_base: bytes, want_zero: bool) -> Case:
    """A key A = [a]B + T with T of order 8, and a signature of the form
    every signer makes (R = [r]B, S = r + h·a mod L). It verifies
    cofactorlessly exactly when [h]T is the identity, i.e. when h ≡ 0
    (mod 8). L ≡ 5 (mod 8), so h and h + L never both pass: the verdict
    depends on h being reduced exactly. The message is the first of
    ``msg_base ‖ counter`` whose h mod 8 is (want_zero ? 0 : not 0)."""
    pub_pt = purepy.pt_add(purepy.pt_mul(a, purepy.B), _torsion_point())
    pub = purepy.pt_encode(pub_pt)
    r = 0x1234567 + a
    r_enc = purepy.pt_encode(purepy.pt_mul(r, purepy.B))
    counter = 0
    while True:
        msg = msg_base + counter.to_bytes(2, "little")
        h = purepy.sha512_mod_l(r_enc, pub, msg)
        if (h % 8 == 0) == want_zero:
            s = (r + h * a) % purepy.L
            label = "torsioned_h0" if want_zero else "torsioned_h_nonzero"
            return (label, pub, msg, r_enc + s.to_bytes(32, "little"))
        counter += 1


def device_hash_cases(seed: int = 11) -> List[Case]:
    """Cases for the device-hash route: messages of 47/48 and 175/176
    bytes (R ‖ A ‖ M of 111/112 and 239/240 bytes straddle SHA-512's one-
    and two-block edges: 111 + 17 = 128), an empty message, a corrupted
    one at each edge, and torsioned keys whose verdict depends on h mod L
    being exact."""
    rng = np.random.default_rng(seed)
    out: List[Case] = []
    for i, n in enumerate((0, 47, 48, 175, 176)):
        k = ed.gen_priv_key_from_secret(b"dh-edge-%d" % i)
        m = rng.bytes(n)
        s = k.sign(m)
        out.append((f"valid_len_{n}", k.pub_key().bytes(), m, s))
        out.append((f"corrupt_len_{n}", k.pub_key().bytes(), m, _flip(s, 33, 0x02)))
    out.append(_torsioned_signature(0x1F2E3D4C, b"torsion-", True))
    out.append(_torsioned_signature(0x5A6B7C8D, b"torsion-", False))
    return out


# (label, key bytes, R bytes, s, h, verdict): one lane of the resident route's
# R ‖ S ‖ h rows, with the key it is verified against
ResidentCase = Tuple[str, bytes, bytes, int, int, bool]


def _no_root_y() -> int:
    y = 2
    while purepy._recover_x(y, 0) is not None:
        y += 1
    return y


def resident_r_cases() -> List[ResidentCase]:
    """Lanes for each way R can fail the projective compare that replaces
    encode-and-compare, on keys whose result is known: with the identity
    key and s = 0, [s]B + [h](−A) is the identity, so R = y 1 accepts and
    R with y = p + 1 (not below p), with y = 1 and the sign bit set (x = 0
    negative), and with a y that has no root reject; with a key A, s = 5
    and h = 0 the result is 5·B, so its encoding accepts and the encoding
    with the sign bit flipped (x mismatch) or of 6·B (a valid R that does
    not match) rejects. The verdict is the byte compare of the reference."""
    p = purepy.P
    ident = (1).to_bytes(32, "little")
    key = ed.gen_priv_key_from_secret(b"resident-r").pub_key().bytes()
    five = purepy.pt_encode(purepy.pt_mul(5, purepy.B))
    rows = [
        ("r_identity", ident, ident, 0, 7),
        ("r_y_not_below_p", ident, (p + 1).to_bytes(32, "little"), 0, 7),
        ("r_x_zero_sign_set", ident, (1 | 1 << 255).to_bytes(32, "little"), 0, 7),
        ("r_no_root", ident, _no_root_y().to_bytes(32, "little"), 0, 7),
        ("r_match", key, five, 5, 0),
        ("r_sign_flipped", key, _flip(five, 31, 0x80), 5, 0),
        ("r_other_point", key, purepy.pt_encode(purepy.pt_mul(6, purepy.B)), 5, 0),
    ]
    out: List[ResidentCase] = []
    for label, pk, r, s_, h in rows:
        a = purepy.pt_decode(pk)
        want = a is not None and purepy.pt_encode(
            purepy.pt_add(purepy.pt_mul(s_, purepy.B), purepy.pt_mul(h, purepy.pt_neg(a)))
        ) == r
        out.append((label, pk, r, s_, h, want))
    return out


def resident_rows(cases: List[ResidentCase]) -> np.ndarray:
    """The R ‖ S ‖ h rows u8[96, B] of ``resident_r_cases`` lanes."""
    cols = [c[2] + c[3].to_bytes(32, "little") + c[4].to_bytes(32, "little") for c in cases]
    return np.frombuffer(b"".join(cols), np.uint8).reshape(len(cases), 96).T.copy()


def wire_rows(cases: List[ResidentCase]) -> np.ndarray:
    """The compact wire u8[128, B] (A ‖ R ‖ S ‖ h) of ``resident_r_cases``
    lanes, each with its key: what the wire-key kernels take when h comes
    from the host."""
    cols = [c[1] + c[2] + c[3].to_bytes(32, "little") + c[4].to_bytes(32, "little") for c in cases]
    return np.frombuffer(b"".join(cols), np.uint8).reshape(len(cases), 128).T.copy()


def r_signature_cases() -> List[Case]:
    """``resident_r_cases``' R values as signatures, for the routes that
    hash R ‖ A ‖ M themselves: under the identity key [h](−A) is the
    identity whatever h is, so the lane's verdict is the byte compare of R
    with the encoding of [s]B, and every way R can fail the projective
    compare (y not below p, x = 0 with the sign bit set, no root, the sign
    bit flipped, another valid point) reaches the card as a signature."""
    ident = (1).to_bytes(32, "little")
    return [
        (label, ident, b"wire-r-%d" % i, r + s_.to_bytes(32, "little"))
        for i, (label, _, r, s_, _, _) in enumerate(resident_r_cases())
    ]


# --- secp256k1 ------------------------------------------------------------------


def _is_square(v: int) -> bool:
    return pow(v, (secp.P - 1) // 2, secp.P) in (0, 1)


def _secp_sig(r: int, s: int) -> bytes:
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def secp256k1_cases(seed: int = 13) -> Tuple[List[Case], List[WireCase]]:
    """(signature-level cases, wire-level cases).

    Signature level, held against the CPU verifier: valid signatures
    (keys of both prefixes, an empty message); one flipped bit in r, in s
    and in the message; the wrong key; the key's other parity; high S
    (n - s of a valid signature); r or s equal to 0 or n; prefixes 0x04
    and 0x00; 32- and 34-byte keys; a 63-byte signature; x = p and
    x = 2^256 - 1; an x whose x³ + 7 is not a square.

    Wire level, with the verdict each must give: Q with x = n + k
    (x³ + 7 a square), u1 = 0, u2 = 1 and r = k accepts through the r + n
    branch with flags bit 1 set and rejects with it clear; Q = G, u1 = 1,
    u2 = n - 1 makes R' the point at infinity and rejects. Then lanes
    whose partial sums (the GLV terms |k1|·Q and |k2|·λQ, and u1's two
    halves times G and 2^128·G) are equal, opposite or zero: Q = G with
    u1 = u2 = 5 (equal terms, R' = 10·G), with u1 = n − 5 and u2 = 5
    (opposite, R' infinite), with u2 = λ (k1 = 0) and with u2 = 1 + λ, a
    key with u2 = 0 and with u1 = 0, and u2 = n + 3 (reduced mod n on the
    card), each with r = x(R') so that it accepts, or, for R' infinite,
    rejects."""
    rng = np.random.default_rng(seed)
    n, p = secp.N, secp.P
    keys, i = [], 0
    while len({k.pub_key().bytes()[0] for k in keys}) < 2 or len(keys) < 4:
        keys.append(secp.gen_priv_key_from_secret(b"secp-edge-%d" % i))
        i += 1
    pks = [k.pub_key().bytes() for k in keys]
    msgs = [rng.bytes(int(rng.integers(1, 120))) for _ in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    r0, s0 = int.from_bytes(sigs[0][:32], "big"), int.from_bytes(sigs[0][32:], "big")
    x0 = pks[0][1:]
    bad_x = int.from_bytes(rng.bytes(32), "big") % p
    while _is_square((pow(bad_x, 3, p) + 7) % p):
        bad_x = (bad_x + 1) % p
    cases: List[Case] = [("valid", pk, m, sg) for pk, m, sg in zip(pks, msgs, sigs)]
    cases += [
        ("valid_empty_msg", pks[1], b"", keys[1].sign(b"")),
        ("flip_r", pks[0], msgs[0], _flip(sigs[0], 7, 0x10)),
        ("flip_s", pks[1], msgs[1], _flip(sigs[1], 40, 0x01)),
        ("flip_msg", pks[2], _flip(msgs[2], 0, 0x80), sigs[2]),
        ("wrong_key", pks[3], msgs[0], sigs[0]),
        ("other_parity", bytes([pks[0][0] ^ 1]) + x0, msgs[0], sigs[0]),
        ("high_s", pks[0], msgs[0], _secp_sig(r0, n - s0)),
        ("r_zero", pks[0], msgs[0], _secp_sig(0, s0)),
        ("r_n", pks[0], msgs[0], _secp_sig(n, s0)),
        ("s_zero", pks[0], msgs[0], _secp_sig(r0, 0)),
        ("s_n", pks[0], msgs[0], _secp_sig(r0, n)),
        ("prefix_04", b"\x04" + x0, msgs[0], sigs[0]),
        ("prefix_00", b"\x00" + x0, msgs[0], sigs[0]),
        ("key_32_bytes", pks[0][:32], msgs[0], sigs[0]),
        ("key_34_bytes", pks[0] + b"\x00", msgs[0], sigs[0]),
        ("sig_63_bytes", pks[0], msgs[0], sigs[0][:63]),
        ("x_is_p", b"\x02" + p.to_bytes(32, "big"), msgs[0], sigs[0]),
        ("x_all_ones", b"\x03" + b"\xff" * 32, msgs[0], sigs[0]),
        ("x_not_on_curve", b"\x02" + bad_x.to_bytes(32, "big"), msgs[0], sigs[0]),
    ]
    k = 1
    while not _is_square((pow(n + k, 3, p) + 7) % p):
        k += 1
    wire: List[WireCase] = [
        ("r_plus_n", n + k, k, 0, 1, 2, True),
        ("r_plus_n_flag_clear", n + k, k, 0, 1, 0, False),
        ("infinity", secp.GX, 1, 1, n - 1, (secp.GY & 1) | 2, False),
    ]
    lam = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
    g = (secp.GX, secp.GY)
    q = secp._decompress(pks[2])
    for label, pt, u1, u2 in (
        ("equal_terms", g, 5, 5),
        ("opposite_terms", g, n - 5, 5),
        ("u2_lambda", g, 0, lam),
        ("u2_one_plus_lambda", g, 7, 1 + lam),
        ("u2_zero", q, 11, 0),
        ("u1_zero", q, 0, 12345),
        ("u2_above_n", g, 0, n + 3),
    ):
        r_pt = secp._joint_mul(u1, u2 % n, pt)
        flags = pt[1] & 1
        if r_pt is None:
            wire.append((label, pt[0], 1, u1, u2, flags | 2, False))
            continue
        x = r_pt[0]
        r = x if x < n else x - n
        flags |= 2 if r + n < p else 0
        wire.append((label, pt[0], r, u1, u2, flags, True))
    return cases, wire


def secp256k1_mixed(n: int = 40, seed: int = 17) -> List[Case]:
    """n secp256k1 signatures over random messages; every third has one
    bit flipped."""
    rng = np.random.default_rng(seed)
    out: List[Case] = []
    for i in range(n):
        k = secp.gen_priv_key_from_secret(b"secp-mixed-%d" % i)
        m = rng.bytes(int(rng.integers(0, 200)))
        s = k.sign(m)
        label = "valid"
        if i % 3 == 0:
            s = _flip(s, int(rng.integers(0, 64)), 1 << int(rng.integers(0, 8)))
            label = "flipped"
        out.append((label, k.pub_key().bytes(), m, s))
    return out


def secp256k1_wire(cases: List[WireCase]) -> Tuple[np.ndarray, np.ndarray, List[bool]]:
    """Wire-level cases → (wire u8[128, B], flags int32[B], verdicts), in
    the layout of ``secp256k1_batch.prepare_batch``."""
    rows = [b"".join(v.to_bytes(32, "little") for v in c[1:5]) for c in cases]
    wire = np.frombuffer(b"".join(rows), np.uint8).reshape(len(cases), 128).T.copy()
    return wire, np.array([c[5] for c in cases], np.int32), [c[6] for c in cases]


# --- sr25519 ----------------------------------------------------------------------


def _sr_decode_failure(s_enc: int) -> str:
    """Why the ristretto255 decode of a canonical, even encoding fails
    ("" when it decodes), following crypto/sr25519.py:_decode."""
    p = sr.P
    ss = s_enc * s_enc % p
    u1, u2 = (1 - ss) % p, (1 + ss) % p
    u2_sqr = u2 * u2 % p
    v = ((-(sr.D * u1 % p * u1)) % p - u2_sqr) % p
    was_square, invsqrt = sr._sqrt_ratio_m1(1, v * u2_sqr % p)
    den_x = invsqrt * u2 % p
    x = 2 * s_enc * den_x % p
    x = p - x if sr._is_negative(x) else x
    y = u1 * (invsqrt * den_x % p * v % p) % p
    if not was_square:
        return "not_square"
    if sr._is_negative(x * y % p):
        return "negative_t"
    return "y_zero" if y == 0 else ""


def _sr_encodings(rng) -> dict:
    """One even encoding below p for each way a decode fails, searched
    from the seed, and y = 0 (s = p − 1)."""
    found = {"y_zero": sr.P - 1}
    while len(found) < 3:
        enc = int.from_bytes(rng.bytes(32), "little") % sr.P & ~1
        why = _sr_decode_failure(enc)
        if why:
            found.setdefault(why, enc)
    return {k: v.to_bytes(32, "little") for k, v in found.items()}


def _sr_sig(r_enc: bytes, s: int, marker: bool = True) -> bytes:
    return r_enc + (s | ((1 << 255) if marker else 0)).to_bytes(32, "little")


def sr25519_cases(seed: int = 19) -> List[Case]:
    """Valid signatures; a corrupted R, a corrupted s and a corrupted
    message; the wrong key; the format bit cleared; s + L; A or R at or
    above p, odd ("negative"), and even and canonical but failing to
    decode (not a square, t negative, y = 0); the identity (all zeros) as
    A, with a signature that verifies against it and one that does not;
    keys of 31 and 33 bytes and signatures of 63 and 65 bytes."""
    rng = np.random.default_rng(seed)
    keys = [sr.gen_priv_key_from_secret(b"sr-edge-%d" % i) for i in range(4)]
    pks = [k.pub_key().bytes() for k in keys]
    msgs = [rng.bytes(int(rng.integers(0, 120))) for _ in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    r0, s0 = sigs[0][:32], int.from_bytes(sigs[0][32:], "little") & ((1 << 255) - 1)
    p = sr.P
    above_p = (p + 1).to_bytes(32, "little")  # even, >= p
    ident = bytes(32)
    crafted_s = 4242
    crafted = _sr_sig(sr._encode(sr._mul(crafted_s, sr._BASE)), crafted_s)
    cases: List[Case] = [("valid", pk, m, sg) for pk, m, sg in zip(pks, msgs, sigs)]
    cases += [
        ("valid_empty_msg", pks[1], b"", keys[1].sign(b"")),
        ("corrupt_r", pks[0], msgs[0], _flip(sigs[0], 5, 0x10)),
        ("corrupt_s", pks[1], msgs[1], _flip(sigs[1], 40, 0x01)),
        ("corrupt_msg", pks[2], _flip(msgs[2] + b"!", 0, 0x01), sigs[2]),
        ("wrong_key", pks[3], msgs[0], sigs[0]),
        ("format_bit_clear", pks[0], msgs[0], _sr_sig(r0, s0, marker=False)),
        ("s_plus_l", pks[0], msgs[0], _sr_sig(r0, s0 + sr.L)),
        ("a_above_p", above_p, msgs[0], sigs[0]),
        ("r_above_p", pks[0], msgs[0], _sr_sig(above_p, s0)),
        ("a_odd", _flip(pks[0], 0, 0x01), msgs[0], sigs[0]),
        ("r_odd", pks[0], msgs[0], _flip(sigs[0], 0, 0x01)),
        ("identity_key", ident, b"any message", crafted),
        ("identity_key_wrong_sig", ident, msgs[0], sigs[0]),
        ("key_31_bytes", pks[0][:31], msgs[0], sigs[0]),
        ("key_33_bytes", pks[0] + b"\x00", msgs[0], sigs[0]),
        ("sig_63_bytes", pks[0], msgs[0], sigs[0][:63]),
        ("sig_65_bytes", pks[0], msgs[0], sigs[0] + b"\x80"),
    ]
    for why, enc in sorted(_sr_encodings(rng).items()):
        cases.append((f"a_{why}", enc, msgs[0], sigs[0]))
        cases.append((f"r_{why}", pks[0], msgs[0], _sr_sig(enc, s0)))
    return cases


def sr25519_mixed(n: int = 40, seed: int = 23) -> List[Case]:
    """n sr25519 signatures over random messages; every third has one bit
    flipped."""
    rng = np.random.default_rng(seed)
    out: List[Case] = []
    for i in range(n):
        k = sr.gen_priv_key_from_secret(b"sr-mixed-%d" % i)
        m = rng.bytes(int(rng.integers(0, 200)))
        s = k.sign(m)
        label = "valid"
        if i % 3 == 0:
            s = _flip(s, int(rng.integers(0, 64)), 1 << int(rng.integers(0, 8)))
            label = "flipped"
        out.append((label, k.pub_key().bytes(), m, s))
    return out
