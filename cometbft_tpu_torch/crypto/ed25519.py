"""Ed25519 keys — the consensus default key type.

Reference: cometbft_tpu/crypto/ed25519.py (crypto/ed25519/ed25519.go —
Sign :57, VerifySignature :148, GenPrivKeyFromSecret; Address =
SumTruncated(pubkey) :140). Signing and the CPU verify run on the port's
pure-Python rung (crypto/purepy.py), whose accept/reject equals the
reference's OpenSSL-backed CPU verifier.
"""

from __future__ import annotations

import secrets

from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import PrivKey, PubKey, address_hash, purepy, sha256

KEY_TYPE = "ed25519"
PUB_KEY_SIZE = 32
PRIVATE_KEY_SIZE = 64  # seed || pubkey, as Go's ed25519.PrivateKey
SIGNATURE_SIZE = 64
SEED_SIZE = 32


class PubKeyEd25519(PubKey):
    def __init__(self, key_bytes: bytes):
        if len(key_bytes) != PUB_KEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUB_KEY_SIZE} bytes")
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
        mask = native.ed25519_verify_batch([self._bytes], [msg], [sig], nthreads=1)
        if mask is not None:
            return mask[0]
        native.count_purepy()
        return purepy.ed25519_verify(self._bytes, msg, sig)

    def __repr__(self) -> str:
        return f"PubKeyEd25519{{{self._bytes.hex().upper()}}}"


class PrivKeyEd25519(PrivKey):
    def __init__(self, key_bytes: bytes):
        # accept 64-byte Go-style (seed||pub) or 32-byte seed
        if len(key_bytes) == SEED_SIZE:
            seed = bytes(key_bytes)
            pub = native.ed25519_pub_from_seed(seed)
            key_bytes = seed + (pub if pub is not None else purepy.ed25519_public_from_seed(seed))
        if len(key_bytes) != PRIVATE_KEY_SIZE:
            raise ValueError(f"ed25519 privkey must be {PRIVATE_KEY_SIZE} bytes")
        self._bytes = bytes(key_bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        """Reference: crypto/ed25519/ed25519.go:57."""
        sig = native.ed25519_sign(self._bytes[:SEED_SIZE], msg)
        if sig is not None:
            return sig
        return purepy.ed25519_sign(
            self._bytes[:SEED_SIZE], self._bytes[SEED_SIZE:], msg
        )

    def pub_key(self) -> PubKeyEd25519:
        return PubKeyEd25519(self._bytes[SEED_SIZE:])

    def type(self) -> str:
        return KEY_TYPE


def verify_many(items) -> list:
    """The CPU batch path over (PubKeyEd25519, msg, sig) triples
    (reference crypto/ed25519.py:156 verify_many): one native call over
    up to 16 threads when the native rung is live, else pure Python lane
    by lane. Each verdict equals ``verify_signature``'s."""
    if not items:
        return []
    mask = native.ed25519_verify_batch(
        [pk.bytes() for pk, _, _ in items], [m for _, m, _ in items], [s for _, _, s in items]
    )
    if mask is not None:
        return mask
    native.count_purepy(len(items))
    return [
        len(s) == SIGNATURE_SIZE and purepy.ed25519_verify(pk.bytes(), m, s)
        for pk, m, s in items
    ]


def gen_priv_key() -> PrivKeyEd25519:
    """Reference: GenPrivKey — a seed from the OS's CSPRNG."""
    return PrivKeyEd25519(secrets.token_bytes(SEED_SIZE))


def gen_priv_key_from_secret(secret: bytes) -> PrivKeyEd25519:
    """Deterministic keygen (reference: GenPrivKeyFromSecret —
    seed = SHA256(secret))."""
    return PrivKeyEd25519(sha256(secret))
