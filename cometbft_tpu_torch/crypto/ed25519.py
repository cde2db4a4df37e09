"""Ed25519 keys — the consensus default key type.

Reference: cometbft_tpu/crypto/ed25519.py (crypto/ed25519/ed25519.go —
Sign :57, VerifySignature :148, GenPrivKeyFromSecret; Address =
SumTruncated(pubkey) :140). Signing and the CPU verify run on the port's
pure-Python rung (crypto/purepy.py), whose accept/reject equals the
reference's OpenSSL-backed CPU verifier.
"""

from __future__ import annotations

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
        return purepy.ed25519_verify(self._bytes, msg, sig)

    def __repr__(self) -> str:
        return f"PubKeyEd25519{{{self._bytes.hex().upper()}}}"


class PrivKeyEd25519(PrivKey):
    def __init__(self, key_bytes: bytes):
        # accept 64-byte Go-style (seed||pub) or 32-byte seed
        if len(key_bytes) == SEED_SIZE:
            seed = bytes(key_bytes)
            key_bytes = seed + purepy.ed25519_public_from_seed(seed)
        if len(key_bytes) != PRIVATE_KEY_SIZE:
            raise ValueError(f"ed25519 privkey must be {PRIVATE_KEY_SIZE} bytes")
        self._bytes = bytes(key_bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        """Reference: crypto/ed25519/ed25519.go:57."""
        return purepy.ed25519_sign(
            self._bytes[:SEED_SIZE], self._bytes[SEED_SIZE:], msg
        )

    def pub_key(self) -> PubKeyEd25519:
        return PubKeyEd25519(self._bytes[SEED_SIZE:])

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key_from_secret(secret: bytes) -> PrivKeyEd25519:
    """Deterministic keygen (reference: GenPrivKeyFromSecret —
    seed = SHA256(secret))."""
    return PrivKeyEd25519(sha256(secret))
