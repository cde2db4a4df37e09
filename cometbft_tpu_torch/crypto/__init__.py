"""Crypto core (reference: cometbft_tpu/crypto/__init__.py; crypto/crypto.go).

PubKey/PrivKey interfaces, the SHA-256 helper and the 20-byte address
hash. Batch verification lives in ``crypto.batch``; the device kernels in
``crypto.cuda``.
"""

from __future__ import annotations

import hashlib

ADDRESS_SIZE = 20  # crypto/tmhash truncated size (crypto/ed25519/ed25519.go:140)


def sha256(data: bytes) -> bytes:
    """Reference: crypto/hash.go Sha256."""
    return hashlib.sha256(data).digest()


class PubKey:
    """Reference: crypto/crypto.go:22 — Address/Bytes/VerifySignature/Equals/Type."""

    def address(self) -> bytes:
        raise NotImplementedError

    def bytes(self) -> bytes:
        raise NotImplementedError

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def type(self) -> str:
        raise NotImplementedError

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PubKey):
            return NotImplemented
        return self.type() == other.type() and self.bytes() == other.bytes()

    def __hash__(self) -> int:
        return hash((self.type(), self.bytes()))


class PrivKey:
    """Reference: crypto/crypto.go:30 — Bytes/Sign/PubKey/Equals/Type."""

    def bytes(self) -> bytes:
        raise NotImplementedError

    def sign(self, msg: bytes) -> bytes:
        raise NotImplementedError

    def pub_key(self) -> PubKey:
        raise NotImplementedError

    def type(self) -> str:
        raise NotImplementedError

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PrivKey):
            return NotImplemented
        return self.type() == other.type() and self.bytes() == other.bytes()


def address_hash(data: bytes) -> bytes:
    """SumTruncated — first 20 bytes of SHA-256 (crypto/tmhash)."""
    return sha256(data)[:ADDRESS_SIZE]
