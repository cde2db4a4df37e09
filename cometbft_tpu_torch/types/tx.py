"""Transactions.

Reference: cometbft_tpu/types/tx.py (types/tx.go) — Tx is opaque bytes; Tx.Hash() = SHA256 of the raw
bytes (tx.go:29); Txs.Hash() is the RFC-6962 merkle root whose leaves are
the tx *hashes* (tx.go:47-55 — "leaves of merkle tree are TxIDs").
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List

from cometbft_tpu_torch.crypto import merkle


class Tx(bytes):
    def hash(self) -> bytes:
        """types/tx.go Tx.Hash — tmhash of raw bytes."""
        return hashlib.sha256(self).digest()


class Txs(List[Tx]):
    def __init__(self, txs: Iterable[bytes] = ()):  # noqa: D401
        super().__init__(Tx(t) for t in txs)

    def hash(self) -> bytes:
        """types/tx.go:47 Txs.Hash — merkle root over tx hashes."""
        return merkle.hash_from_byte_slices([t.hash() for t in self])

    def proof(self, i: int):
        """types/tx.go Txs.Proof — proof for tx i (leaves are tx hashes)."""
        root, proofs = merkle.proofs_from_byte_slices([t.hash() for t in self])
        return root, proofs[i]

