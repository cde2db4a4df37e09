"""RFC-6962 Merkle root (reference: cometbft_tpu/crypto/merkle.py;
crypto/merkle/tree.go).

  leaf  = SHA256(0x00 || leaf_bytes)
  inner = SHA256(0x01 || left || right)
  split = largest power of two < n
  empty = SHA256("")

``hash_from_byte_slices`` is the recursive host tree. Given an explicit
CUDA ``device`` it computes the same root on the card
(crypto/cuda/merkle.py) instead; there is no global switch and no size
threshold.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def empty_hash() -> bytes:
    return _sha(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha(INNER_PREFIX + left + right)


def get_split_point(length: int) -> int:
    """Largest power of 2 strictly less than length."""
    if length < 1:
        raise ValueError("length must be >= 1")
    bit = 1 << (length.bit_length() - 1)
    if bit == length:
        bit >>= 1
    return bit


def hash_from_byte_slices(items: Sequence[bytes], device: Optional[object] = None) -> bytes:
    """Reference: crypto/merkle/tree.go:9 HashFromByteSlices. ``device``
    None or CPU: the host tree; a CUDA device: the device route."""
    if device is not None:
        import torch

        if torch.device(device).type == "cuda":
            from cometbft_tpu_torch.crypto.cuda import merkle as cuda_merkle

            return cuda_merkle.hash_from_byte_slices(items, device=device)
    n = len(items)
    if n == 0:
        return empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = get_split_point(n)
    left = hash_from_byte_slices(items[:k])
    right = hash_from_byte_slices(items[k:])
    return inner_hash(left, right)
