"""RFC-6962 Merkle root on the card: leaf hashing through ``sha256_blocks``
(ragged form), then one ``merkle_level`` launch per tree level.

Reference: cometbft_tpu/crypto/tpu/merkle.py (``_tree_reduce`` :103,
``_tree_kernel`` :135, ``_leaves_and_tree_kernel`` :141). Each level hashes
the pairs 0x01 ‖ left ‖ right and carries an odd tail up unhashed, which
gives the host tree's shape (crypto/merkle.py, split at the largest power
of two below n) for every n. The reference pads to a power of two and runs
a fixed log2(P) levels in one program; here the host loops over the live
levels, ceil(log2 n) launches, with no padding.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Sequence

import torch

from cometbft_tpu_torch.crypto.cuda import build, sha256

LEAF_PREFIX = b"\x00"

# launches of the merkle_level kernel (the plain version does not count)
LAUNCHES = 0


def _inner_blocks(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """left/right int64[m, 8] u32 digests → int64[m, 2, 16] padded blocks of
    the 65-byte message 0x01 ‖ left ‖ right."""
    m32 = 0xFFFFFFFF
    words = [((0x01 << 24) | (left[:, 0] >> 8)) & m32]
    for i in range(1, 8):
        words.append((((left[:, i - 1] & 0xFF) << 24) | (left[:, i] >> 8)) & m32)
    words.append((((left[:, 7] & 0xFF) << 24) | (right[:, 0] >> 8)) & m32)
    for i in range(1, 8):
        words.append((((right[:, i - 1] & 0xFF) << 24) | (right[:, i] >> 8)) & m32)
    zero = torch.zeros_like(left[:, 0])
    tail = [((right[:, 7] & 0xFF) << 24) | (0x80 << 16)] + [zero] * 14
    tail.append(torch.full_like(zero, 65 * 8))
    return torch.stack([torch.stack(words, -1), torch.stack(tail, -1)], dim=1)


def merkle_level_plain(digests: torch.Tensor) -> torch.Tensor:
    """The torch twin of the kernel: int32[m, 8] → int32[(m+1)//2, 8]."""
    d = digests.to(torch.int64) & 0xFFFFFFFF
    m = d.shape[0]
    pairs = m // 2
    state = torch.tensor(sha256.IV, dtype=torch.int64, device=d.device).expand(pairs, 8)
    blocks = _inner_blocks(d[0 : 2 * pairs : 2], d[1 : 2 * pairs : 2])
    for i in range(2):
        state = sha256.compress_plain(state, blocks[:, i])
    out = sha256.as_int32(state)
    if m & 1:
        out = torch.cat([out, digests[m - 1 :].to(torch.int32)], dim=0)
    return out


_SIGNATURES = {
    "cbt_merkle_level": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    ],
}


def merkle_level(digests: torch.Tensor) -> torch.Tensor:
    """One tree level, int32[m, 8] → int32[(m+1)//2, 8].

    On a CUDA tensor this launches ``merkle_level`` (one thread per output
    node) on the current stream, or raises; a CPU tensor runs
    ``merkle_level_plain``."""
    global LAUNCHES
    if digests.device.type == "cpu":
        return merkle_level_plain(digests)
    build.require_cuda_tensor(digests, "merkle digests", torch.int32, 2)
    m = digests.shape[0]
    if digests.shape[1] != 8 or m < 1:
        raise ValueError(f"merkle digests: expected [m >= 1, 8], got {tuple(digests.shape)}")
    out = torch.empty(((m + 1) // 2, 8), dtype=torch.int32, device=digests.device)
    lib = build.load("merkle", _SIGNATURES)
    rc = lib.cbt_merkle_level(
        digests.data_ptr(), out.data_ptr(), m, build.stream_ptr(digests.device)
    )
    build.check(rc, "merkle_level")
    LAUNCHES += 1
    return out


def root_from_leaves(blocks: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """Padded 0x00 ‖ item leaf blocks int32[n, nb, 16] and their live block
    counts int32[n] (n >= 1) → the root, int32[8]."""
    level = sha256.sha256_blocks(blocks, n_live)
    while level.shape[0] > 1:
        level = merkle_level(level)
    return level[0]


def hash_from_byte_slices(items: Sequence[bytes], device="cuda") -> bytes:
    """The RFC-6962 root of ``items`` (reference: crypto/merkle/tree.go:9
    HashFromByteSlices), computed on ``device``."""
    if not items:
        return hashlib.sha256(b"").digest()
    blocks, n_live = sha256.pad_ragged_np(items, prefix=LEAF_PREFIX)
    root = root_from_leaves(
        sha256.from_u32(blocks, device),
        torch.from_numpy(n_live).to(device),
    )
    return sha256.digests_to_bytes_np(sha256.to_u32(root)[None, :])[0].tobytes()
