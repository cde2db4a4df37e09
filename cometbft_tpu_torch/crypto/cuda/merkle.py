"""RFC-6962 Merkle root on the card: ``merkle_tree`` hashes the leaves and
every level in one launch; ``merkle_level`` hashes one level.

Reference: cometbft_tpu/crypto/tpu/merkle.py (``_tree_reduce`` :103,
``_tree_kernel`` :135, ``_leaves_and_tree_kernel`` :141). Each level hashes
the pairs 0x01 ‖ left ‖ right and carries an odd tail up unhashed, which
gives the host tree's shape (crypto/merkle.py, split at the largest power
of two below n) for every n. The reference pads to a power of two and runs
a fixed log2(P) levels in one program; ``merkle_tree`` runs the live levels
in one thread block, with no padding. ``hash_from_byte_slices`` on the card
packs the leaf blocks and their live counts into one pinned staging buffer,
copies it to the card once, launches ``merkle_tree`` once and reads back
the 32-byte root.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Sequence

import numpy as np
import torch

from cometbft_tpu_torch.crypto.cuda import build, sha256

LEAF_PREFIX = b"\x00"

# launches of the merkle_level and merkle_tree kernels (the plain versions
# do not count)
LAUNCHES = 0
TREE_LAUNCHES = 0


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
    # blocks, n_live, n, nb, scratch, root, stream
    "cbt_merkle_tree": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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


def merkle_tree_plain(blocks: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """The torch twin of ``merkle_tree``: ``sha256_blocks_plain`` of the
    leaves, then ``merkle_level_plain`` until one node is left."""
    level = sha256.sha256_blocks_plain(blocks, n_live)
    while level.shape[0] > 1:
        level = merkle_level_plain(level)
    return level[0]


def merkle_tree(blocks: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """The root int32[8] of the padded 0x00 ‖ item leaf blocks int32[n, nb,
    16] and their live block counts int32[n] (n >= 1).

    On CUDA tensors this launches ``merkle_tree`` (one thread block: the
    leaves and every level) on the current stream, or raises; CPU tensors
    run ``merkle_tree_plain``."""
    global TREE_LAUNCHES
    if blocks.device.type == "cpu":
        return merkle_tree_plain(blocks, n_live)
    build.require_cuda_tensor(blocks, "merkle leaf blocks", torch.int32, 3)
    build.require_cuda_tensor(n_live, "merkle leaf n_live", torch.int32, 1)
    n, nb, width = blocks.shape
    if n < 1 or nb < 1 or width != 16 or n_live.shape[0] != n or n_live.device != blocks.device:
        raise ValueError(
            f"merkle leaves: expected blocks [n >= 1, nb >= 1, 16] and n_live [n] on one device, "
            f"got {tuple(blocks.shape)} and {tuple(n_live.shape)} on {n_live.device}"
        )
    dev = blocks.device
    root = torch.empty(8, dtype=torch.int32, device=dev)
    # the levels of a tree too large for the kernel's shared memory
    scratch = torch.empty((n + (n + 1) // 2, 8), dtype=torch.int32, device=dev)
    lib = build.load("merkle", _SIGNATURES)
    rc = lib.cbt_merkle_tree(
        blocks.data_ptr(), n_live.data_ptr(), n, nb, scratch.data_ptr(), root.data_ptr(), build.stream_ptr(dev)
    )
    build.check(rc, "merkle_tree")
    TREE_LAUNCHES += 1
    return root


def _root_bytes(root: torch.Tensor) -> bytes:
    return sha256.digests_to_bytes_np(sha256.to_u32(root)[None, :])[0].tobytes()


def hash_from_byte_slices(items: Sequence[bytes], device="cuda") -> bytes:
    """The RFC-6962 root of ``items`` (reference: crypto/merkle/tree.go:9
    HashFromByteSlices), computed on ``device``: on a CUDA device one
    host-to-device copy of a pinned staging buffer (the leaf blocks, then
    their live counts), one ``merkle_tree`` launch and one 32-byte read
    back; on the CPU ``merkle_tree_plain``."""
    if not items:
        return hashlib.sha256(b"").digest()
    blocks, n_live = sha256.pad_ragged_np(items, prefix=LEAF_PREFIX)
    dev = torch.device(device)
    if dev.type == "cpu":
        return _root_bytes(merkle_tree(sha256.from_u32(blocks), torch.from_numpy(n_live)))
    words = blocks.size
    staging = torch.empty(words + n_live.size, dtype=torch.int32, pin_memory=True)
    host = staging.numpy()
    host[:words] = blocks.reshape(-1).view(np.int32)
    host[words:] = n_live
    on_card = staging.to(dev, non_blocking=True)
    root = merkle_tree(on_card[:words].view(blocks.shape), on_card[words:])
    return _root_bytes(root)
