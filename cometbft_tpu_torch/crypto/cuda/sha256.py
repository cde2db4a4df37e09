"""Batched SHA-256 of pre-padded messages: the padding helpers, the plain
torch compression, and the wrapper around the CUDA kernel.

Reference: cometbft_tpu/crypto/tpu/sha256.py (``_compress`` :56,
``_sha256_blocks_xla`` :123, ``sha256_blocks_ragged`` :150, the numpy
padding :166-225) and sha256_pallas.py (the Pallas kernel behind
``CBFT_TPU_SHA=pallas``). One CUDA kernel, ``csrc/sha256.cu``, serves both
forms: fixed blocks, and ragged blocks with a per-lane live count.

Tensors: blocks are int32[B, n_blocks, 16] holding the big-endian u32
words' bit patterns, n_live int32[B], digests int32[B, 8] (bit patterns
again). ``to_u32`` and ``from_u32`` convert to and from numpy uint32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from cometbft_tpu_torch.crypto.cuda import build

# launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
_M32 = 0xFFFFFFFF


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit patterns (any device) → numpy uint32."""
    return t.cpu().numpy().view(np.uint32)


def from_u32(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy uint32 → int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint32).view(np.int32)).to(device)


# --- host padding (reference sha256.py:166-225) -----------------------------


def pad_ragged_np(items, prefix: bytes = b""):
    """Variable-length messages (each prefixed) → (blocks u32[B, max_blocks,
    16], n_live int32[B]); SHA-256 padding baked in at each length.

    No Python loop over the items: their bytes are joined once and
    scattered into the rows by one index array; the 0x80 terminators and
    the bit lengths (the last two words of each row's last block) are
    set by index too."""
    n = len(items)
    plen = len(prefix)
    item_lens = np.fromiter(map(len, items), np.int64, count=n)
    lens = item_lens + plen
    nblocks = np.maximum((lens + 1 + 8 + 63) // 64, 1).astype(np.int32)
    max_blocks = int(nblocks.max()) if n else 1
    width = max_blocks * 64
    buf = np.zeros((n, width), np.uint8)
    flat = buf.reshape(-1)
    row_starts = np.arange(n, dtype=np.int64) * width
    data = np.frombuffer(b"".join(items), np.uint8)
    if data.size:
        item_starts = np.cumsum(item_lens) - item_lens
        shift = np.repeat(row_starts + plen - item_starts, item_lens)
        flat[np.arange(data.size, dtype=np.int64) + shift] = data
    if plen:
        buf[:, :plen] = np.frombuffer(prefix, np.uint8)
    flat[row_starts + lens] = 0x80
    packed = buf.view(">u4").astype(np.uint32).reshape(n, max_blocks, 16)
    rows, last = np.arange(n), nblocks - 1
    packed[rows, last, 14] = (lens * 8) >> 32  # the bit length, big-endian, ends the last block
    packed[rows, last, 15] = (lens * 8) & 0xFFFFFFFF
    return packed, nblocks


def pad_messages_np(msgs: np.ndarray, msg_len: int) -> np.ndarray:
    """uint8[B, msg_len] → u32[B, n_blocks, 16] with SHA-256 padding."""
    n = msgs.shape[0]
    total = ((msg_len + 8) // 64 + 1) * 64
    buf = np.zeros((n, total), np.uint8)
    buf[:, :msg_len] = msgs
    buf[:, msg_len] = 0x80
    buf[:, -8:] = np.frombuffer((msg_len * 8).to_bytes(8, "big"), np.uint8)
    words = buf.reshape(n, total // 64, 16, 4)
    return (
        (words[..., 0].astype(np.uint32) << 24)
        | (words[..., 1].astype(np.uint32) << 16)
        | (words[..., 2].astype(np.uint32) << 8)
        | words[..., 3].astype(np.uint32)
    )


def digests_to_bytes_np(digests: np.ndarray) -> np.ndarray:
    """u32[B, 8] → uint8[B, 32] big-endian."""
    d = np.asarray(digests, np.uint32)
    return d.astype(">u4").view(np.uint8).reshape(d.shape[:-1] + (32,))


# --- plain torch version ----------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def compress_plain(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """state int64[..., 8], block int64[..., 16] (u32 values) → int64[..., 8]."""
    w = list(block.unbind(-1))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for i in range(64):
        s1e = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((~e & _M32) & g)
        t1 = (h + s1e + ch + _K[i] + w[i]) & _M32
        s0a = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0a + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)) & _M32


def sha256_blocks_plain(
    blocks: torch.Tensor, n_live: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The torch twin of the kernel: int32[B, nb, 16] (+ int32[B]) →
    int32[B, 8], bit patterns in and out."""
    words = blocks.to(torch.int64) & _M32
    state = torch.tensor(IV, dtype=torch.int64, device=blocks.device).expand(
        blocks.shape[0], 8
    )
    for i in range(blocks.shape[1]):
        new = compress_plain(state, words[:, i])
        if n_live is None:
            state = new
        else:
            state = torch.where((i < n_live.to(torch.int64))[:, None], new, state)
    return as_int32(state)


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values → int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# --- the kernel wrapper -----------------------------------------------------

_SIGNATURES = {
    "cbt_sha256_blocks": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}


def sha256_blocks(
    blocks: torch.Tensor, n_live: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Digests int32[B, 8] of blocks int32[B, n_blocks, 16]; with n_live
    (int32[B]) lane b compresses only its first n_live[b] blocks.

    On CUDA tensors this launches ``sha256_blocks`` (one thread per
    message) on the current stream, or raises; CPU tensors run
    ``sha256_blocks_plain``."""
    global LAUNCHES
    if blocks.device.type == "cpu":
        return sha256_blocks_plain(blocks, n_live)
    build.require_cuda_tensor(blocks, "sha256 blocks", torch.int32, 3)
    batch, n_blocks, width = blocks.shape
    if width != 16:
        raise ValueError(f"sha256 blocks: expected 16 words per block, got {width}")
    live_ptr = None
    if n_live is not None:
        build.require_cuda_tensor(n_live, "sha256 n_live", torch.int32, 1)
        if n_live.shape[0] != batch or n_live.device != blocks.device:
            raise ValueError("sha256 n_live: expected one count per lane, on the blocks' device")
        live_ptr = n_live.data_ptr()
    out = torch.empty((batch, 8), dtype=torch.int32, device=blocks.device)
    if batch == 0:
        return out
    lib = build.load("sha256", _SIGNATURES)
    rc = lib.cbt_sha256_blocks(
        blocks.data_ptr(), live_ptr, out.data_ptr(), batch, n_blocks,
        build.stream_ptr(blocks.device),
    )
    build.check(rc, "sha256_blocks")
    LAUNCHES += 1
    return out
