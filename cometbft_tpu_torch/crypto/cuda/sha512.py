"""SHA-512 for the device-hash route: the host staging helpers and the
plain torch SHA-512 that the CUDA code (``csrc/sha512.cuh``) is held
against.

Reference: cometbft_tpu/crypto/tpu/sha512.py. The staging helpers
``stage_ragged_np`` (:247), ``pad_ragged_np`` (:274) and
``digests_to_bytes_np`` (:313) are copies, byte for byte. The reference
emulates each 64-bit word as a (hi, lo) pair of uint32 planes because the
TPU lanes have no 64-bit integers; the plain version here keeps one int64
tensor per word (the uint64 bit pattern, wrapping arithmetic, masked
right shifts), and the CUDA code uses native ``uint64_t``.

``blocks_from_bytes`` (reference :202) lays each lane's stream
prefix ‖ msg[:mlen] ‖ 0x80 ‖ zeros ‖ 128-bit big-endian bit length into
``max_blocks`` 128-byte blocks; ``sha512_blocks_plain`` (reference
``sha512_blocks`` :167 over ``_compress`` :100) compresses each lane's
first ``n_live`` blocks. A message length outside [0, MP] is clamped and
the live count is capped at ``max_blocks``, exactly as the kernel does,
so neither reads past the message plane.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

_K64 = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
IV64 = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


def _signed(v: int) -> int:
    """uint64 value → the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_K_I64 = [_signed(k) for k in _K64]
_IV_I64 = [_signed(v) for v in IV64]


# --- host staging (reference sha512.py:247-326) -----------------------------


def stage_ragged_np(msgs: Sequence[bytes], prefix_len: int = 64):
    """Raw message bytes for on-device padding: (msg u8[MP, B], mlen
    int32[B]) with MP = max_blocks·128 − prefix_len, so prefix ‖ msg is
    exactly the padded block capacity and every lane's 0x80 terminator
    and length field land inside it."""
    n = len(msgs)
    lens = np.array([len(m) for m in msgs], np.int64)
    if n == 0:
        return np.zeros((128 - prefix_len, 0), np.uint8), lens.astype(np.int32)
    nblocks = np.maximum((prefix_len + lens + 1 + 16 + 127) // 128, 1)
    cap = int(nblocks.max()) * 128 - prefix_len
    buf = np.zeros((n, cap), np.uint8)
    flat = np.frombuffer(b"".join(bytes(m) for m in msgs), np.uint8)
    if flat.size:
        row = np.repeat(np.arange(n), lens)
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        col = np.arange(flat.size, dtype=np.int64) - np.repeat(starts, lens)
        buf[row, col] = flat
    return np.ascontiguousarray(buf.T), lens.astype(np.int32)


def pad_ragged_np(msgs: Sequence[bytes]):
    """Messages padded on the host: (blocks_hi u32[n_blocks, 16, B],
    blocks_lo, n_live int32[B]), the big-endian hi and lo halves of each
    64-bit word."""
    n = len(msgs)
    lens = np.array([len(m) for m in msgs], np.int64)
    nblocks = np.maximum((lens + 1 + 16 + 127) // 128, 1).astype(np.int32)
    max_blocks = int(nblocks.max()) if n else 1
    buf = np.zeros((n, max_blocks * 128), np.uint8)
    for i, m in enumerate(msgs):
        ln = lens[i]
        buf[i, :ln] = np.frombuffer(bytes(m), np.uint8)
        buf[i, ln] = 0x80
        end = int(nblocks[i]) * 128
        bit_len = int(ln) * 8
        buf[i, end - 16 : end] = np.frombuffer(bit_len.to_bytes(16, "big"), np.uint8)
    words = buf.reshape(n, max_blocks, 16, 8).astype(np.uint32)
    hi = (
        (words[..., 0] << 24) | (words[..., 1] << 16)
        | (words[..., 2] << 8) | words[..., 3]
    )
    lo = (
        (words[..., 4] << 24) | (words[..., 5] << 16)
        | (words[..., 6] << 8) | words[..., 7]
    )
    return (
        np.ascontiguousarray(np.moveaxis(hi, 0, -1)),
        np.ascontiguousarray(np.moveaxis(lo, 0, -1)),
        nblocks,
    )


def digests_to_bytes_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi u32[8, B], lo u32[8, B]) → uint8[B, 64] big-endian digests."""
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    b = hi.shape[-1]
    out = np.zeros((b, 64), np.uint8)
    for j in range(8):
        for k, word in ((0, hi[j]), (4, lo[j])):
            base = 8 * j + k
            out[:, base] = word >> 24
            out[:, base + 1] = (word >> 16) & 0xFF
            out[:, base + 2] = (word >> 8) & 0xFF
            out[:, base + 3] = word & 0xFF
    return out


# --- the plain torch SHA-512 ------------------------------------------------


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def _compress(state: List[torch.Tensor], block: torch.Tensor) -> List[torch.Tensor]:
    """One compression: 8 int64[B] state words, block int64[16, B]."""
    w = list(block.unbind(0))
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ _shr(w[t - 15], 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ _shr(w[t - 2], 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K_I64[t] + w[t]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + s0 + maj
    return [s + n for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_blocks_plain(blocks: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """blocks int64[n_blocks, 16, B], n_live int[B] → digest state
    int64[8, B]; a lane stops after its first n_live blocks."""
    batch = blocks.shape[-1]
    state = [torch.full((batch,), v, dtype=torch.int64, device=blocks.device) for v in _IV_I64]
    for i in range(blocks.shape[0]):
        new = _compress(state, blocks[i])
        live = n_live > i
        state = [torch.where(live, n, s) for s, n in zip(state, new)]
    return torch.stack(state, dim=0)


def blocks_from_bytes(
    prefix: torch.Tensor, msg: torch.Tensor, mlen: torch.Tensor, max_blocks: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """prefix u8[P0, B], msg u8[MP, B] (P0 + MP == 128·max_blocks),
    mlen int[B] → (blocks int64[max_blocks, 16, B], n_live int64[B]):
    each lane's stream prefix ‖ msg[:mlen] ‖ 0x80 ‖ zeros ‖ bit length."""
    p0, mp = prefix.shape[0], msg.shape[0]
    total = p0 + mp
    dev = msg.device
    body = torch.cat([prefix, msg], dim=0).to(torch.int64)
    pos = torch.arange(total, dtype=torch.int64, device=dev)[:, None]
    tlen = (mlen.to(torch.int64).clamp(0, mp) + p0)[None, :]
    n_live = torch.clamp((tlen + 17 + 127) // 128, max=max_blocks)
    end = n_live * 128
    b = torch.where(pos < tlen, body, 0)
    b = torch.where(pos == tlen, 0x80, b)
    shift = (end - 1 - pos) * 8
    len_byte = ((tlen * 8) >> shift.clamp(0, 63)) & 0xFF
    in_len = (pos >= end - 16) & (pos < end) & (shift < 64)
    b = torch.where(in_len, len_byte, b)
    b = b.reshape(max_blocks, 16, 8, -1)
    words = b[:, :, 0] << 56
    for k in range(1, 8):
        words = words | (b[:, :, k] << (56 - 8 * k))
    return words, n_live[0]


def digest_bytes(state: torch.Tensor) -> torch.Tensor:
    """Digest state int64[8, B] → int64[64, B] bytes (0..255), in digest
    order: byte 8j + k is the k-th most significant byte of word j."""
    rows = [(state[j] >> (56 - 8 * k)) & 0xFF for j in range(8) for k in range(8)]
    return torch.stack(rows, dim=0)
