"""Scalars mod L for the device-hash route: the plain torch twin of
``csrc/sc25519.cuh``.

Reference: cometbft_tpu/crypto/tpu/scalar.py — ``digest_to_limbs`` (:148),
``sc_reduce`` (:97) and ``digits_msb_first`` (:180). h = SHA-512(R‖A‖M)
is a 512-bit little-endian integer that must be reduced mod
L = 2^252 + c EXACTLY: cofactorless verification computes [h](−A), and
on a key with a torsion component h and h + kL give different verdicts.

The reference folds radix-2^15 limbs in int32 because the TPU lanes have
nothing wider. Hopper has 64-bit integers, so the port uses ref10's
``sc_reduce`` as it stands: 24 signed limbs of 21 bits in int64 (limb 23
holds the top 29 bits), 2^252 ≡ −c folded in as the six signed 21-bit
digits of −c, rounded carries between the folds, two floor-carry passes
at the end. Its bounds keep every intermediate inside int64, and its
output is the canonical residue in [0, L). The CUDA code runs the same
steps in the same order on ``int64_t``, and the tests hold this version
against Python's ``int % L``.

Tensors: limbs int64[24, B] in, int64[12, B] out (21-bit limbs of the
reduced scalar); ``to_words`` gives the int64[8, B] little-endian u32
words the verifier's digit extraction reads.
"""

from __future__ import annotations

from typing import List

import torch

L = 2**252 + 27742317777372353535851937790883648493
NUM_DIGITS = 127  # 2-bit windows of a 253-bit scalar

_MASK21 = (1 << 21) - 1
# 2^252 = -c (mod L), as signed 21-bit digits: limb 12 folds into limbs 0..5
_FOLD = (666643, 470296, 654183, -997805, 136657, -683901)


def digest_to_limbs(digest: torch.Tensor) -> List[torch.Tensor]:
    """Digest bytes int64[64, B] (digest order, which is the little-endian
    byte order of h) → 24 int64[B] limbs: limb i is bits 21i..21i+20, the
    last one bits 483..511 (ref10's load_3/load_4 reads)."""
    limbs = []
    for i in range(24):
        bit = 21 * i
        n, off = bit // 8, bit % 8
        v = digest[n]
        for k in range(1, 4):
            if n + k < 64:
                v = v | (digest[n + k] << (8 * k))
        v = v >> off
        limbs.append(v if i == 23 else v & _MASK21)
    return limbs


def _fold(s: List[torch.Tensor], k: int) -> None:
    c = s[k]
    for j, f in enumerate(_FOLD):
        s[k - 12 + j] = s[k - 12 + j] + c * f
    s[k] = torch.zeros_like(c)


def _carry_round(s: List[torch.Tensor], i: int) -> None:
    c = (s[i] + (1 << 20)) >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << 21)


def _carry_floor(s: List[torch.Tensor], i: int) -> None:
    c = s[i] >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << 21)


def sc_reduce(limbs: List[torch.Tensor]) -> torch.Tensor:
    """24 limbs of a 512-bit value → int64[12, B], the 21-bit limbs of the
    value mod L (ref10 sc_reduce, step for step)."""
    s = list(limbs)
    for k in range(23, 17, -1):
        _fold(s, k)
    for i in range(6, 17, 2):
        _carry_round(s, i)
    for i in range(7, 16, 2):
        _carry_round(s, i)
    for k in range(17, 11, -1):
        _fold(s, k)
    for i in range(0, 11, 2):
        _carry_round(s, i)
    for i in range(1, 12, 2):
        _carry_round(s, i)
    _fold(s, 12)
    for i in range(12):
        _carry_floor(s, i)
    _fold(s, 12)
    for i in range(11):
        _carry_floor(s, i)
    return torch.stack(s[:12], dim=0)


def to_words(red: torch.Tensor) -> torch.Tensor:
    """Reduced 21-bit limbs int64[12, B] → int64[8, B] little-endian u32
    words of the 256-bit value (limb 11 may carry 22 bits)."""
    words = []
    for j in range(8):
        w = torch.zeros_like(red[0])
        for i in range(12):
            off, width = 21 * i, (22 if i == 11 else 21)
            lo, hi = max(off, 32 * j), min(off + width, 32 * j + 32)
            if lo >= hi:
                continue
            part = (red[i] >> (lo - off)) & ((1 << (hi - lo)) - 1)
            w = w | (part << (lo - 32 * j))
        words.append(w)
    return torch.stack(words, dim=0)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """int64[8, B] u32 words → uint8[32, B] little-endian bytes."""
    rows = [(words[j // 4] >> (8 * (j % 4))) & 0xFF for j in range(32)]
    return torch.stack(rows, dim=0).to(torch.uint8)


def digits_msb_first(words: torch.Tensor) -> torch.Tensor:
    """int64[8, B] scalar words (< 2^254) → int64[127, B] radix-4 digits,
    most significant first: the Straus loop's input plane."""
    digs = []
    for d in range(NUM_DIGITS):
        bit = 2 * (NUM_DIGITS - 1 - d)
        digs.append((words[bit // 32] >> (bit % 32)) & 3)
    return torch.stack(digs, dim=0)
