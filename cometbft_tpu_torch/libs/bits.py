"""BitArray — thread-safe bit array used for part-set availability and vote
bitmaps.

Reference: cometbft_tpu/libs/bits.py (libs/bits/bit_array.go). On the
wire (proto ``libs.bits.BitArray``) a bit array is its size and its
uint64 ``elems``.
"""

from __future__ import annotations

import secrets
import threading
from typing import List, Optional


class BitArray:
    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bits")
        self._bits = bits
        self._elems = [0] * ((bits + 63) // 64)
        self._mtx = threading.Lock()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_elems(cls, bits: int, elems: List[int]) -> "BitArray":
        ba = cls(bits)
        want = (bits + 63) // 64
        if len(elems) != want:
            raise ValueError(f"elems length {len(elems)} != {want}")
        mask = (1 << 64) - 1
        ba._elems = [e & mask for e in elems]
        # zero trailing bits beyond `bits`
        if bits % 64 != 0 and ba._elems:
            ba._elems[-1] &= (1 << (bits % 64)) - 1
        return ba

    def copy(self) -> "BitArray":
        with self._mtx:
            ba = BitArray(self._bits)
            ba._elems = list(self._elems)
            return ba

    # -- accessors ---------------------------------------------------------

    @property
    def size(self) -> int:
        return self._bits

    def get_index(self, i: int) -> bool:
        with self._mtx:
            if i >= self._bits or i < 0:
                return False
            return bool((self._elems[i // 64] >> (i % 64)) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        with self._mtx:
            if i >= self._bits or i < 0:
                return False
            if v:
                self._elems[i // 64] |= 1 << (i % 64)
            else:
                self._elems[i // 64] &= ~(1 << (i % 64))
            return True

    def elems(self) -> List[int]:
        with self._mtx:
            return list(self._elems)

    # -- set algebra (reference: Or/And/Sub/Not) ---------------------------

    def or_(self, other: "BitArray") -> "BitArray":
        c = BitArray(max(self._bits, other._bits))
        a, b = self.elems(), other.elems()
        for i in range(len(c._elems)):
            e = 0
            if i < len(a):
                e |= a[i]
            if i < len(b):
                e |= b[i]
            c._elems[i] = e
        return c

    def and_(self, other: "BitArray") -> "BitArray":
        c = BitArray(min(self._bits, other._bits))
        a, b = self.elems(), other.elems()
        for i in range(len(c._elems)):
            c._elems[i] = a[i] & b[i]
        return c

    def not_(self) -> "BitArray":
        c = BitArray(self._bits)
        a = self.elems()
        mask = (1 << 64) - 1
        for i in range(len(c._elems)):
            c._elems[i] = (~a[i]) & mask
        if self._bits % 64 != 0 and c._elems:
            c._elems[-1] &= (1 << (self._bits % 64)) - 1
        return c

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (reference: Sub)."""
        c = self.copy()
        b = other.elems()
        for i in range(min(len(c._elems), len(b))):
            c._elems[i] &= ~b[i]
            c._elems[i] &= (1 << 64) - 1
        if self._bits % 64 != 0 and c._elems:
            c._elems[-1] &= (1 << (self._bits % 64)) - 1
        return c

    def is_empty(self) -> bool:
        with self._mtx:
            return all(e == 0 for e in self._elems)

    def is_full(self) -> bool:
        with self._mtx:
            if self._bits == 0:
                return True
            for e in self._elems[:-1]:
                if e != (1 << 64) - 1:
                    return False
            last_bits = self._bits % 64 or 64
            return self._elems[-1] == (1 << last_bits) - 1

    def num_true_bits(self) -> int:
        with self._mtx:
            return sum(bin(e).count("1") for e in self._elems)

    def pick_random(self) -> Optional[int]:
        """Random index of a set bit, or None (reference: PickRandom)."""
        with self._mtx:
            true_idx = [
                i
                for i in range(self._bits)
                if (self._elems[i // 64] >> (i % 64)) & 1
            ]
        if not true_idx:
            return None
        return true_idx[secrets.randbelow(len(true_idx))]

    def true_indices(self) -> List[int]:
        with self._mtx:
            return [
                i
                for i in range(self._bits)
                if (self._elems[i // 64] >> (i % 64)) & 1
            ]

    def update(self, other: "BitArray") -> None:
        """Copy other's contents into self (reference: Update)."""
        o = other.copy()
        with self._mtx:
            self._bits = o._bits
            self._elems = o._elems

    # -- misc --------------------------------------------------------------

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BitArray):
            return NotImplemented
        return self._bits == other._bits and self.elems() == other.elems()

    def __str__(self) -> str:
        return self.string_indented("")

    def string_indented(self, indent: str) -> str:
        bits = "".join(
            "x" if self.get_index(i) else "_" for i in range(self._bits)
        )
        return f"BA{{{self._bits}:{bits}}}"
