"""Merlin transcripts (STROBE-128 over Keccak-f[1600]).

Reference: cometbft_tpu/crypto/merlin.py — ``keccak_f1600`` (:36),
``Strobe128`` (:79) and ``Transcript`` (:158), copied as they stand. It
is STROBE-128 ("STROBEv1.0.2") specialised to the three operations merlin
needs (meta-AD, AD, PRF), with merlin v1.0 framing; sr25519 draws its
challenge scalar from it (crypto/sr25519.py). It stays pure Python:
``hashlib`` exposes no bare Keccak-f permutation.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _rol(x: int, n: int) -> int:
    n %= 64
    if n == 0:
        return x
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] permutation on a 200-byte state."""
    lanes = list(struct.unpack("<25Q", bytes(state)))
    for rnd in range(24):
        # theta
        c = [
            lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            dx = d[x]
            for y in range(0, 25, 5):
                lanes[x + y] ^= dx
        # rho + pi
        x, y = 1, 0
        current = lanes[1]
        for t in range(24):
            x, y = y, (2 * x + 3 * y) % 5
            idx = x + 5 * y
            current, lanes[idx] = lanes[idx], _rol(current, (t + 1) * (t + 2) // 2)
        # chi
        for y in range(0, 25, 5):
            row = lanes[y : y + 5]
            for x in range(5):
                lanes[y + x] = row[x] ^ ((row[(x + 1) % 5] ^ _M64) & row[(x + 2) % 5])
        # iota
        lanes[0] ^= _RC[rnd]
    state[:] = struct.pack("<25Q", *lanes)


# -- STROBE-128 (merlin subset) ---------------------------------------------

_R = 166  # STROBE-128 rate for keccak-f[1600]: 200 - 128/4 - 2

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        self.state = bytearray(200)
        self.state[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        self.state[6:18] = b"STROBEv1.0.2"
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # internal sponge ops

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] ^= b
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError(
                    f"flag mismatch on continued op: {flags} != {self.cur_flags}"
                )
            return
        if flags & _FLAG_T:
            raise ValueError("transport operations not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # public ops

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        # overwrite
        for b in data:
            self.state[self.pos] = b
            self.pos += 1
            if self.pos == _R:
                self._run_f()


class Transcript:
    """Merlin v1.0 transcript (append_message / challenge_bytes)."""

    def __init__(self, app_label: bytes):
        self._strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", app_label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", len(message)), True)
        self._strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", n), True)
        return self._strobe.prf(n, False)

    # gtank/merlin's Go-style name used by the handshake
    extract_bytes = challenge_bytes
