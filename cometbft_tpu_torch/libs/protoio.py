"""Protobuf wire-format primitives and the varint-delimited framing of
sign bytes.

Reference: cometbft_tpu/libs/protoio.py (libs/protoio). The encoders give
byte-identical output to gogoproto's Marshal for the messages in
cometbft_tpu_torch.proto and cometbft_tpu_torch.types.
"""

from __future__ import annotations

import struct
from typing import Tuple


def encode_uvarint(n: int) -> bytes:
    """Protobuf base-128 unsigned varint."""
    if n < 0:
        raise ValueError("uvarint of negative")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_varint_zigzag(n: int) -> bytes:
    """Zigzag-encoded signed varint (sint64)."""
    return encode_uvarint((n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1)


def encode_varint(n: int) -> bytes:
    """Two's-complement signed varint (int64/int32 fields)."""
    if n < 0:
        n += 1 << 64
    return encode_uvarint(n)


def decode_uvarint(data: bytes, pos: int = 0) -> Tuple[int, int]:
    """Returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise EOFError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if shift >= 63 and b > 1:
                raise ValueError("varint overflows uint64")
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def decode_varint(data: bytes, pos: int = 0) -> Tuple[int, int]:
    v, pos = decode_uvarint(data, pos)
    if v >= 1 << 63:
        v -= 1 << 64
    return v, pos


def marshal_delimited(msg_bytes: bytes) -> bytes:
    """Length-prefix a serialized message — the canonical sign-bytes framing
    (libs/protoio/io.go MarshalDelimited; types/vote.go:93)."""
    return encode_uvarint(len(msg_bytes)) + msg_bytes


# --- field encoders (gogoproto-compatible) ------------------------------------

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5


def tag(field_num: int, wire_type: int) -> bytes:
    return encode_uvarint((field_num << 3) | wire_type)


def field_varint(field_num: int, value: int) -> bytes:
    """int32/int64/uint64/bool/enum field. Zero values are omitted (proto3)."""
    if value == 0 or value is False:
        return b""
    if value is True:
        value = 1
    return tag(field_num, WIRE_VARINT) + encode_varint(value)


def field_bytes(field_num: int, value: bytes) -> bytes:
    """bytes/string field. Empty omitted (proto3 scalar)."""
    if not value:
        return b""
    return tag(field_num, WIRE_BYTES) + encode_uvarint(len(value)) + value


def field_message(field_num: int, value: bytes) -> bytes:
    """Embedded message, emitted even when empty (callers omit None)."""
    return tag(field_num, WIRE_BYTES) + encode_uvarint(len(value)) + value


def field_sfixed64(field_num: int, value: int) -> bytes:
    if value == 0:
        return b""
    return tag(field_num, WIRE_FIXED64) + struct.pack("<q", value)


def field_string(field_num: int, value: str) -> bytes:
    return field_bytes(field_num, value.encode("utf-8"))


# --- decoder ------------------------------------------------------------------


class WireReader:
    """Minimal protobuf wire decoder for hand-rolled message parsers."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def at_end(self) -> bool:
        return self.pos >= len(self.data)

    def read_tag(self) -> Tuple[int, int]:
        v, self.pos = decode_uvarint(self.data, self.pos)
        return v >> 3, v & 7

    def read_varint(self) -> int:
        v, self.pos = decode_varint(self.data, self.pos)
        return v

    def read_uvarint(self) -> int:
        v, self.pos = decode_uvarint(self.data, self.pos)
        return v

    def read_bytes(self) -> bytes:
        n, self.pos = decode_uvarint(self.data, self.pos)
        if self.pos + n > len(self.data):
            raise EOFError("truncated bytes field")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def skip(self, wire_type: int) -> None:
        if wire_type == WIRE_VARINT:
            self.read_uvarint()
        elif wire_type == WIRE_FIXED64:
            self.pos += 8
        elif wire_type == WIRE_BYTES:
            self.read_bytes()
        elif wire_type == WIRE_FIXED32:
            self.pos += 4
        else:
            raise ValueError(f"unknown wire type {wire_type}")
