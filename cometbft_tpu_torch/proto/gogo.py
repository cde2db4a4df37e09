"""google.protobuf.Timestamp as gogoproto's stdtime marshals it, and the
cdcEncode wrappers of the header hash.

Reference: cometbft_tpu/proto/gogo.py:20-150 (gogo/protobuf StdTimeMarshal;
StringValue/Int64Value/BytesValue as types/encoding_helper.go:11 cdcEncode
uses them).
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.libs import protoio

# Go's time.Time{} zero value = 0001-01-01T00:00:00Z
GO_ZERO_SECONDS = -62135596800


@dataclass(frozen=True)
class Timestamp:
    """google.protobuf.Timestamp (seconds, nanos)."""

    seconds: int = GO_ZERO_SECONDS
    nanos: int = 0

    def is_zero(self) -> bool:
        return self.seconds == GO_ZERO_SECONDS and self.nanos == 0

    def encode(self) -> bytes:
        return protoio.field_varint(1, self.seconds) + protoio.field_varint(
            2, self.nanos
        )

    @classmethod
    def decode(cls, data: bytes) -> "Timestamp":
        r = protoio.WireReader(data)
        seconds, nanos = 0, 0
        while not r.at_end():
            field, wt = r.read_tag()
            if field == 1:
                seconds = r.read_varint()
            elif field == 2:
                nanos = r.read_varint()
            else:
                r.skip(wt)
        return cls(seconds, nanos)

    @classmethod
    def from_unix_ns(cls, ns: int) -> "Timestamp":
        return cls(ns // 1_000_000_000, ns % 1_000_000_000)

    def to_unix_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos

    def __lt__(self, other: "Timestamp") -> bool:
        return (self.seconds, self.nanos) < (other.seconds, other.nanos)

    def add_ns(self, ns: int) -> "Timestamp":
        return Timestamp.from_unix_ns(self.to_unix_ns() + ns)


ZERO_TIME = Timestamp()


def encode_timestamp(field_num: int, ts: Timestamp, nullable: bool = False) -> bytes:
    """A stdtime field. A non-nullable field is always emitted (gogo
    marshals the struct unconditionally)."""
    if nullable and ts is None:
        return b""
    return protoio.field_message(field_num, ts.encode())


def decode_timestamp(data: bytes) -> Timestamp:
    return Timestamp.decode(data)


# -- cdcEncode wrappers (types/encoding_helper.go) ---------------------------


def cdc_encode_string(s: str) -> bytes:
    """proto.Marshal(StringValue{Value: s}); empty for ""."""
    if not s:
        return b""
    return protoio.field_string(1, s)


def cdc_encode_int64(n: int) -> bytes:
    if n == 0:
        return b""
    return protoio.field_varint(1, n)


def cdc_encode_bytes(b: bytes) -> bytes:
    if not b:
        return b""
    return protoio.field_bytes(1, b)
