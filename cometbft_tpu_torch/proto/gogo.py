"""google.protobuf.Timestamp as gogoproto's stdtime marshals it, and the
cdcEncode wrappers of the header hash.

Reference: cometbft_tpu/proto/gogo.py (gogo/protobuf StdTimeMarshal;
StringValue/Int64Value/BytesValue as types/encoding_helper.go:11 cdcEncode
uses them).
"""

from __future__ import annotations

import datetime as _dt
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

    # -- conversions -------------------------------------------------------

    @classmethod
    def now(cls) -> "Timestamp":
        dt = _dt.datetime.now(_dt.timezone.utc)
        return cls.from_datetime(dt)

    @classmethod
    def from_rfc3339(cls, s: str) -> "Timestamp":
        """Inverse of to_rfc3339 (accepts fractional seconds up to ns)."""
        if not s.endswith("Z"):
            raise ValueError(f"expected UTC RFC3339 time, got {s!r}")
        body = s[:-1]
        nanos = 0
        if "." in body:
            body, frac = body.split(".", 1)
            nanos = int(frac.ljust(9, "0")[:9])
        dt = _dt.datetime.strptime(body, "%Y-%m-%dT%H:%M:%S").replace(
            tzinfo=_dt.timezone.utc
        )
        ts = cls.from_datetime(dt)
        return cls(ts.seconds, nanos)

    @classmethod
    def from_datetime(cls, dt: _dt.datetime) -> "Timestamp":
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        delta = dt - epoch
        seconds = delta.days * 86400 + delta.seconds
        nanos = delta.microseconds * 1000
        return cls(seconds, nanos)

    @classmethod
    def from_unix_ns(cls, ns: int) -> "Timestamp":
        return cls(ns // 1_000_000_000, ns % 1_000_000_000)

    def to_unix_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos

    def to_datetime(self) -> _dt.datetime:
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        return epoch + _dt.timedelta(
            seconds=self.seconds, microseconds=self.nanos // 1000
        )

    def to_rfc3339(self) -> str:
        """RFC3339Nano, the reference's CanonicalTime format
        (types/canonical.go:68)."""
        dt = self.to_datetime()
        # strftime %Y does not zero-pad years < 1000 on glibc; Go's
        # RFC3339Nano prints 4 digits ("0001-01-01..." for the zero time)
        base = (
            f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}"
            f"T{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}"
        )
        if self.nanos:
            frac = f"{self.nanos:09d}".rstrip("0")
            return f"{base}.{frac}Z"
        return base + "Z"

    def __lt__(self, other: "Timestamp") -> bool:
        return (self.seconds, self.nanos) < (other.seconds, other.nanos)

    def __le__(self, other: "Timestamp") -> bool:
        return (self.seconds, self.nanos) <= (other.seconds, other.nanos)

    def add_ns(self, ns: int) -> "Timestamp":
        return Timestamp.from_unix_ns(self.to_unix_ns() + ns)


ZERO_TIME = Timestamp()


def encode_timestamp(field_num: int, ts: Timestamp, nullable: bool = False) -> bytes:
    """Encode a stdtime field. Non-nullable fields are always emitted (gogo
    marshals the struct unconditionally)."""
    if nullable and ts is None:
        return b""
    return protoio.field_message(field_num, ts.encode())


def decode_timestamp(data: bytes) -> Timestamp:
    return Timestamp.decode(data)


# -- cdcEncode wrappers (types/encoding_helper.go) --------------------------


def cdc_encode_string(s: str) -> bytes:
    """proto.Marshal(StringValue{Value: s}); nil for empty."""
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
