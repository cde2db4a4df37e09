"""google.protobuf.Timestamp as gogoproto's stdtime marshals it.

Reference: cometbft_tpu/proto/gogo.py (gogo/protobuf StdTimeMarshal).
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


ZERO_TIME = Timestamp()
