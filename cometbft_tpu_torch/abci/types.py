"""abci.Validator and abci.Misbehavior — what ``Evidence.abci()`` returns.

Reference: cometbft_tpu/abci/types.py (abci/types.proto:384-398); the
rest of ABCI is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import ZERO_TIME, Timestamp

# EvidenceType enum
EVIDENCE_TYPE_UNKNOWN = 0
EVIDENCE_TYPE_DUPLICATE_VOTE = 1
EVIDENCE_TYPE_LIGHT_CLIENT_ATTACK = 2


@dataclass
class Validator:
    """abci.Validator — address + power (no pubkey)."""

    address: bytes = b""
    power: int = 0

    def encode(self) -> bytes:
        return protoio.field_bytes(1, self.address) + protoio.field_varint(
            3, self.power
        )


@dataclass
class Misbehavior:
    """abci.Evidence (types.proto:384-398)."""

    type: int = EVIDENCE_TYPE_UNKNOWN
    validator: Validator = field(default_factory=Validator)
    height: int = 0
    time: Timestamp = ZERO_TIME
    total_voting_power: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.type:
            out += protoio.field_varint(1, self.type)
        out += protoio.field_message(2, self.validator.encode())
        if self.height:
            out += protoio.field_varint(3, self.height)
        out += protoio.field_message(4, self.time.encode())
        if self.total_voting_power:
            out += protoio.field_varint(5, self.total_voting_power)
        return out

