"""Proposal — the proposer's signed block proposal for a round.

Ported from cometbft_tpu/types/proposal.py.

Reference: types/proposal.go; wire layout proto/tendermint/types/types.proto:124.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import Timestamp, ZERO_TIME
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.canonical import canonical_proposal_bytes
from cometbft_tpu_torch.types.vote import SIGNED_MSG_TYPE_PROPOSAL


@dataclass
class Proposal:
    type: int = SIGNED_MSG_TYPE_PROPOSAL
    height: int = 0
    round: int = 0
    pol_round: int = -1  # proof-of-lock round; -1 if none
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Timestamp = ZERO_TIME
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_proposal_bytes(chain_id, self)

    def encode(self) -> bytes:
        return (
            protoio.field_varint(1, self.type)
            + protoio.field_varint(2, self.height)
            + protoio.field_varint(3, self.round)
            + protoio.field_varint(4, self.pol_round)
            + protoio.field_message(5, self.block_id.encode())
            + protoio.field_message(6, self.timestamp.encode())
            + protoio.field_bytes(7, self.signature)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        r = protoio.WireReader(data)
        out = cls(pol_round=0)  # proto3 default; -1 is the domain default
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.type = r.read_uvarint()
            elif f == 2:
                out.height = r.read_varint()
            elif f == 3:
                out.round = r.read_varint()
            elif f == 4:
                out.pol_round = r.read_varint()
            elif f == 5:
                out.block_id = BlockID.decode(r.read_bytes())
            elif f == 6:
                out.timestamp = Timestamp.decode(r.read_bytes())
            elif f == 7:
                out.signature = r.read_bytes()
            else:
                r.skip(wt)
        return out

    def validate_basic(self) -> None:
        if self.type != SIGNED_MSG_TYPE_PROPOSAL:
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1 or (
            self.pol_round != -1 and self.pol_round >= self.round
        ):
            raise ValueError("POLRound must be -1 or in [0, round)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError("expected a complete, non-empty BlockID")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")

    def __str__(self) -> str:
        return (
            f"Proposal{{{self.height}/{self.round} ({self.block_id}, "
            f"{self.pol_round}) {self.signature.hex()[:12].upper()}}}"
        )
