"""BlockID, CommitSig and Commit (reference: cometbft_tpu/types/block.py;
types/block.go, proto/tendermint/types/types.proto).

Only what commit verification needs: the wire encoding and decoding, and
the sign bytes of one commit signature.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import ZERO_TIME, Timestamp
from cometbft_tpu_torch.types import canonical

# BlockIDFlag (proto/tendermint/types/types.proto:17-20)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    """proto: {uint32 total=1, bytes hash=2} (types.proto:38)."""

    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def encode(self) -> bytes:
        return protoio.field_varint(1, self.total) + protoio.field_bytes(2, self.hash)

    @classmethod
    def decode(cls, data: bytes) -> "PartSetHeader":
        r = protoio.WireReader(data)
        total, h = 0, b""
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                total = r.read_uvarint()
            elif f == 2:
                h = r.read_bytes()
            else:
                r.skip(wt)
        return cls(total, h)

@dataclass(frozen=True)
class BlockID:
    """proto: {bytes hash=1, PartSetHeader part_set_header=2 (non-null)}
    (types.proto:50)."""

    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def encode(self) -> bytes:
        # part_set_header is gogoproto non-nullable: always emitted
        return protoio.field_bytes(1, self.hash) + protoio.field_message(
            2, self.part_set_header.encode()
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockID":
        r = protoio.WireReader(data)
        h, psh = b"", PartSetHeader()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                h = r.read_bytes()
            elif f == 2:
                psh = PartSetHeader.decode(r.read_bytes())
            else:
                r.skip(wt)
        return cls(h, psh)

    def __str__(self) -> str:
        return f"{self.hash.hex().upper()[:12]}:{self.part_set_header.total}"


@dataclass
class CommitSig:
    """One validator's commit signature. proto: {BlockIDFlag
    block_id_flag=1, bytes validator_address=2, Timestamp timestamp=3
    (non-null), bytes signature=4} (types.proto:116)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = ZERO_TIME
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_ABSENT, b"", ZERO_TIME, b"")

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def encode(self) -> bytes:
        return (
            protoio.field_varint(1, self.block_id_flag)
            + protoio.field_bytes(2, self.validator_address)
            + protoio.field_message(3, self.timestamp.encode())
            + protoio.field_bytes(4, self.signature)
        )

    @classmethod
    def decode(cls, data: bytes) -> "CommitSig":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.block_id_flag = r.read_uvarint()
            elif f == 2:
                out.validator_address = r.read_bytes()
            elif f == 3:
                out.timestamp = Timestamp.decode(r.read_bytes())
            elif f == 4:
                out.signature = r.read_bytes()
            else:
                r.skip(wt)
        return out

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this signature endorses (CommitSig.BlockID)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()


@dataclass
class Commit:
    """proto: {int64 height=1, int32 round=2, BlockID block_id=3 (non-null),
    repeated CommitSig signatures=4} (types.proto:108)."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: List[CommitSig] = field(default_factory=list)

    def encode(self) -> bytes:
        out = (
            protoio.field_varint(1, self.height)
            + protoio.field_varint(2, self.round)
            + protoio.field_message(3, self.block_id.encode())
        )
        for cs in self.signatures:
            out += protoio.field_message(4, cs.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Commit":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.height = r.read_varint()
            elif f == 2:
                out.round = r.read_varint()
            elif f == 3:
                out.block_id = BlockID.decode(r.read_bytes())
            elif f == 4:
                out.signatures.append(CommitSig.decode(r.read_bytes()))
            else:
                r.skip(wt)
        return out

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Sign bytes of signature val_idx: the precommit it signed
        (block.go:270 Commit.VoteSignBytes)."""
        cs = self.signatures[val_idx]
        return canonical.canonical_vote_bytes(
            chain_id,
            canonical.SIGNED_MSG_TYPE_PRECOMMIT,
            self.height,
            self.round,
            cs.block_id(self.block_id),
            cs.timestamp,
        )
