"""Evidence of validator misbehavior.

Reference: cometbft_tpu/types/evidence.py (types/evidence.go —
DuplicateVoteEvidence, double signing, and LightClientAttackEvidence, a
conflicting light block). Wire layout proto/tendermint/types/
evidence.proto (oneof sum: duplicate=1, lca=2). Hashes are the host's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import Timestamp, ZERO_TIME
from cometbft_tpu_torch.types.vote import Vote


class Evidence:
    """Interface (types/evidence.go Evidence)."""

    def abci(self) -> list:
        raise NotImplementedError

    def bytes(self) -> bytes:
        raise NotImplementedError

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    def height(self) -> int:
        raise NotImplementedError

    def time(self) -> Timestamp:
        raise NotImplementedError

    def validate_basic(self) -> None:
        raise NotImplementedError

    def __eq__(self, other) -> bool:
        return isinstance(other, Evidence) and self.bytes() == other.bytes()

    def __hash__(self) -> int:
        return hash(self.bytes())


@dataclass(eq=False)
class DuplicateVoteEvidence(Evidence):
    """proto: {Vote vote_a=1, Vote vote_b=2, int64 total_voting_power=3,
    int64 validator_power=4, Timestamp timestamp=5 (non-null stdtime)}."""

    vote_a: Optional[Vote] = None
    vote_b: Optional[Vote] = None
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = ZERO_TIME

    @classmethod
    def new(cls, vote1: Vote, vote2: Vote, block_time: Timestamp, val_set):
        """Reference: NewDuplicateVoteEvidence — orders votes by BlockID key."""
        if vote1 is None or vote2 is None or val_set is None:
            raise ValueError("missing vote or validator set")
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise ValueError("validator is not in the validator set")
        if vote1.block_id.key() < vote2.block_id.key():
            vote_a, vote_b = vote1, vote2
        else:
            vote_a, vote_b = vote2, vote1
        return cls(
            vote_a=vote_a,
            vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def encode_inner(self) -> bytes:
        out = b""
        if self.vote_a is not None:
            out += protoio.field_message(1, self.vote_a.encode())
        if self.vote_b is not None:
            out += protoio.field_message(2, self.vote_b.encode())
        out += protoio.field_varint(3, self.total_voting_power)
        out += protoio.field_varint(4, self.validator_power)
        out += protoio.field_message(5, self.timestamp.encode())
        return out

    def bytes(self) -> bytes:
        """Evidence oneof wrapper marshal (evidence.go Evidence.Bytes)."""
        return protoio.field_message(1, self.encode_inner())

    @classmethod
    def decode_inner(cls, data: bytes) -> "DuplicateVoteEvidence":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.vote_a = Vote.decode(r.read_bytes())
            elif f == 2:
                out.vote_b = Vote.decode(r.read_bytes())
            elif f == 3:
                out.total_voting_power = r.read_varint()
            elif f == 4:
                out.validator_power = r.read_varint()
            elif f == 5:
                out.timestamp = Timestamp.decode(r.read_bytes())
            else:
                r.skip(wt)
        return out

    def height(self) -> int:
        return self.vote_a.height if self.vote_a else 0

    def time(self) -> Timestamp:
        return self.timestamp

    def abci(self) -> list:
        """Reference: DuplicateVoteEvidence.ABCI()."""
        from cometbft_tpu_torch.abci import types as abci_types

        return [
            abci_types.Misbehavior(
                type=abci_types.EVIDENCE_TYPE_DUPLICATE_VOTE,
                validator=abci_types.Validator(
                    self.vote_a.validator_address, self.validator_power
                ),
                height=self.vote_a.height,
                time=self.timestamp,
                total_voting_power=self.total_voting_power,
            )
        ]

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("empty duplicate vote evidence")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    def __str__(self) -> str:
        return (
            f"DuplicateVoteEvidence{{VoteA: {self.vote_a}, VoteB: {self.vote_b}}}"
        )


@dataclass(eq=False)
class LightClientAttackEvidence(Evidence):
    """proto: {LightBlock conflicting_block=1, int64 common_height=2,
    repeated Validator byzantine_validators=3, int64 total_voting_power=4,
    Timestamp timestamp=5}."""

    conflicting_block: Optional[object] = None  # light.LightBlock
    common_height: int = 0
    byzantine_validators: List[object] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = ZERO_TIME

    def encode_inner(self) -> bytes:
        out = b""
        if self.conflicting_block is not None:
            out += protoio.field_message(1, self.conflicting_block.encode())
        out += protoio.field_varint(2, self.common_height)
        for v in self.byzantine_validators:
            out += protoio.field_message(3, v.encode())
        out += protoio.field_varint(4, self.total_voting_power)
        out += protoio.field_message(5, self.timestamp.encode())
        return out

    def bytes(self) -> bytes:
        return protoio.field_message(2, self.encode_inner())

    def height(self) -> int:
        return self.common_height

    def time(self) -> Timestamp:
        return self.timestamp

    def abci(self) -> list:
        """Reference: LightClientAttackEvidence.ABCI() — one entry per
        byzantine validator."""
        from cometbft_tpu_torch.abci import types as abci_types

        return [
            abci_types.Misbehavior(
                type=abci_types.EVIDENCE_TYPE_LIGHT_CLIENT_ATTACK,
                validator=abci_types.Validator(v.address, v.voting_power),
                height=self.common_height,
                time=self.timestamp,
                total_voting_power=self.total_voting_power,
            )
            for v in self.byzantine_validators
        ]

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")


def decode_evidence(data: bytes) -> Evidence:
    r = protoio.WireReader(data)
    while not r.at_end():
        f, wt = r.read_tag()
        if f == 1:
            return DuplicateVoteEvidence.decode_inner(r.read_bytes())
        if f == 2:
            from cometbft_tpu_torch.types.light_block import decode_lca_inner

            return decode_lca_inner(r.read_bytes())
        r.skip(wt)
    raise ValueError("empty evidence proto")


def encode_evidence_list(evs: List[Evidence]) -> bytes:
    """EvidenceList proto: repeated Evidence evidence=1."""
    out = b""
    for ev in evs:
        out += protoio.field_message(1, ev.bytes())
    return out


def decode_evidence_list(data: bytes) -> List[Evidence]:
    r = protoio.WireReader(data)
    out = []
    while not r.at_end():
        f, wt = r.read_tag()
        if f == 1:
            out.append(decode_evidence(r.read_bytes()))
        else:
            r.skip(wt)
    return out


def evidence_list_hash(evs: List[Evidence]) -> bytes:
    """Merkle root over evidence bytes (types/evidence.go EvidenceList.Hash)."""
    return merkle.hash_from_byte_slices([ev.bytes() for ev in evs])

