"""Validator — address, pubkey, voting power, proposer priority.

Reference: cometbft_tpu/types/validator.py (types/validator.go;
proto/tendermint/types/validator.proto).
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.keys import (
    PublicKeyProto,
    pub_key_from_proto,
    pub_key_to_proto,
)

MAX_TOTAL_VOTING_POWER = (1 << 63) - 1 >> 3  # types/validator_set.go MaxTotalVotingPower = int64max/8


@dataclass
class Validator:
    address: bytes
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def new(cls, pub_key: PubKey, voting_power: int) -> "Validator":
        return cls(pub_key.address(), pub_key, voting_power, 0)

    def copy(self) -> "Validator":
        return Validator(
            self.address, self.pub_key, self.voting_power, self.proposer_priority
        )

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties broken by ascending address
        (reference: validator.go CompareProposerPriority)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise RuntimeError("cannot compare identical validators")

    def bytes(self) -> bytes:
        """SimpleValidator proto marshal — the validator-set hash leaf
        (validator.go:117: pub_key=1, voting_power=2)."""
        pk = pub_key_to_proto(self.pub_key)
        return protoio.field_message(1, pk.encode()) + protoio.field_varint(
            2, self.voting_power
        )

    # full Validator proto: address=1, pub_key=2 (non-null), voting_power=3,
    # proposer_priority=4
    def encode(self) -> bytes:
        return (
            protoio.field_bytes(1, self.address)
            + protoio.field_message(2, pub_key_to_proto(self.pub_key).encode())
            + protoio.field_varint(3, self.voting_power)
            + protoio.field_varint(4, self.proposer_priority)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Validator":
        r = protoio.WireReader(data)
        address, pk, vp, pp = b"", None, 0, 0
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                address = r.read_bytes()
            elif f == 2:
                pk = pub_key_from_proto(PublicKeyProto.decode(r.read_bytes()))
            elif f == 3:
                vp = r.read_varint()
            elif f == 4:
                pp = r.read_varint()
            else:
                r.skip(wt)
        if pk is None:
            raise ValueError("validator missing pubkey")
        return cls(address, pk, vp, pp)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValueError("validator address is the wrong size")

    def __str__(self) -> str:
        return (
            f"Validator{{{self.address.hex().upper()[:12]} VP:{self.voting_power} "
            f"A:{self.proposer_priority}}}"
        )
