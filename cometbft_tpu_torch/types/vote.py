"""Vote — a signed prevote/precommit from a validator.

Reference: cometbft_tpu/types/vote.py (types/vote.go — Vote struct :50,
VoteSignBytes :93, Verify :147). Wire layout per
proto/tendermint/types/types.proto:94. ``verify`` checks one signature on
the host with ``PubKey.verify_signature``, as the reference does; a batch
of votes goes through ``crypto.batch`` first and marks each vote it
verified (``sig_batch_verified``, read by ``VoteSet.add_vote``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import Timestamp, ZERO_TIME
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types import canonical

# SignedMsgType (types.proto:28-34)
SIGNED_MSG_TYPE_UNKNOWN = 0
SIGNED_MSG_TYPE_PREVOTE = 1
SIGNED_MSG_TYPE_PRECOMMIT = 2
SIGNED_MSG_TYPE_PROPOSAL = 32


def is_vote_type_valid(t: int) -> bool:
    return t in (SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT)


class ErrVoteInvalidSignature(ValueError):
    pass


class ErrVoteInvalidValidatorAddress(ValueError):
    pass


@dataclass
class Vote:
    type: int = SIGNED_MSG_TYPE_UNKNOWN
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Timestamp = ZERO_TIME
    validator_address: bytes = b""
    validator_index: int = 0
    signature: bytes = b""

    # -- wire (types.proto:94: type=1, height=2, round=3, block_id=4
    # non-null, timestamp=5 non-null stdtime, validator_address=6,
    # validator_index=7, signature=8) ------------------------------------

    def encode(self) -> bytes:
        return (
            protoio.field_varint(1, self.type)
            + protoio.field_varint(2, self.height)
            + protoio.field_varint(3, self.round)
            + protoio.field_message(4, self.block_id.encode())
            + protoio.field_message(5, self.timestamp.encode())
            + protoio.field_bytes(6, self.validator_address)
            + protoio.field_varint(7, self.validator_index)
            + protoio.field_bytes(8, self.signature)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Vote":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.type = r.read_uvarint()
            elif f == 2:
                out.height = r.read_varint()
            elif f == 3:
                out.round = r.read_varint()
            elif f == 4:
                out.block_id = BlockID.decode(r.read_bytes())
            elif f == 5:
                out.timestamp = Timestamp.decode(r.read_bytes())
            elif f == 6:
                out.validator_address = r.read_bytes()
            elif f == 7:
                out.validator_index = r.read_varint()
            elif f == 8:
                out.signature = r.read_bytes()
            else:
                r.skip(wt)
        return out

    # -- domain ------------------------------------------------------------

    def sign_bytes(self, chain_id: str) -> bytes:
        return vote_sign_bytes(chain_id, self)

    def verify(self, chain_id: str, pub_key: PubKey) -> None:
        """Reference: types/vote.go:147 — address check then sig check."""
        if pub_key.address() != self.validator_address:
            raise ErrVoteInvalidValidatorAddress("invalid validator address")
        if not pub_key.verify_signature(self.sign_bytes(chain_id), self.signature):
            raise ErrVoteInvalidSignature("invalid signature")

    def is_nil(self) -> bool:
        """A vote for nil (empty block id)."""
        return self.block_id.is_zero()

    def validate_basic(self) -> None:
        if not is_vote_type_valid(self.type):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.block_id.validate_basic()
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got {self.block_id}")
        if len(self.validator_address) != 20:
            raise ValueError("expected ValidatorAddress size 20")
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")

    def to_commit_sig(self):
        """Reference: Vote.CommitSig."""
        from cometbft_tpu_torch.types.block import (
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
            CommitSig,
        )

        flag = BLOCK_ID_FLAG_COMMIT if not self.is_nil() else BLOCK_ID_FLAG_NIL
        return CommitSig(
            block_id_flag=flag,
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )

    def __str__(self) -> str:
        t = {1: "Prevote", 2: "Precommit"}.get(self.type, "?")
        return (
            f"Vote{{{self.validator_index}:{self.validator_address.hex()[:12].upper()} "
            f"{self.height}/{self.round:02d} {t} {self.block_id}}}"
        )


def vote_sign_bytes(chain_id: str, vote: Vote) -> bytes:
    """Reference: types/vote.go:93 VoteSignBytes."""
    return canonical.canonical_vote_bytes(
        chain_id, vote.type, vote.height, vote.round, vote.block_id, vote.timestamp
    )
