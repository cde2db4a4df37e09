"""Canonical sign-bytes encodings (reference: cometbft_tpu/types/canonical.py;
types/canonical.go + proto/tendermint/types/canonical.proto).

A vote signature is over MarshalDelimited(CanonicalVote): a varint length
prefix, then the proto encoding with sfixed64 height and round
(types/vote.go:93-101).
"""

from __future__ import annotations

from typing import Optional

from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import Timestamp

SIGNED_MSG_TYPE_PRECOMMIT = 2  # proto/tendermint/types/types.proto


def canonicalize_block_id(block_id) -> Optional[bytes]:
    """CanonicalBlockID proto bytes, or None for a zero block id
    (canonical.go:18)."""
    if block_id.is_zero():
        return None
    psh = protoio.field_varint(
        1, block_id.part_set_header.total
    ) + protoio.field_bytes(2, block_id.part_set_header.hash)
    return protoio.field_bytes(1, block_id.hash) + protoio.field_message(2, psh)


def canonical_vote_bytes(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id,
    timestamp: Timestamp,
) -> bytes:
    """MarshalDelimited(CanonicalVote): type=1 varint, height=2 sfixed64,
    round=3 sfixed64, block_id=4 (nullable), timestamp=5 (non-null),
    chain_id=6 (types/vote.go:93 VoteSignBytes)."""
    out = protoio.field_varint(1, msg_type)
    out += protoio.field_sfixed64(2, height)
    out += protoio.field_sfixed64(3, round_)
    cbid = canonicalize_block_id(block_id)
    if cbid is not None:
        out += protoio.field_message(4, cbid)
    out += protoio.field_message(5, timestamp.encode())
    out += protoio.field_string(6, chain_id)
    return protoio.marshal_delimited(out)


def canonical_proposal_bytes(chain_id: str, proposal) -> bytes:
    """Sign bytes for a Proposal: MarshalDelimited(CanonicalProposal)
    (types/proposal.go ProposalSignBytes): type=1, height=2 sfixed64,
    round=3 sfixed64, pol_round=4 int64, block_id=5, timestamp=6,
    chain_id=7."""
    out = protoio.field_varint(1, proposal.type)
    out += protoio.field_sfixed64(2, proposal.height)
    out += protoio.field_sfixed64(3, proposal.round)
    out += protoio.field_varint(4, proposal.pol_round)
    cbid = canonicalize_block_id(proposal.block_id)
    if cbid is not None:
        out += protoio.field_message(5, cbid)
    out += protoio.field_message(6, proposal.timestamp.encode())
    out += protoio.field_string(7, chain_id)
    return protoio.marshal_delimited(out)
