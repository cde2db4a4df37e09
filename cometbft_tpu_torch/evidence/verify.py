"""Evidence verification.

Reference: cometbft_tpu/evidence/verify.py (evidence/verify.go —
VerifyDuplicateVote :162 and VerifyLightClientAttack :113). A duplicate
vote's two signatures are checked serially with
``PubKey.verify_signature``, as the reference does. A light-client
attack runs VerifyCommitLightTrusting at 1/3 on the common set and
VerifyCommitLight on the conflicting set through ``crypto.batch``: under
"gpu", the default, both on the card with each set's keys resident.
"""

from __future__ import annotations

from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
)
from cometbft_tpu_torch.types.validator_set import Fraction, ValidatorSet

DEFAULT_TRUST_LEVEL = Fraction(1, 3)


def verify_duplicate_vote(
    ev: DuplicateVoteEvidence, chain_id: str, val_set: ValidatorSet
) -> None:
    _, val = val_set.get_by_address(ev.vote_a.validator_address)
    if val is None:
        raise ValueError(
            f"address {ev.vote_a.validator_address.hex()} was not a validator "
            f"at height {ev.height()}"
        )
    pub_key = val.pub_key

    if (
        ev.vote_a.height != ev.vote_b.height
        or ev.vote_a.round != ev.vote_b.round
        or ev.vote_a.type != ev.vote_b.type
    ):
        raise ValueError("h/r/s does not match")
    if ev.vote_a.validator_address != ev.vote_b.validator_address:
        raise ValueError("validator addresses do not match")
    if ev.vote_a.block_id == ev.vote_b.block_id:
        raise ValueError("block IDs are the same - not a real duplicate vote")
    if pub_key.address() != ev.vote_a.validator_address:
        raise ValueError("address doesn't match pubkey")
    if val.voting_power != ev.validator_power:
        raise ValueError(
            f"validator power from evidence and our validator set does not "
            f"match ({ev.validator_power} != {val.voting_power})"
        )
    if val_set.total_voting_power() != ev.total_voting_power:
        raise ValueError(
            f"total voting power from the evidence and our validator set "
            f"does not match ({ev.total_voting_power} != "
            f"{val_set.total_voting_power()})"
        )

    # both votes must carry valid signatures from the equivocator
    if not pub_key.verify_signature(
        ev.vote_a.sign_bytes(chain_id), ev.vote_a.signature
    ):
        raise ValueError("verifying VoteA: invalid signature")
    if not pub_key.verify_signature(
        ev.vote_b.sign_bytes(chain_id), ev.vote_b.signature
    ):
        raise ValueError("verifying VoteB: invalid signature")


def verify_light_client_attack(
    ev: LightClientAttackEvidence,
    common_header,
    trusted_header,
    common_vals: ValidatorSet,
    backend=None,
) -> None:
    """Reference: VerifyLightClientAttack :113 (trust-period expiry is the
    pool's recency check; not repeated here)."""
    cb = ev.conflicting_block
    if common_header.header.height != cb.signed_header.header.height:
        # lunatic attack: single verification jump from the common header
        common_vals.verify_commit_light_trusting(
            trusted_header.header.chain_id,
            cb.signed_header.commit,
            DEFAULT_TRUST_LEVEL,
            backend=backend,
        )
    else:
        if _conflicting_header_is_invalid(ev, trusted_header.header):
            raise ValueError(
                "common height is the same as conflicting block height so "
                "expected the conflicting block to be correctly derived yet "
                "it wasn't"
            )

    # 2/3+ of the conflicting validator set signed the conflicting header
    cb.validator_set.verify_commit_light(
        trusted_header.header.chain_id,
        cb.signed_header.commit.block_id,
        cb.signed_header.header.height,
        cb.signed_header.commit,
        backend=backend,
    )

    if ev.total_voting_power != common_vals.total_voting_power():
        raise ValueError(
            "total voting power from the evidence and our validator set "
            f"does not match ({ev.total_voting_power} != "
            f"{common_vals.total_voting_power()})"
        )

    if (
        cb.signed_header.header.height > trusted_header.header.height
        and cb.signed_header.header.time > trusted_header.header.time
    ):
        raise ValueError(
            "conflicting block doesn't violate monotonically increasing time"
        )
    elif trusted_header.header.hash() == cb.signed_header.header.hash():
        raise ValueError(
            "trusted header hash matches the evidence's conflicting header hash"
        )


def _conflicting_header_is_invalid(
    ev: LightClientAttackEvidence, trusted_header
) -> bool:
    """Reference: types LightClientAttackEvidence.ConflictingHeaderIsInvalid
    — for equivocation/amnesia the derived hashes must agree."""
    h = ev.conflicting_block.signed_header.header
    return (
        trusted_header.consensus_hash != h.consensus_hash
        or trusted_header.next_validators_hash != h.next_validators_hash
        or trusted_header.height != h.height
        or trusted_header.chain_id != h.chain_id
    )
