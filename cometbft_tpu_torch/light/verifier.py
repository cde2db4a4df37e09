"""Pure light-client verification functions.

Reference: cometbft_tpu/light/verifier.py:38-243 (light/verifier.go —
VerifyAdjacent :93, VerifyNonAdjacent :32, Verify :135, VerifyBackwards
:221, HeaderExpired :207, ValidateTrustLevel :196). Signature checks go
through the batch-verification boundary via
ValidatorSet.verify_commit_light / verify_commit_light_trusting, so
under "gpu" (the default) both the 2/3 check on the new set and the 1/3
trusting check on the old set run on the card, each set's keys resident
there. The untrusted set's hash runs on the device ``backend`` verifies
on (``crypto.batch.backend_device``): the card under "gpu", the host tree
under "cpu". ``backend`` takes anything ``crypto.batch.Backend`` does: a
name, a BackendSpec, a factory callable or a verify scheduler.

Durations are nanoseconds; ``now`` is a proto Timestamp.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto import batch as cryptobatch
from cometbft_tpu_torch.crypto.batch import Backend
from cometbft_tpu_torch.light.errors import (
    ErrInvalidHeader,
    ErrNewValSetCantBeTrusted,
    ErrOldHeaderExpired,
)
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.types.block import Header
from cometbft_tpu_torch.types.light_block import SignedHeader
from cometbft_tpu_torch.types.validator_set import (
    ErrNotEnoughVotingPowerSigned,
    Fraction,
    ValidatorSet,
)

DEFAULT_TRUST_LEVEL = Fraction(1, 3)


def validate_trust_level(lvl: Fraction) -> None:
    """Trust level must be in [1/3, 1] (verifier.go:196)."""
    if (
        lvl.numerator * 3 < lvl.denominator
        or lvl.numerator > lvl.denominator
        or lvl.denominator == 0
    ):
        raise ValueError(
            f"trustLevel must be within [1/3, 1], given {lvl.numerator}/"
            f"{lvl.denominator}"
        )


def header_expired(h: SignedHeader, trusting_period_ns: int, now: Timestamp) -> bool:
    """verifier.go:207 — expired when time + trustingPeriod <= now."""
    expiration_ns = h.header.time.to_unix_ns() + trusting_period_ns
    return expiration_ns <= now.to_unix_ns()


def _verify_new_header_and_vals(
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted_header: SignedHeader,
    now: Timestamp,
    max_clock_drift_ns: int,
    backend: Backend = None,
) -> None:
    """verifier.go:160 verifyNewHeaderAndVals."""
    try:
        untrusted_header.validate_basic(trusted_header.header.chain_id)
    except ValueError as exc:
        raise ValueError(f"untrustedHeader.ValidateBasic failed: {exc}") from exc

    if untrusted_header.height <= trusted_header.height:
        raise ValueError(
            f"expected new header height {untrusted_header.height} to be "
            f"greater than one of old header {trusted_header.height}"
        )
    if (
        untrusted_header.header.time.to_unix_ns()
        <= trusted_header.header.time.to_unix_ns()
    ):
        raise ValueError(
            f"expected new header time {untrusted_header.header.time} to be "
            f"after old header time {trusted_header.header.time}"
        )
    if (
        untrusted_header.header.time.to_unix_ns()
        >= now.to_unix_ns() + max_clock_drift_ns
    ):
        raise ValueError(
            f"new header has a time from the future "
            f"{untrusted_header.header.time} (now: {now})"
        )
    vals_hash = untrusted_vals.hash(device=cryptobatch.backend_device(backend))
    if untrusted_header.header.validators_hash != vals_hash:
        raise ValueError(
            f"expected new header validators "
            f"({untrusted_header.header.validators_hash.hex()}) to match "
            f"those that were supplied ({vals_hash.hex()}) at "
            f"height {untrusted_header.height}"
        )


def verify_adjacent(
    trusted_header: SignedHeader,  # height X
    untrusted_header: SignedHeader,  # height X+1
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now: Timestamp,
    max_clock_drift_ns: int,
    backend: Backend = None,
) -> None:
    """verifier.go:93 VerifyAdjacent."""
    if untrusted_header.height != trusted_header.height + 1:
        raise ValueError("headers must be adjacent in height")
    if header_expired(trusted_header, trusting_period_ns, now):
        raise ErrOldHeaderExpired(
            trusted_header.header.time.add_ns(trusting_period_ns), now
        )
    try:
        _verify_new_header_and_vals(
            untrusted_header, untrusted_vals, trusted_header, now,
            max_clock_drift_ns, backend,
        )
    except ValueError as exc:
        raise ErrInvalidHeader(exc) from exc

    if (
        untrusted_header.header.validators_hash
        != trusted_header.header.next_validators_hash
    ):
        raise ErrInvalidHeader(
            f"expected old header next validators "
            f"({trusted_header.header.next_validators_hash.hex()}) to match "
            f"those from new header "
            f"({untrusted_header.header.validators_hash.hex()})"
        )

    try:
        untrusted_vals.verify_commit_light(
            trusted_header.header.chain_id,
            untrusted_header.commit.block_id,
            untrusted_header.height,
            untrusted_header.commit,
            backend=backend,
        )
    except Exception as exc:
        raise ErrInvalidHeader(exc) from exc


def verify_non_adjacent(
    trusted_header: SignedHeader,  # height X
    trusted_vals: ValidatorSet,  # height X or X+1
    untrusted_header: SignedHeader,  # height Y
    untrusted_vals: ValidatorSet,  # height Y
    trusting_period_ns: int,
    now: Timestamp,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    backend: Backend = None,
) -> None:
    """verifier.go:32 VerifyNonAdjacent."""
    if untrusted_header.height == trusted_header.height + 1:
        raise ValueError("headers must be non adjacent in height")
    if header_expired(trusted_header, trusting_period_ns, now):
        raise ErrOldHeaderExpired(
            trusted_header.header.time.add_ns(trusting_period_ns), now
        )
    try:
        _verify_new_header_and_vals(
            untrusted_header, untrusted_vals, trusted_header, now,
            max_clock_drift_ns, backend,
        )
    except ValueError as exc:
        raise ErrInvalidHeader(exc) from exc

    # 1/3+ of the last-trusted validators must have signed the new header
    try:
        trusted_vals.verify_commit_light_trusting(
            trusted_header.header.chain_id,
            untrusted_header.commit,
            trust_level,
            backend=backend,
        )
    except ErrNotEnoughVotingPowerSigned as exc:
        raise ErrNewValSetCantBeTrusted(exc) from exc

    # 2/3+ of the new set must have signed (LAST check: untrustedVals is
    # attacker-sized in the non-adjacent case — DOS ordering, verifier.go:69)
    try:
        untrusted_vals.verify_commit_light(
            trusted_header.header.chain_id,
            untrusted_header.commit.block_id,
            untrusted_header.height,
            untrusted_header.commit,
            backend=backend,
        )
    except Exception as exc:
        raise ErrInvalidHeader(exc) from exc


def verify(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now: Timestamp,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    backend: Backend = None,
) -> None:
    """verifier.go:135 Verify — dispatch on adjacency."""
    if untrusted_header.height != trusted_header.height + 1:
        verify_non_adjacent(
            trusted_header, trusted_vals, untrusted_header, untrusted_vals,
            trusting_period_ns, now, max_clock_drift_ns, trust_level, backend,
        )
    else:
        verify_adjacent(
            trusted_header, untrusted_header, untrusted_vals,
            trusting_period_ns, now, max_clock_drift_ns, backend,
        )


def verify_backwards(untrusted_header: Header, trusted_header: Header) -> None:
    """verifier.go:221 VerifyBackwards — walk the LastBlockID chain."""
    try:
        untrusted_header.validate_basic()
    except ValueError as exc:
        raise ErrInvalidHeader(exc) from exc
    if untrusted_header.chain_id != trusted_header.chain_id:
        raise ErrInvalidHeader("header belongs to another chain")
    if (
        untrusted_header.time.to_unix_ns()
        >= trusted_header.time.to_unix_ns()
    ):
        raise ErrInvalidHeader(
            f"expected older header time {untrusted_header.time} to be "
            f"before new header time {trusted_header.time}"
        )
    if untrusted_header.hash() != trusted_header.last_block_id.hash:
        raise ErrInvalidHeader(
            f"older header hash {untrusted_header.hash().hex()} does not "
            f"match trusted header's last block "
            f"{trusted_header.last_block_id.hash.hex()}"
        )
