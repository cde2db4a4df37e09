"""Light client error taxonomy (reference: cometbft_tpu/light/errors.py;
light/errors.go)."""

from __future__ import annotations


class ErrOldHeaderExpired(Exception):
    """The trusted header is outside the trusting period."""

    def __init__(self, expired_at, now):
        super().__init__(
            f"old header has expired at {expired_at} (now: {now}); "
            f"can't verify"
        )
        self.expired_at = expired_at
        self.now = now


class ErrInvalidHeader(Exception):
    """The new header is invalid (wraps the reason)."""

    def __init__(self, reason):
        super().__init__(f"invalid header: {reason}")
        self.reason = reason


class ErrNewValSetCantBeTrusted(Exception):
    """< trustLevel of the trusted validator set signed the new header —
    bisection must insert a pivot (not a hard failure)."""

    def __init__(self, reason):
        super().__init__(
            f"can't trust new val set: {reason}"
        )
        self.reason = reason


class ErrVerificationFailed(Exception):
    """Bisection failed hard between two heights."""

    def __init__(self, from_height: int, to_height: int, reason):
        super().__init__(
            f"verify from #{from_height} to #{to_height} failed: {reason}"
        )
        self.from_height = from_height
        self.to_height = to_height
        self.reason = reason


class ErrLightClientAttack(Exception):
    """Conflicting, validly-signed headers detected — divergence between
    the primary and a witness."""


class ErrLightBlockNotFound(Exception):
    """Provider has no block at the requested height."""


class ErrNoResponse(Exception):
    """Provider did not respond."""


class ErrHeightTooHigh(Exception):
    """Requested height above the provider's chain tip."""
