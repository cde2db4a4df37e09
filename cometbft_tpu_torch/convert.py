"""State carried across from the reference package, as bytes.

``validator_set_from_reference`` and ``commit_from_reference`` take what
the reference's ``ValidatorSet.encode()`` (cometbft_tpu/types/
validator_set.py:458) and ``Commit.encode()`` (types/block.py:214) produce
— Tendermint's own protobuf wire — and return the port's objects, whose
``encode()`` gives the same bytes back. An sr25519 public key has no
field in the v0.34 ``keys.proto``, so ``sr25519_pub_key_from_reference``
takes the 32 bytes of the reference's ``PubKeySr25519.bytes()``. No object
of the reference crosses; this module imports nothing of it.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto.sr25519 import PubKeySr25519
from cometbft_tpu_torch.types.block import Commit
from cometbft_tpu_torch.types.validator_set import ValidatorSet


def validator_set_from_reference(data: bytes) -> ValidatorSet:
    return ValidatorSet.decode(data)


def commit_from_reference(data: bytes) -> Commit:
    return Commit.decode(data)


def sr25519_pub_key_from_reference(data: bytes) -> PubKeySr25519:
    return PubKeySr25519(data)
