"""State carried across from the reference package, as bytes.

``validator_set_from_reference`` and ``commit_from_reference`` take what
the reference's ``ValidatorSet.encode()`` (cometbft_tpu/types/
validator_set.py:458) and ``Commit.encode()`` (types/block.py:214) produce
— Tendermint's own protobuf wire — and return the port's objects, whose
``encode()`` gives the same bytes back. No object of the reference
crosses; this module imports nothing of it.
"""

from __future__ import annotations

from cometbft_tpu_torch.types.block import Commit
from cometbft_tpu_torch.types.validator_set import ValidatorSet


def validator_set_from_reference(data: bytes) -> ValidatorSet:
    return ValidatorSet.decode(data)


def commit_from_reference(data: bytes) -> Commit:
    return Commit.decode(data)
