"""State carried across from the reference package, as bytes.

Each ``*_from_reference`` takes what the reference's ``encode()`` (or,
for evidence, ``bytes()``) produces — Tendermint's own protobuf wire —
and returns the port's object, whose ``encode()`` (``bytes()``) gives the
same bytes back: ``ValidatorSet`` (reference types/validator_set.py:458),
``Commit`` (types/block.py:214), ``Header``, ``Block``, ``Vote``
(types/vote.py), ``SignedHeader`` and ``LightBlock``
(types/light_block.py), and a ``DuplicateVoteEvidence`` or
``LightClientAttackEvidence`` (types/evidence.py, the Evidence oneof). An
sr25519 public key has no field in the v0.34 ``keys.proto``, so
``sr25519_pub_key_from_reference`` takes the 32 bytes of the reference's
``PubKeySr25519.bytes()``. For block execution: a ``GenesisDoc`` from
the reference's genesis JSON (types/genesis.py ``to_json``), a ``State``
(state/__init__.py), ``ABCIResponses`` (state/store.py) and a
``BlockMeta`` (types/block.py) from their bytes. No object of the
reference crosses; this module imports nothing of it.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto.sr25519 import PubKeySr25519
from cometbft_tpu_torch.state import State
from cometbft_tpu_torch.state.store import ABCIResponses
from cometbft_tpu_torch.types.block import Block, BlockMeta, Commit, Header
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.evidence import Evidence, decode_evidence
from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote


def validator_set_from_reference(data: bytes) -> ValidatorSet:
    return ValidatorSet.decode(data)


def commit_from_reference(data: bytes) -> Commit:
    return Commit.decode(data)


def header_from_reference(data: bytes) -> Header:
    return Header.decode(data)


def signed_header_from_reference(data: bytes) -> SignedHeader:
    return SignedHeader.decode(data)


def light_block_from_reference(data: bytes) -> LightBlock:
    return LightBlock.decode(data)


def vote_from_reference(data: bytes) -> Vote:
    return Vote.decode(data)


def block_from_reference(data: bytes) -> Block:
    return Block.decode(data)


def evidence_from_reference(data: bytes) -> Evidence:
    """Either evidence type, from the reference's ``Evidence.bytes()``."""
    return decode_evidence(data)


def sr25519_pub_key_from_reference(data: bytes) -> PubKeySr25519:
    return PubKeySr25519(data)


def genesis_doc_from_reference(data: str) -> GenesisDoc:
    """From the reference's ``GenesisDoc.to_json()``."""
    return GenesisDoc.from_json(data)


def state_from_reference(data: bytes) -> State:
    return State.decode(data)


def abci_responses_from_reference(data: bytes) -> ABCIResponses:
    return ABCIResponses.decode(data)


def block_meta_from_reference(data: bytes) -> BlockMeta:
    return BlockMeta.decode(data)
