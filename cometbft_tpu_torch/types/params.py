"""Consensus parameters.

Ported from cometbft_tpu/types/params.py.

Reference: types/params.go — defaults (:25-66), validation, HashedParams
(:137 — only block max bytes/gas feed the ConsensusHash).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.libs import protoio

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MiB (types/params.go MaxBlockSizeBytes)
BLOCK_PART_SIZE_BYTES = 65536

ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21MB (DefaultBlockParams)
    max_gas: int = -1
    time_iota_ms: int = 1000

    def encode(self) -> bytes:
        return (
            protoio.field_varint(1, self.max_bytes)
            + protoio.field_varint(2, self.max_gas)
            + protoio.field_varint(3, self.time_iota_ms)
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockParams":
        r = protoio.WireReader(data)
        out = cls(0, 0, 0)
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.max_bytes = r.read_varint()
            elif f == 2:
                out.max_gas = r.read_varint()
            elif f == 3:
                out.time_iota_ms = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000  # 48h
    max_bytes: int = 1048576  # 1MB

    def encode(self) -> bytes:
        # Duration proto: {int64 seconds=1, int32 nanos=2}
        secs = self.max_age_duration_ns // 1_000_000_000
        nanos = self.max_age_duration_ns % 1_000_000_000
        dur = protoio.field_varint(1, secs) + protoio.field_varint(2, nanos)
        return (
            protoio.field_varint(1, self.max_age_num_blocks)
            + protoio.field_message(2, dur)
            + protoio.field_varint(3, self.max_bytes)
        )

    @classmethod
    def decode(cls, data: bytes) -> "EvidenceParams":
        r = protoio.WireReader(data)
        out = cls(0, 0, 0)
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.max_age_num_blocks = r.read_varint()
            elif f == 2:
                dr = protoio.WireReader(r.read_bytes())
                secs, nanos = 0, 0
                while not dr.at_end():
                    df, dwt = dr.read_tag()
                    if df == 1:
                        secs = dr.read_varint()
                    elif df == 2:
                        nanos = dr.read_varint()
                    else:
                        dr.skip(dwt)
                out.max_age_duration_ns = secs * 1_000_000_000 + nanos
            elif f == 3:
                out.max_bytes = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class ValidatorParams:
    pub_key_types: List[str] = field(
        default_factory=lambda: [ABCI_PUBKEY_TYPE_ED25519]
    )

    def encode(self) -> bytes:
        out = b""
        for t in self.pub_key_types:
            out += protoio.field_string(1, t)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ValidatorParams":
        r = protoio.WireReader(data)
        out = cls([])
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.pub_key_types.append(r.read_string())
            else:
                r.skip(wt)
        return out


@dataclass
class VersionParams:
    app_version: int = 0

    def encode(self) -> bytes:
        return protoio.field_varint(1, self.app_version)

    @classmethod
    def decode(cls, data: bytes) -> "VersionParams":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.app_version = r.read_uvarint()
            else:
                r.skip(wt)
        return out


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)

    def hash(self) -> bytes:
        """HashedParams{block_max_bytes=1, block_max_gas=2}
        (types/params.go:137)."""
        hp = protoio.field_varint(1, self.block.max_bytes) + protoio.field_varint(
            2, self.block.max_gas
        )
        return tmhash.sum(hp)

    def encode(self) -> bytes:
        return (
            protoio.field_message(1, self.block.encode())
            + protoio.field_message(2, self.evidence.encode())
            + protoio.field_message(3, self.validator.encode())
            + protoio.field_message(4, self.version.encode())
        )

    @classmethod
    def decode(cls, data: bytes) -> "ConsensusParams":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.block = BlockParams.decode(r.read_bytes())
            elif f == 2:
                out.evidence = EvidenceParams.decode(r.read_bytes())
            elif f == 3:
                out.validator = ValidatorParams.decode(r.read_bytes())
            elif f == 4:
                out.version = VersionParams.decode(r.read_bytes())
            else:
                r.skip(wt)
        return out

    def validate_basic(self) -> None:
        if self.block.max_bytes <= 0:
            raise ValueError("block.MaxBytes must be greater than 0")
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.MaxBytes too big")
        if self.block.max_gas < -1:
            raise ValueError("block.MaxGas must be >= -1")
        if self.block.time_iota_ms <= 0:
            raise ValueError("block.TimeIotaMs must be greater than 0")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be greater than 0")
        if self.evidence.max_age_duration_ns <= 0:
            raise ValueError("evidence.MaxAgeDuration must be grater than 0")
        if (
            self.evidence.max_bytes > self.block.max_bytes
            or self.evidence.max_bytes < 0
        ):
            raise ValueError("evidence.MaxBytes out of range")
        if not self.validator.pub_key_types:
            raise ValueError("validator.PubKeyTypes must not be empty")
        for t in self.validator.pub_key_types:
            if t not in (ABCI_PUBKEY_TYPE_ED25519, ABCI_PUBKEY_TYPE_SECP256K1):
                raise ValueError(f"unknown pubkey type {t!r}")

    def update(self, changes) -> "ConsensusParams":
        """Apply ABCI param updates (reference: params.go Update)."""
        res = ConsensusParams(
            BlockParams(**vars(self.block)),
            EvidenceParams(**vars(self.evidence)),
            ValidatorParams(list(self.validator.pub_key_types)),
            VersionParams(self.version.app_version),
        )
        if changes is None:
            return res
        if changes.block is not None:
            res.block.max_bytes = changes.block.max_bytes
            res.block.max_gas = changes.block.max_gas
        if changes.evidence is not None:
            res.evidence = EvidenceParams(
                changes.evidence.max_age_num_blocks,
                changes.evidence.max_age_duration_ns,
                changes.evidence.max_bytes,
            )
        if changes.validator is not None:
            res.validator = ValidatorParams(list(changes.validator.pub_key_types))
        if changes.version is not None:
            res.version = VersionParams(changes.version.app_version)
        return res


def _params_to_json(p: ConsensusParams) -> dict:
    """Genesis-file JSON form (int64s as strings, amino-style)."""
    return {
        "block": {
            "max_bytes": str(p.block.max_bytes),
            "max_gas": str(p.block.max_gas),
            "time_iota_ms": str(p.block.time_iota_ms),
        },
        "evidence": {
            "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
            "max_age_duration": str(p.evidence.max_age_duration_ns),
            "max_bytes": str(p.evidence.max_bytes),
        },
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
        "version": (
            {"app_version": str(p.version.app_version)}
            if p.version.app_version
            else {}
        ),
    }


def _params_from_json(obj: dict) -> ConsensusParams:
    p = ConsensusParams()
    b = obj.get("block") or {}
    p.block = BlockParams(
        max_bytes=int(b.get("max_bytes", p.block.max_bytes)),
        max_gas=int(b.get("max_gas", p.block.max_gas)),
        time_iota_ms=int(b.get("time_iota_ms", p.block.time_iota_ms)),
    )
    e = obj.get("evidence") or {}
    p.evidence = EvidenceParams(
        max_age_num_blocks=int(
            e.get("max_age_num_blocks", p.evidence.max_age_num_blocks)
        ),
        max_age_duration_ns=int(
            e.get("max_age_duration", p.evidence.max_age_duration_ns)
        ),
        max_bytes=int(e.get("max_bytes", p.evidence.max_bytes)),
    )
    v = obj.get("validator") or {}
    if v.get("pub_key_types"):
        p.validator = ValidatorParams(list(v["pub_key_types"]))
    ver = obj.get("version") or {}
    if ver.get("app_version"):
        p.version = VersionParams(int(ver["app_version"]))
    return p


def _params_empty() -> "ConsensusParams":
    """All-zero params — the 'not persisted at this height' sentinel used
    by the state store's back-pointer scheme (state/store.go:265)."""
    return ConsensusParams(
        BlockParams(0, 0, 0), EvidenceParams(0, 0, 0), ValidatorParams([]),
        VersionParams(0),
    )


def _params_is_empty(p: "ConsensusParams") -> bool:
    return p == _params_empty()


ConsensusParams.to_json = _params_to_json
ConsensusParams.from_json = staticmethod(_params_from_json)
ConsensusParams.empty = staticmethod(_params_empty)
ConsensusParams.is_empty = _params_is_empty


def default_consensus_params() -> ConsensusParams:
    """Reference: types/params.go DefaultConsensusParams — a fresh value
    each call (params are mutable per-height state)."""
    return ConsensusParams()


DEFAULT_CONSENSUS_PARAMS = default_consensus_params()
