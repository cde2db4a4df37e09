"""ABCI message types, wire-compatible with the reference.

Ported from cometbft_tpu/abci/types.py.

Field numbers per the reference's proto/tendermint/abci/types.proto
(Request oneof :23-41, Response oneof :134-153, misc :330-415). Messages
are plain dataclasses with hand-rolled proto encode/decode over
libs.protoio — the same approach the rest of the wire layer uses (no
protoc dependency; layouts asserted against golden vectors in tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import Timestamp, ZERO_TIME
from cometbft_tpu_torch.proto.keys import PublicKeyProto

CODE_TYPE_OK = 0

# CheckTxType enum
CHECK_TX_TYPE_NEW = 0
CHECK_TX_TYPE_RECHECK = 1

# EvidenceType enum
EVIDENCE_TYPE_UNKNOWN = 0
EVIDENCE_TYPE_DUPLICATE_VOTE = 1
EVIDENCE_TYPE_LIGHT_CLIENT_ATTACK = 2

# ResponseOfferSnapshot.Result
OFFER_SNAPSHOT_UNKNOWN = 0
OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5

# ResponseApplySnapshotChunk.Result
APPLY_CHUNK_UNKNOWN = 0
APPLY_CHUNK_ACCEPT = 1
APPLY_CHUNK_ABORT = 2
APPLY_CHUNK_RETRY = 3
APPLY_CHUNK_RETRY_SNAPSHOT = 4
APPLY_CHUNK_REJECT_SNAPSHOT = 5


def _decode_repeated(data: bytes, factory):
    out = []
    r = protoio.WireReader(data)
    while not r.at_end():
        f, wt = r.read_tag()
        if f == 1:
            out.append(factory(r.read_bytes()))
        else:
            r.skip(wt)
    return out


# --- misc -------------------------------------------------------------------


@dataclass
class EventAttribute:
    key: bytes = b""
    value: bytes = b""
    index: bool = False

    def encode(self) -> bytes:
        out = protoio.field_bytes(1, self.key) + protoio.field_bytes(2, self.value)
        if self.index:
            out += protoio.field_varint(3, 1)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "EventAttribute":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.key = r.read_bytes()
            elif f == 2:
                out.value = r.read_bytes()
            elif f == 3:
                out.index = bool(r.read_varint())
            else:
                r.skip(wt)
        return out


@dataclass
class Event:
    type: str = ""
    attributes: List[EventAttribute] = field(default_factory=list)

    def encode(self) -> bytes:
        out = protoio.field_string(1, self.type)
        for a in self.attributes:
            out += protoio.field_message(2, a.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Event":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.type = r.read_string()
            elif f == 2:
                out.attributes.append(EventAttribute.decode(r.read_bytes()))
            else:
                r.skip(wt)
        return out


def encode_events(events: List[Event], field_num: int) -> bytes:
    return b"".join(protoio.field_message(field_num, e.encode()) for e in events)


@dataclass
class Validator:
    """abci.Validator — address + power (no pubkey)."""

    address: bytes = b""
    power: int = 0

    def encode(self) -> bytes:
        return protoio.field_bytes(1, self.address) + protoio.field_varint(
            3, self.power
        )

    @classmethod
    def decode(cls, data: bytes) -> "Validator":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.address = r.read_bytes()
            elif f == 3:
                out.power = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class ValidatorUpdate:
    pub_key: PublicKeyProto = field(
        default_factory=lambda: PublicKeyProto("ed25519", b"")
    )
    power: int = 0

    def encode(self) -> bytes:
        return protoio.field_message(1, self.pub_key.encode()) + protoio.field_varint(
            2, self.power
        )

    @classmethod
    def decode(cls, data: bytes) -> "ValidatorUpdate":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.pub_key = PublicKeyProto.decode(r.read_bytes())
            elif f == 2:
                out.power = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class VoteInfo:
    validator: Validator = field(default_factory=Validator)
    signed_last_block: bool = False

    def encode(self) -> bytes:
        out = protoio.field_message(1, self.validator.encode())
        if self.signed_last_block:
            out += protoio.field_varint(2, 1)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "VoteInfo":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.validator = Validator.decode(r.read_bytes())
            elif f == 2:
                out.signed_last_block = bool(r.read_varint())
            else:
                r.skip(wt)
        return out


@dataclass
class LastCommitInfo:
    round: int = 0
    votes: List[VoteInfo] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        if self.round:
            out += protoio.field_varint(1, self.round)
        for v in self.votes:
            out += protoio.field_message(2, v.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "LastCommitInfo":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.round = r.read_varint()
            elif f == 2:
                out.votes.append(VoteInfo.decode(r.read_bytes()))
            else:
                r.skip(wt)
        return out


@dataclass
class Misbehavior:
    """abci.Evidence (types.proto:384-398)."""

    type: int = EVIDENCE_TYPE_UNKNOWN
    validator: Validator = field(default_factory=Validator)
    height: int = 0
    time: Timestamp = ZERO_TIME
    total_voting_power: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.type:
            out += protoio.field_varint(1, self.type)
        out += protoio.field_message(2, self.validator.encode())
        if self.height:
            out += protoio.field_varint(3, self.height)
        out += protoio.field_message(4, self.time.encode())
        if self.total_voting_power:
            out += protoio.field_varint(5, self.total_voting_power)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Misbehavior":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.type = r.read_varint()
            elif f == 2:
                out.validator = Validator.decode(r.read_bytes())
            elif f == 3:
                out.height = r.read_varint()
            elif f == 4:
                out.time = Timestamp.decode(r.read_bytes())
            elif f == 5:
                out.total_voting_power = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.height:
            out += protoio.field_varint(1, self.height)
        if self.format:
            out += protoio.field_varint(2, self.format)
        if self.chunks:
            out += protoio.field_varint(3, self.chunks)
        out += protoio.field_bytes(4, self.hash)
        out += protoio.field_bytes(5, self.metadata)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Snapshot":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.height = r.read_varint()
            elif f == 2:
                out.format = r.read_varint()
            elif f == 3:
                out.chunks = r.read_varint()
            elif f == 4:
                out.hash = r.read_bytes()
            elif f == 5:
                out.metadata = r.read_bytes()
            else:
                r.skip(wt)
        return out


@dataclass
class RollappParams:
    """Fork-specific (types.proto:400-403)."""

    da: str = ""
    drs_version: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.da:
            out += protoio.field_string(1, self.da)
        if self.drs_version:
            out += protoio.field_varint(2, self.drs_version)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RollappParams":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.da = r.read_string()
            elif f == 2:
                out.drs_version = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class TxResult:
    """abci.TxResult — indexing payload (types.proto:348-354)."""

    height: int = 0
    index: int = 0
    tx: bytes = b""
    result: "ResponseDeliverTx" = None  # type: ignore[assignment]

    def encode(self) -> bytes:
        out = b""
        if self.height:
            out += protoio.field_varint(1, self.height)
        if self.index:
            out += protoio.field_varint(2, self.index)
        out += protoio.field_bytes(3, self.tx)
        res = self.result if self.result is not None else ResponseDeliverTx()
        out += protoio.field_message(4, res.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "TxResult":
        r = protoio.WireReader(data)
        out = cls(result=ResponseDeliverTx())
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.height = r.read_varint()
            elif f == 2:
                out.index = r.read_varint()
            elif f == 3:
                out.tx = r.read_bytes()
            elif f == 4:
                out.result = ResponseDeliverTx.decode(r.read_bytes())
            else:
                r.skip(wt)
        return out


# --- ABCI consensus params (distinct from types.ConsensusParams:
#     BlockParams here has no time_iota_ms — types.proto:310-323) -----------


@dataclass
class AbciBlockParams:
    max_bytes: int = 0
    max_gas: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.max_bytes:
            out += protoio.field_varint(1, self.max_bytes)
        if self.max_gas:
            out += protoio.field_varint(2, self.max_gas)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "AbciBlockParams":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.max_bytes = r.read_varint()
            elif f == 2:
                out.max_gas = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class AbciConsensusParams:
    """abci.ConsensusParams — every section optional (nullable)."""

    block: Optional[AbciBlockParams] = None
    evidence: Optional[object] = None  # types.EvidenceParams
    validator: Optional[object] = None  # types.ValidatorParams
    version: Optional[object] = None  # types.VersionParams

    def encode(self) -> bytes:
        out = b""
        if self.block is not None:
            out += protoio.field_message(1, self.block.encode())
        if self.evidence is not None:
            out += protoio.field_message(2, self.evidence.encode())
        if self.validator is not None:
            out += protoio.field_message(3, self.validator.encode())
        if self.version is not None:
            out += protoio.field_message(4, self.version.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "AbciConsensusParams":
        from cometbft_tpu_torch.types.params import (
            EvidenceParams,
            ValidatorParams,
            VersionParams,
        )

        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.block = AbciBlockParams.decode(r.read_bytes())
            elif f == 2:
                out.evidence = EvidenceParams.decode(r.read_bytes())
            elif f == 3:
                out.validator = ValidatorParams.decode(r.read_bytes())
            elif f == 4:
                out.version = VersionParams.decode(r.read_bytes())
            else:
                r.skip(wt)
        return out


# --- requests ---------------------------------------------------------------


@dataclass
class RequestEcho:
    message: str = ""

    def encode(self) -> bytes:
        return protoio.field_string(1, self.message)

    @classmethod
    def decode(cls, data: bytes) -> "RequestEcho":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.message = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestFlush:
    def encode(self) -> bytes:
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "RequestFlush":
        return cls()


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.version:
            out += protoio.field_string(1, self.version)
        if self.block_version:
            out += protoio.field_varint(2, self.block_version)
        if self.p2p_version:
            out += protoio.field_varint(3, self.p2p_version)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestInfo":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.version = r.read_string()
            elif f == 2:
                out.block_version = r.read_varint()
            elif f == 3:
                out.p2p_version = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestSetOption:
    key: str = ""
    value: str = ""

    def encode(self) -> bytes:
        out = b""
        if self.key:
            out += protoio.field_string(1, self.key)
        if self.value:
            out += protoio.field_string(2, self.value)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestSetOption":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.key = r.read_string()
            elif f == 2:
                out.value = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestInitChain:
    time: Timestamp = ZERO_TIME
    chain_id: str = ""
    consensus_params: Optional[AbciConsensusParams] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 0
    genesis_checksum: str = ""  # fork extension (types.proto:69)

    def encode(self) -> bytes:
        out = protoio.field_message(1, self.time.encode())
        if self.chain_id:
            out += protoio.field_string(2, self.chain_id)
        if self.consensus_params is not None:
            out += protoio.field_message(3, self.consensus_params.encode())
        for v in self.validators:
            out += protoio.field_message(4, v.encode())
        out += protoio.field_bytes(5, self.app_state_bytes)
        if self.initial_height:
            out += protoio.field_varint(6, self.initial_height)
        if self.genesis_checksum:
            out += protoio.field_string(7, self.genesis_checksum)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestInitChain":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.time = Timestamp.decode(r.read_bytes())
            elif f == 2:
                out.chain_id = r.read_string()
            elif f == 3:
                out.consensus_params = AbciConsensusParams.decode(r.read_bytes())
            elif f == 4:
                out.validators.append(ValidatorUpdate.decode(r.read_bytes()))
            elif f == 5:
                out.app_state_bytes = r.read_bytes()
            elif f == 6:
                out.initial_height = r.read_varint()
            elif f == 7:
                out.genesis_checksum = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False

    def encode(self) -> bytes:
        out = protoio.field_bytes(1, self.data)
        if self.path:
            out += protoio.field_string(2, self.path)
        if self.height:
            out += protoio.field_varint(3, self.height)
        if self.prove:
            out += protoio.field_varint(4, 1)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestQuery":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.data = r.read_bytes()
            elif f == 2:
                out.path = r.read_string()
            elif f == 3:
                out.height = r.read_varint()
            elif f == 4:
                out.prove = bool(r.read_varint())
            else:
                r.skip(wt)
        return out


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header: object = None  # types.Header (non-null on the wire)
    last_commit_info: LastCommitInfo = field(default_factory=LastCommitInfo)
    byzantine_validators: List[Misbehavior] = field(default_factory=list)

    def encode(self) -> bytes:
        from cometbft_tpu_torch.types.block import Header

        out = protoio.field_bytes(1, self.hash)
        hdr = self.header if self.header is not None else Header()
        out += protoio.field_message(2, hdr.encode())
        out += protoio.field_message(3, self.last_commit_info.encode())
        for e in self.byzantine_validators:
            out += protoio.field_message(4, e.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestBeginBlock":
        from cometbft_tpu_torch.types.block import Header

        r = protoio.WireReader(data)
        out = cls(header=Header())
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.hash = r.read_bytes()
            elif f == 2:
                out.header = Header.decode(r.read_bytes())
            elif f == 3:
                out.last_commit_info = LastCommitInfo.decode(r.read_bytes())
            elif f == 4:
                out.byzantine_validators.append(Misbehavior.decode(r.read_bytes()))
            else:
                r.skip(wt)
        return out


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CHECK_TX_TYPE_NEW

    def encode(self) -> bytes:
        out = protoio.field_bytes(1, self.tx)
        if self.type:
            out += protoio.field_varint(2, self.type)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestCheckTx":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.tx = r.read_bytes()
            elif f == 2:
                out.type = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestDeliverTx:
    tx: bytes = b""

    def encode(self) -> bytes:
        return protoio.field_bytes(1, self.tx)

    @classmethod
    def decode(cls, data: bytes) -> "RequestDeliverTx":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.tx = r.read_bytes()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestEndBlock:
    height: int = 0

    def encode(self) -> bytes:
        return protoio.field_varint(1, self.height) if self.height else b""

    @classmethod
    def decode(cls, data: bytes) -> "RequestEndBlock":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.height = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestCommit:
    def encode(self) -> bytes:
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "RequestCommit":
        return cls()


@dataclass
class RequestListSnapshots:
    def encode(self) -> bytes:
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "RequestListSnapshots":
        return cls()


@dataclass
class RequestOfferSnapshot:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.snapshot is not None:
            out += protoio.field_message(1, self.snapshot.encode())
        out += protoio.field_bytes(2, self.app_hash)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestOfferSnapshot":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.snapshot = Snapshot.decode(r.read_bytes())
            elif f == 2:
                out.app_hash = r.read_bytes()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.height:
            out += protoio.field_varint(1, self.height)
        if self.format:
            out += protoio.field_varint(2, self.format)
        if self.chunk:
            out += protoio.field_varint(3, self.chunk)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestLoadSnapshotChunk":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.height = r.read_varint()
            elif f == 2:
                out.format = r.read_varint()
            elif f == 3:
                out.chunk = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""

    def encode(self) -> bytes:
        out = b""
        if self.index:
            out += protoio.field_varint(1, self.index)
        out += protoio.field_bytes(2, self.chunk)
        if self.sender:
            out += protoio.field_string(3, self.sender)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RequestApplySnapshotChunk":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.index = r.read_varint()
            elif f == 2:
                out.chunk = r.read_bytes()
            elif f == 3:
                out.sender = r.read_string()
            else:
                r.skip(wt)
        return out


# --- responses --------------------------------------------------------------


@dataclass
class ResponseException:
    error: str = ""

    def encode(self) -> bytes:
        return protoio.field_string(1, self.error) if self.error else b""

    @classmethod
    def decode(cls, data: bytes) -> "ResponseException":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.error = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseEcho:
    message: str = ""

    def encode(self) -> bytes:
        return protoio.field_string(1, self.message) if self.message else b""

    @classmethod
    def decode(cls, data: bytes) -> "ResponseEcho":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.message = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseFlush:
    def encode(self) -> bytes:
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "ResponseFlush":
        return cls()


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.data:
            out += protoio.field_string(1, self.data)
        if self.version:
            out += protoio.field_string(2, self.version)
        if self.app_version:
            out += protoio.field_varint(3, self.app_version)
        if self.last_block_height:
            out += protoio.field_varint(4, self.last_block_height)
        out += protoio.field_bytes(5, self.last_block_app_hash)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseInfo":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.data = r.read_string()
            elif f == 2:
                out.version = r.read_string()
            elif f == 3:
                out.app_version = r.read_varint()
            elif f == 4:
                out.last_block_height = r.read_varint()
            elif f == 5:
                out.last_block_app_hash = r.read_bytes()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseSetOption:
    code: int = 0
    log: str = ""
    info: str = ""

    def encode(self) -> bytes:
        out = b""
        if self.code:
            out += protoio.field_varint(1, self.code)
        if self.log:
            out += protoio.field_string(3, self.log)
        if self.info:
            out += protoio.field_string(4, self.info)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseSetOption":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.code = r.read_varint()
            elif f == 3:
                out.log = r.read_string()
            elif f == 4:
                out.info = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseInitChain:
    consensus_params: Optional[AbciConsensusParams] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""
    rollapp_params: Optional[RollappParams] = None  # fork extension
    genesis_bridge_data_bytes: bytes = b""  # fork extension

    def encode(self) -> bytes:
        out = b""
        if self.consensus_params is not None:
            out += protoio.field_message(1, self.consensus_params.encode())
        for v in self.validators:
            out += protoio.field_message(2, v.encode())
        out += protoio.field_bytes(3, self.app_hash)
        if self.rollapp_params is not None:
            out += protoio.field_message(4, self.rollapp_params.encode())
        out += protoio.field_bytes(5, self.genesis_bridge_data_bytes)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseInitChain":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.consensus_params = AbciConsensusParams.decode(r.read_bytes())
            elif f == 2:
                out.validators.append(ValidatorUpdate.decode(r.read_bytes()))
            elif f == 3:
                out.app_hash = r.read_bytes()
            elif f == 4:
                out.rollapp_params = RollappParams.decode(r.read_bytes())
            elif f == 5:
                out.genesis_bridge_data_bytes = r.read_bytes()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseQuery:
    code: int = 0
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: Optional[object] = None  # crypto.ProofOps
    height: int = 0
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        out = b""
        if self.code:
            out += protoio.field_varint(1, self.code)
        if self.log:
            out += protoio.field_string(3, self.log)
        if self.info:
            out += protoio.field_string(4, self.info)
        if self.index:
            out += protoio.field_varint(5, self.index)
        out += protoio.field_bytes(6, self.key)
        out += protoio.field_bytes(7, self.value)
        if self.proof_ops is not None:
            out += protoio.field_message(8, self.proof_ops.encode())
        if self.height:
            out += protoio.field_varint(9, self.height)
        if self.codespace:
            out += protoio.field_string(10, self.codespace)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseQuery":
        from cometbft_tpu_torch.crypto.merkle import ProofOps

        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.code = r.read_varint()
            elif f == 3:
                out.log = r.read_string()
            elif f == 4:
                out.info = r.read_string()
            elif f == 5:
                out.index = r.read_varint()
            elif f == 6:
                out.key = r.read_bytes()
            elif f == 7:
                out.value = r.read_bytes()
            elif f == 8:
                out.proof_ops = ProofOps.decode(r.read_bytes())
            elif f == 9:
                out.height = r.read_varint()
            elif f == 10:
                out.codespace = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseBeginBlock:
    events: List[Event] = field(default_factory=list)

    def encode(self) -> bytes:
        return encode_events(self.events, 1)

    @classmethod
    def decode(cls, data: bytes) -> "ResponseBeginBlock":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.events.append(Event.decode(r.read_bytes()))
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseCheckTx:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""
    sender: str = ""
    priority: int = 0
    mempool_error: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        out = b""
        if self.code:
            out += protoio.field_varint(1, self.code)
        out += protoio.field_bytes(2, self.data)
        if self.log:
            out += protoio.field_string(3, self.log)
        if self.info:
            out += protoio.field_string(4, self.info)
        if self.gas_wanted:
            out += protoio.field_varint(5, self.gas_wanted)
        if self.gas_used:
            out += protoio.field_varint(6, self.gas_used)
        out += encode_events(self.events, 7)
        if self.codespace:
            out += protoio.field_string(8, self.codespace)
        if self.sender:
            out += protoio.field_string(9, self.sender)
        if self.priority:
            out += protoio.field_varint(10, self.priority)
        if self.mempool_error:
            out += protoio.field_string(11, self.mempool_error)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseCheckTx":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.code = r.read_varint()
            elif f == 2:
                out.data = r.read_bytes()
            elif f == 3:
                out.log = r.read_string()
            elif f == 4:
                out.info = r.read_string()
            elif f == 5:
                out.gas_wanted = r.read_varint()
            elif f == 6:
                out.gas_used = r.read_varint()
            elif f == 7:
                out.events.append(Event.decode(r.read_bytes()))
            elif f == 8:
                out.codespace = r.read_string()
            elif f == 9:
                out.sender = r.read_string()
            elif f == 10:
                out.priority = r.read_varint()
            elif f == 11:
                out.mempool_error = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseDeliverTx:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        out = b""
        if self.code:
            out += protoio.field_varint(1, self.code)
        out += protoio.field_bytes(2, self.data)
        if self.log:
            out += protoio.field_string(3, self.log)
        if self.info:
            out += protoio.field_string(4, self.info)
        if self.gas_wanted:
            out += protoio.field_varint(5, self.gas_wanted)
        if self.gas_used:
            out += protoio.field_varint(6, self.gas_used)
        out += encode_events(self.events, 7)
        if self.codespace:
            out += protoio.field_string(8, self.codespace)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseDeliverTx":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.code = r.read_varint()
            elif f == 2:
                out.data = r.read_bytes()
            elif f == 3:
                out.log = r.read_string()
            elif f == 4:
                out.info = r.read_string()
            elif f == 5:
                out.gas_wanted = r.read_varint()
            elif f == 6:
                out.gas_used = r.read_varint()
            elif f == 7:
                out.events.append(Event.decode(r.read_bytes()))
            elif f == 8:
                out.codespace = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseEndBlock:
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[AbciConsensusParams] = None
    events: List[Event] = field(default_factory=list)
    rollapp_param_updates: Optional[RollappParams] = None  # fork extension

    def encode(self) -> bytes:
        out = b""
        for v in self.validator_updates:
            out += protoio.field_message(1, v.encode())
        if self.consensus_param_updates is not None:
            out += protoio.field_message(2, self.consensus_param_updates.encode())
        out += encode_events(self.events, 3)
        if self.rollapp_param_updates is not None:
            out += protoio.field_message(4, self.rollapp_param_updates.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseEndBlock":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.validator_updates.append(ValidatorUpdate.decode(r.read_bytes()))
            elif f == 2:
                out.consensus_param_updates = AbciConsensusParams.decode(
                    r.read_bytes()
                )
            elif f == 3:
                out.events.append(Event.decode(r.read_bytes()))
            elif f == 4:
                out.rollapp_param_updates = RollappParams.decode(r.read_bytes())
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseCommit:
    data: bytes = b""  # the new app hash (field 2; field 1 reserved)
    retain_height: int = 0

    def encode(self) -> bytes:
        out = protoio.field_bytes(2, self.data)
        if self.retain_height:
            out += protoio.field_varint(3, self.retain_height)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseCommit":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 2:
                out.data = r.read_bytes()
            elif f == 3:
                out.retain_height = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseListSnapshots:
    snapshots: List[Snapshot] = field(default_factory=list)

    def encode(self) -> bytes:
        return b"".join(
            protoio.field_message(1, s.encode()) for s in self.snapshots
        )

    @classmethod
    def decode(cls, data: bytes) -> "ResponseListSnapshots":
        return cls(_decode_repeated(data, Snapshot.decode))


@dataclass
class ResponseOfferSnapshot:
    result: int = OFFER_SNAPSHOT_UNKNOWN

    def encode(self) -> bytes:
        return protoio.field_varint(1, self.result) if self.result else b""

    @classmethod
    def decode(cls, data: bytes) -> "ResponseOfferSnapshot":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.result = r.read_varint()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""

    def encode(self) -> bytes:
        return protoio.field_bytes(1, self.chunk)

    @classmethod
    def decode(cls, data: bytes) -> "ResponseLoadSnapshotChunk":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.chunk = r.read_bytes()
            else:
                r.skip(wt)
        return out


@dataclass
class ResponseApplySnapshotChunk:
    result: int = APPLY_CHUNK_UNKNOWN
    refetch_chunks: List[int] = field(default_factory=list)
    reject_senders: List[str] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        if self.result:
            out += protoio.field_varint(1, self.result)
        for c in self.refetch_chunks:
            out += protoio.field_varint(2, c)
        for s in self.reject_senders:
            out += protoio.field_string(3, s)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseApplySnapshotChunk":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.result = r.read_varint()
            elif f == 2:
                out.refetch_chunks.append(r.read_varint())
            elif f == 3:
                out.reject_senders.append(r.read_string())
            else:
                r.skip(wt)
        return out


# --- Request / Response oneof wrappers -------------------------------------

_REQUEST_FIELDS = {
    "echo": (1, RequestEcho),
    "flush": (2, RequestFlush),
    "info": (3, RequestInfo),
    "set_option": (4, RequestSetOption),
    "init_chain": (5, RequestInitChain),
    "query": (6, RequestQuery),
    "begin_block": (7, RequestBeginBlock),
    "check_tx": (8, RequestCheckTx),
    "deliver_tx": (9, RequestDeliverTx),
    "end_block": (10, RequestEndBlock),
    "commit": (11, RequestCommit),
    "list_snapshots": (12, RequestListSnapshots),
    "offer_snapshot": (13, RequestOfferSnapshot),
    "load_snapshot_chunk": (14, RequestLoadSnapshotChunk),
    "apply_snapshot_chunk": (15, RequestApplySnapshotChunk),
}

_RESPONSE_FIELDS = {
    "exception": (1, ResponseException),
    "echo": (2, ResponseEcho),
    "flush": (3, ResponseFlush),
    "info": (4, ResponseInfo),
    "set_option": (5, ResponseSetOption),
    "init_chain": (6, ResponseInitChain),
    "query": (7, ResponseQuery),
    "begin_block": (8, ResponseBeginBlock),
    "check_tx": (9, ResponseCheckTx),
    "deliver_tx": (10, ResponseDeliverTx),
    "end_block": (11, ResponseEndBlock),
    "commit": (12, ResponseCommit),
    "list_snapshots": (13, ResponseListSnapshots),
    "offer_snapshot": (14, ResponseOfferSnapshot),
    "load_snapshot_chunk": (15, ResponseLoadSnapshotChunk),
    "apply_snapshot_chunk": (16, ResponseApplySnapshotChunk),
}


class _Oneof:
    """Request/Response envelope: exactly one (kind, value) pair."""

    _FIELDS: dict = {}

    def __init__(self, kind: str, value):
        if kind not in self._FIELDS:
            raise ValueError(f"unknown {type(self).__name__} kind {kind!r}")
        self.kind = kind
        self.value = value

    def encode(self) -> bytes:
        num, _ = self._FIELDS[self.kind]
        return protoio.field_message(num, self.value.encode())

    @classmethod
    def decode(cls, data: bytes) -> "_Oneof":
        by_num = {num: (name, typ) for name, (num, typ) in cls._FIELDS.items()}
        r = protoio.WireReader(data)
        result = None
        while not r.at_end():
            f, wt = r.read_tag()
            if f in by_num:
                name, typ = by_num[f]
                result = cls(name, typ.decode(r.read_bytes()))
            else:
                r.skip(wt)
        if result is None:
            raise ValueError(f"empty {cls.__name__}")
        return result

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.kind}, {self.value!r})"


class Request(_Oneof):
    _FIELDS = _REQUEST_FIELDS


class Response(_Oneof):
    _FIELDS = _RESPONSE_FIELDS


# The reference names the misbehavior message `abci.Evidence`
# (types.proto:384); keep that name available alongside the clearer one.
Evidence = Misbehavior
