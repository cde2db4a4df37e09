"""state — the replicated state machine's value-type snapshot.

Reference: cometbft_tpu/state/__init__.py; state/state.go (State :34-88, MakeBlock :234, MedianTime :268,
MakeGenesisState :310) and proto/tendermint/state/types.proto (State
message :45-80).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.proto.gogo import Timestamp, ZERO_TIME
from cometbft_tpu_torch.types.block import Block, BlockID, Commit, make_block
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.version import BLOCK_PROTOCOL, CMT_SEM_VER


@dataclass
class StateVersion:
    """proto state.Version {version.Consensus consensus=1, string software=2}."""

    consensus_block: int = BLOCK_PROTOCOL
    consensus_app: int = 0
    software: str = CMT_SEM_VER

    def encode(self) -> bytes:
        from cometbft_tpu_torch.proto.version import ConsensusVersion

        cv = ConsensusVersion(self.consensus_block, self.consensus_app)
        out = protoio.field_message(1, cv.encode())
        if self.software:
            out += protoio.field_string(2, self.software)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "StateVersion":
        from cometbft_tpu_torch.proto.version import ConsensusVersion

        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                cv = ConsensusVersion.decode(r.read_bytes())
                out.consensus_block, out.consensus_app = cv.block, cv.app
            elif f == 2:
                out.software = r.read_string()
            else:
                r.skip(wt)
        return out


@dataclass
class State:
    version: StateVersion = field(default_factory=StateVersion)
    chain_id: str = ""
    initial_height: int = 1

    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time: Timestamp = ZERO_TIME

    next_validators: Optional[ValidatorSet] = None
    validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def copy(self) -> "State":
        return State.decode(self.encode())

    def is_empty(self) -> bool:
        return self.validators is None

    def equals(self, other: "State") -> bool:
        return self.encode() == other.encode()

    # -- block creation (state/state.go:234-262) ----------------------------

    def make_block(
        self,
        height: int,
        txs: List[bytes],
        commit: Commit,
        evidence: list,
        proposer_address: bytes,
        device="cuda",
    ) -> Tuple[Block, "object"]:
        """The validator-set hashes are computed on ``device`` (the card
        unless the caller passes ``"cpu"`` or None, the host tree)."""
        from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES, PartSet

        block = make_block(height, txs, commit, evidence)
        if height == self.initial_height:
            timestamp = self.last_block_time  # genesis time
        else:
            timestamp = median_time(commit, self.last_validators)

        from cometbft_tpu_torch.proto.version import ConsensusVersion

        h = block.header
        h.version = ConsensusVersion(
            self.version.consensus_block, self.version.consensus_app
        )
        h.chain_id = self.chain_id
        h.time = timestamp
        h.last_block_id = self.last_block_id
        h.validators_hash = self.validators.hash(device=device)
        h.next_validators_hash = self.next_validators.hash(device=device)
        h.consensus_hash = self.consensus_params.hash()
        h.app_hash = self.app_hash
        h.last_results_hash = self.last_results_hash
        h.proposer_address = proposer_address
        block._hash = None
        return block, PartSet.from_data(block.encode(), BLOCK_PART_SIZE_BYTES)

    # -- proto --------------------------------------------------------------

    def encode(self) -> bytes:
        out = protoio.field_message(1, self.version.encode())
        if self.chain_id:
            out += protoio.field_string(2, self.chain_id)
        if self.last_block_height:
            out += protoio.field_varint(3, self.last_block_height)
        out += protoio.field_message(4, self.last_block_id.encode())
        out += protoio.field_message(5, self.last_block_time.encode())
        if self.next_validators is not None:
            out += protoio.field_message(6, self.next_validators.encode())
        if self.validators is not None:
            out += protoio.field_message(7, self.validators.encode())
        if self.last_validators is not None and self.last_validators.validators:
            out += protoio.field_message(8, self.last_validators.encode())
        if self.last_height_validators_changed:
            out += protoio.field_varint(9, self.last_height_validators_changed)
        out += protoio.field_message(10, self.consensus_params.encode())
        if self.last_height_consensus_params_changed:
            out += protoio.field_varint(11, self.last_height_consensus_params_changed)
        out += protoio.field_bytes(12, self.last_results_hash)
        out += protoio.field_bytes(13, self.app_hash)
        if self.initial_height:
            out += protoio.field_varint(14, self.initial_height)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "State":
        r = protoio.WireReader(data)
        out = cls()
        out.initial_height = 0
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.version = StateVersion.decode(r.read_bytes())
            elif f == 2:
                out.chain_id = r.read_string()
            elif f == 3:
                out.last_block_height = r.read_varint()
            elif f == 4:
                out.last_block_id = BlockID.decode(r.read_bytes())
            elif f == 5:
                out.last_block_time = Timestamp.decode(r.read_bytes())
            elif f == 6:
                out.next_validators = ValidatorSet.decode(r.read_bytes())
            elif f == 7:
                out.validators = ValidatorSet.decode(r.read_bytes())
            elif f == 8:
                out.last_validators = ValidatorSet.decode(r.read_bytes())
            elif f == 9:
                out.last_height_validators_changed = r.read_varint()
            elif f == 10:
                out.consensus_params = ConsensusParams.decode(r.read_bytes())
            elif f == 11:
                out.last_height_consensus_params_changed = r.read_varint()
            elif f == 12:
                out.last_results_hash = r.read_bytes()
            elif f == 13:
                out.app_hash = r.read_bytes()
            elif f == 14:
                out.initial_height = r.read_varint()
            else:
                r.skip(wt)
        if out.last_validators is None:
            out.last_validators = ValidatorSet([])
        return out


def median_time(commit: Commit, validators: ValidatorSet) -> Timestamp:
    """Weighted median of commit vote timestamps (state/state.go:268,
    types/time/time.go:35 WeightedMedian)."""
    weighted = []
    total_power = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = validators.get_by_address(cs.validator_address)
        if val is not None:
            total_power += val.voting_power
            weighted.append((cs.timestamp, val.voting_power))
    weighted.sort(key=lambda wt: wt[0].to_unix_ns())
    median = total_power // 2
    for ts, weight in weighted:
        if median <= weight:
            return ts
        median -= weight
    return ZERO_TIME


def make_genesis_state(genesis_doc) -> State:
    """Reference: state/state.go MakeGenesisState — validators start with
    zero proposer priority; NextValidators = CopyIncrementProposerPriority(1).
    """
    from cometbft_tpu_torch.types.validator import Validator

    err = genesis_doc.validate_and_complete()
    if err:
        raise ValueError(err)

    if genesis_doc.validators:
        vals = [
            Validator.new(gv.pub_key, gv.power) for gv in genesis_doc.validators
        ]
        validator_set = ValidatorSet(vals)
        next_validator_set = validator_set.copy()
        next_validator_set.increment_proposer_priority(1)
    else:
        validator_set = ValidatorSet([])
        next_validator_set = ValidatorSet([])

    return State(
        version=StateVersion(),
        chain_id=genesis_doc.chain_id,
        initial_height=genesis_doc.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=genesis_doc.genesis_time,
        next_validators=next_validator_set,
        validators=validator_set,
        last_validators=ValidatorSet([]),
        last_height_validators_changed=genesis_doc.initial_height,
        consensus_params=genesis_doc.consensus_params,
        last_height_consensus_params_changed=genesis_doc.initial_height,
        app_hash=bytes(genesis_doc.app_hash),
    )
