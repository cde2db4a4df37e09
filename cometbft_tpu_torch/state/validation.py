"""Block validation against state.

Reference: cometbft_tpu/state/validation.py (state/validation.go:15-120
validateBlock) — header wiring vs state, LastCommit verification (the
full VerifyCommit at :93, through the batch-verification boundary via
ValidatorSet.verify_commit), evidence size checks. One backend decides
both the LastCommit's verification and where the two validator-set
hashes are computed: under ``"gpu"`` (the default) the resident commit
kernel and one ``merkle_tree`` launch a set, under ``"cpu"`` the CPU
ladder and the host tree.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto import batch as cryptobatch
from cometbft_tpu_torch.state import State
from cometbft_tpu_torch.types.block import Block


def validate_block(state: State, block: Block, backend=None) -> None:
    """Raises ValueError on the first violation (error strings mirror the
    reference's so tests can assert on them)."""
    block.validate_basic()
    device = cryptobatch.backend_device(backend)

    h = block.header
    if h.version.app != state.version.consensus_app or (
        h.version.block != state.version.consensus_block
    ):
        raise ValueError(
            f"wrong Block.Header.Version. Expected "
            f"{state.version.consensus_block}, got {h.version.block}"
        )
    if h.chain_id != state.chain_id:
        raise ValueError(
            f"wrong Block.Header.ChainID. Expected {state.chain_id}, "
            f"got {h.chain_id}"
        )
    if state.last_block_height == 0 and h.height != state.initial_height:
        raise ValueError(
            f"wrong Block.Header.Height. Expected {state.initial_height} "
            f"for initial block, got {h.height}"
        )
    if state.last_block_height > 0 and h.height != state.last_block_height + 1:
        raise ValueError(
            f"wrong Block.Header.Height. Expected "
            f"{state.last_block_height + 1}, got {h.height}"
        )
    if h.last_block_id != state.last_block_id:
        raise ValueError(
            f"wrong Block.Header.LastBlockID.  Expected {state.last_block_id}, "
            f"got {h.last_block_id}"
        )
    if h.app_hash != state.app_hash:
        raise ValueError(
            f"wrong Block.Header.AppHash.  Expected "
            f"{state.app_hash.hex().upper()}, got {h.app_hash.hex()}"
        )
    if h.consensus_hash != state.consensus_params.hash():
        raise ValueError("wrong Block.Header.ConsensusHash")
    if h.last_results_hash != state.last_results_hash:
        raise ValueError("wrong Block.Header.LastResultsHash")
    if h.validators_hash != state.validators.hash(device=device):
        raise ValueError("wrong Block.Header.ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash(device=device):
        raise ValueError("wrong Block.Header.NextValidatorsHash")

    # LastCommit
    if block.header.height == state.initial_height:
        if len(block.last_commit.signatures) != 0:
            raise ValueError("initial block can't have LastCommit signatures")
    else:
        if len(block.last_commit.signatures) != len(state.last_validators.validators):
            raise ValueError(
                f"invalid block commit size. Expected "
                f"{len(state.last_validators.validators)}, got "
                f"{len(block.last_commit.signatures)}"
            )
        # the hot VerifyCommit (state/validation.go:93) — batch boundary
        state.last_validators.verify_commit(
            state.chain_id,
            state.last_block_id,
            block.header.height - 1,
            block.last_commit,
            backend=backend,
        )

    if len(h.proposer_address) != 20 or not state.validators.has_address(
        h.proposer_address
    ):
        raise ValueError(
            f"block proposer is not in the validator set "
            f"({h.proposer_address.hex()})"
        )

    # Block time (state/validation.go:114-137): strictly after LastBlockTime
    # and exactly the weighted median of LastCommit timestamps; the initial
    # block must carry the genesis time verbatim.
    from cometbft_tpu_torch.state import median_time

    if h.height > state.initial_height:
        if not h.time > state.last_block_time:
            raise ValueError(
                f"block time {h.time} not greater than last block time "
                f"{state.last_block_time}"
            )
        expected = median_time(block.last_commit, state.last_validators)
        if h.time != expected:
            raise ValueError(
                f"invalid block time. Expected {expected}, got {h.time}"
            )
    elif h.height == state.initial_height:
        if h.time != state.last_block_time:
            raise ValueError(
                f"block time {h.time} is not equal to genesis time "
                f"{state.last_block_time}"
            )
    else:
        raise ValueError(
            f"block height {h.height} lower than initial height "
            f"{state.initial_height}"
        )

    # Evidence: the limit applies to the EvidenceData proto size including
    # repeated-field framing (state/validation.go:146 Evidence.ByteSize())
    from cometbft_tpu_torch.types.evidence import encode_evidence_list

    max_bytes = state.consensus_params.evidence.max_bytes
    got = len(encode_evidence_list(block.evidence))
    if got > max_bytes:
        raise ValueError(
            f"evidence in block exceeds maximum size ({got} > {max_bytes})"
        )
