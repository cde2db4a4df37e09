"""VoteSet — collects votes of one type for one height/round and detects
+2/3 majorities.

Reference: cometbft_tpu/types/vote_set.py (types/vote_set.go — addVote
:145-240, sig verify at :205; per-block vote tracking, blockVotes;
peer-declared majorities, SetPeerMaj23, that unlock tracking votes for
alternate blocks; MakeCommit; the consensus-critical 2/3 arithmetic).

The consensus per-vote hot path (consensus/state.go:2057 → vote.Verify).
``add_vote(verify=True)`` checks the signature serially with the
validator's key, as the reference does, unless a batch preverify (one
``crypto.batch.new_batch_verifier(backend, subsystem="consensus")``
flush over the drained votes, reference consensus/state.py:393-442)
marked the vote ``sig_batch_verified`` for exactly this set's chain and
key (reference :142-153).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.block import BlockID, Commit, CommitSig
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    Vote,
    is_vote_type_valid,
)


class ErrVoteConflictingVotes(ValueError):
    """Equivocation detected. ``added`` mirrors the reference's
    (added, NewConflictingVoteError) return — the vote may still have been
    tracked (peer-maj23 block) even though it conflicts."""

    def __init__(self, existing: Vote, new: Vote, added: bool = False):
        super().__init__(
            f"conflicting votes from validator {new.validator_address.hex().upper()}"
        )
        self.vote_a = existing
        self.vote_b = new
        self.added = added


class _BlockVotes:
    """Votes for one particular block (reference: blockVotes struct)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: List[Optional[Vote]] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: int,
        val_set: ValidatorSet,
    ):
        if height == 0:
            raise ValueError("cannot make VoteSet for height == 0")
        if not is_vote_type_valid(signed_msg_type):
            raise ValueError(f"invalid vote type {signed_msg_type}")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self._mtx = threading.Lock()
        n = val_set.size()
        self._votes_bit_array = BitArray(n)
        self._votes: List[Optional[Vote]] = [None] * n
        self._sum = 0
        self._maj23: Optional[BlockID] = None
        self._votes_by_block: Dict[bytes, _BlockVotes] = {}
        self._peer_maj23s: Dict[str, BlockID] = {}

    # -- adding votes ------------------------------------------------------

    def add_vote(self, vote: Optional[Vote], verify: bool = True) -> Tuple[bool, Optional[str]]:
        """Returns (added, error_string). Raises ErrVoteConflictingVotes for
        equivocation (caller turns it into evidence)."""
        if vote is None:
            return False, "nil vote"
        with self._mtx:
            return self._add_vote(vote, verify)

    def _add_vote(self, vote: Vote, verify: bool) -> Tuple[bool, Optional[str]]:
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            return False, "index < 0"
        if not val_addr:
            return False, "empty address"
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.signed_msg_type
        ):
            return False, (
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, "
                f"got {vote.height}/{vote.round}/{vote.type}"
            )
        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            return False, (
                f"cannot find validator {val_index} in valSet of size "
                f"{self.val_set.size()}"
            )
        if lookup_addr != val_addr:
            return False, "validator address does not match index"
        # dedupe / non-deterministic signature (vote_set.go:190-200)
        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False, None  # duplicate
            return False, (
                "non-deterministic signature: same vote signed twice "
                "with different signatures"
            )
        # verify signature (types/vote_set.go:205 -> vote.Verify). The
        # consensus receive loop may have batch-verified this signature
        # already (one device call for a whole queue drain); the marker is only
        # honored when it names EXACTLY the key+chain this set would check
        # against, so a wrong resolution degrades to a serial verify.
        if verify:
            pre = getattr(vote, "sig_batch_verified", None)
            if pre != (self.chain_id, val.pub_key.bytes()):
                try:
                    vote.verify(self.chain_id, val.pub_key)
                except ValueError as e:
                    return False, f"failed to verify vote with ChainID {self.chain_id} and PubKey {val.pub_key}: {e}"
        return self._add_verified_vote(vote, block_key, val.voting_power)

    def _add_verified_vote(
        self, vote: Vote, block_key: bytes, voting_power: int
    ) -> Tuple[bool, Optional[str]]:
        """Mirrors vote_set.go addVerifiedVote exactly: conflicting votes
        always surface as ErrVoteConflictingVotes (with .added), the master
        list is replaced when the new vote is for the current maj23 block,
        and peer-maj23 blocks keep tracking conflicting votes."""
        val_index = vote.validator_index
        conflicting: Optional[Vote] = None
        if self._votes[val_index] is not None:
            conflicting = self._votes[val_index]
            # replace master-list vote if new vote is for the maj23 block
            if self._maj23 is not None and self._maj23.key() == block_key:
                self._votes[val_index] = vote
                self._votes_bit_array.set_index(val_index, True)
        else:
            self._votes[val_index] = vote
            self._votes_bit_array.set_index(val_index, True)
            self._sum += voting_power

        bv = self._votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                raise ErrVoteConflictingVotes(conflicting, vote, added=False)
        else:
            if conflicting is not None:
                # not tracking this block and no peer claims it: reject
                raise ErrVoteConflictingVotes(conflicting, vote, added=False)
            bv = _BlockVotes(False, self.val_set.size())
            self._votes_by_block[block_key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)
        if orig_sum < quorum <= bv.sum and self._maj23 is None:
            self._maj23 = vote.block_id
            # promote this block's votes into the master list (conflicting
            # entries get overwritten; sum/bitarray already account for the
            # validators, reference vote_set.go:286-291)
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self._votes[i] = v
        if conflicting is not None:
            raise ErrVoteConflictingVotes(conflicting, vote, added=True)
        return True, None

    def _get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        v = self._votes[val_index]
        if v is not None and v.block_id.key() == block_key:
            return v
        bv = self._votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims a +2/3 majority for block_id
        (reference: SetPeerMaj23 — enables tracking those votes)."""
        with self._mtx:
            if peer_id in self._peer_maj23s:
                return
            self._peer_maj23s[peer_id] = block_id
            key = block_id.key()
            bv = self._votes_by_block.get(key)
            if bv is not None:
                bv.peer_maj23 = True
            else:
                self._votes_by_block[key] = _BlockVotes(
                    True, self.val_set.size()
                )

    # -- queries -----------------------------------------------------------

    def get_vote(self, val_index: int) -> Optional[Vote]:
        with self._mtx:
            if 0 <= val_index < len(self._votes):
                return self._votes[val_index]
            return None

    # reader-shape alias used by the consensus reactor's vote gossip
    # (reference: VoteSetReader.GetByIndex, types/vote_set.go:60)
    get_by_index = get_vote

    def is_commit(self) -> bool:
        """A precommit set with a known +2/3 block (vote_set.go IsCommit)."""
        with self._mtx:
            return (
                self.signed_msg_type == SIGNED_MSG_TYPE_PRECOMMIT
                and self._maj23 is not None
            )

    def get_vote_by_address(self, address: bytes) -> Optional[Vote]:
        with self._mtx:
            idx, _ = self.val_set.get_by_address(address)
            return self._votes[idx] if idx >= 0 else None

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self._votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        with self._mtx:
            bv = self._votes_by_block.get(block_id.key())
            return bv.bit_array.copy() if bv else None

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self._maj23 is not None

    def two_thirds_majority(self) -> Tuple[Optional[BlockID], bool]:
        with self._mtx:
            if self._maj23 is not None:
                return self._maj23, True
            return None, False

    def has_two_thirds_any(self) -> bool:
        with self._mtx:
            return self._sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        with self._mtx:
            return self._sum == self.val_set.total_voting_power()

    def size(self) -> int:
        return self.val_set.size()

    def sum_voting_power(self) -> int:
        with self._mtx:
            return self._sum

    def list_votes(self) -> List[Vote]:
        with self._mtx:
            return [v for v in self._votes if v is not None]

    # -- commit construction ----------------------------------------------

    def make_commit(self) -> Commit:
        """Reference: VoteSet.MakeCommit — precommits only, needs maj23."""
        if self.signed_msg_type != SIGNED_MSG_TYPE_PRECOMMIT:
            raise ValueError("cannot MakeCommit() unless VoteSet.Type is PRECOMMIT")
        with self._mtx:
            if self._maj23 is None:
                raise ValueError("cannot MakeCommit() unless a blockhash has +2/3")
            sigs = []
            for i, v in enumerate(self._votes):
                if v is None:
                    sigs.append(CommitSig.absent())
                    continue
                cs = v.to_commit_sig()
                # a FOR-BLOCK sig for a different block is excluded
                # (vote_set.go:630 — replaced with absent); nil votes stay
                if cs.for_block() and v.block_id != self._maj23:
                    cs = CommitSig.absent()
                sigs.append(cs)
            return Commit(
                height=self.height,
                round=self.round,
                block_id=self._maj23,
                signatures=sigs,
            )

    def __str__(self) -> str:
        return (
            f"VoteSet{{H:{self.height} R:{self.round} T:{self.signed_msg_type} "
            f"+2/3:{self._maj23} sum:{self._sum}}}"
        )
