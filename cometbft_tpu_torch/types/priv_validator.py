"""PrivValidator — the signing interface consensus uses.

Ported from cometbft_tpu/types/priv_validator.py.

Reference: types/priv_validator.go — PrivValidator iface (GetPubKey,
SignVote, SignProposal) and MockPV for tests. The production file-backed
signer (FilePV, with the LastSignState double-sign guard) lives in
cometbft_tpu_torch.privval.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto import PrivKey, PubKey
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote


class PrivValidator:
    def get_pub_key(self) -> PubKey:
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """Sets vote.signature (and possibly vote.timestamp)."""
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        raise NotImplementedError


class MockPV(PrivValidator):
    """In-memory signer for tests (reference: types/priv_validator.go MockPV).

    break_proposal_sigs / break_vote_sigs mimic the reference's
    erroringMockPV-style misbehavior toggles.
    """

    def __init__(
        self,
        priv_key: PrivKey | None = None,
        break_proposal_sigs: bool = False,
        break_vote_sigs: bool = False,
    ):
        self.priv_key = priv_key or ed25519.gen_priv_key()
        self.break_proposal_sigs = break_proposal_sigs
        self.break_vote_sigs = break_vote_sigs

    def get_pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_vote_sigs else chain_id
        vote.signature = self.priv_key.sign(vote.sign_bytes(use_chain_id))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        use_chain_id = (
            "incorrect-chain-id" if self.break_proposal_sigs else chain_id
        )
        proposal.signature = self.priv_key.sign(proposal.sign_bytes(use_chain_id))

    def __str__(self) -> str:
        return f"MockPV{{{self.get_pub_key().address().hex().upper()[:12]}}}"
