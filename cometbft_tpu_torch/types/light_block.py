"""SignedHeader + LightBlock.

Reference: cometbft_tpu/types/light_block.py (types/light.go;
proto/tendermint/types/types.proto:135-142). ``LightBlock.validate_basic``
hashes the validator set on the device that ``backend`` verifies on
(``crypto.batch.backend_device``): the card under "gpu", the default, and
the host tree under "cpu".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from cometbft_tpu_torch.crypto import batch as cryptobatch
from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.types.block import Commit, Header
from cometbft_tpu_torch.types.validator_set import ValidatorSet


@dataclass
class SignedHeader:
    """proto: {Header header=1, Commit commit=2} (both nullable)."""

    header: Optional[Header] = None
    commit: Optional[Commit] = None

    def encode(self) -> bytes:
        out = b""
        if self.header is not None:
            out += protoio.field_message(1, self.header.encode())
        if self.commit is not None:
            out += protoio.field_message(2, self.commit.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "SignedHeader":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.header = Header.decode(r.read_bytes())
            elif f == 2:
                out.commit = Commit.decode(r.read_bytes())
            else:
                r.skip(wt)
        return out

    def validate_basic(self, chain_id: str) -> None:
        """Reference: types/light.go SignedHeader.ValidateBasic."""
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError(
                f"SignedHeader header and commit height mismatch: "
                f"{self.header.height} vs {self.commit.height}"
            )
        if self.commit.block_id.hash != self.header.hash():
            raise ValueError("commit signs block failed")

    @property
    def height(self) -> int:
        return self.header.height if self.header else 0


@dataclass
class LightBlock:
    """proto: {SignedHeader signed_header=1, ValidatorSet validator_set=2}."""

    signed_header: Optional[SignedHeader] = None
    validator_set: Optional[ValidatorSet] = None

    def encode(self) -> bytes:
        out = b""
        if self.signed_header is not None:
            out += protoio.field_message(1, self.signed_header.encode())
        if self.validator_set is not None:
            out += protoio.field_message(2, self.validator_set.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "LightBlock":
        r = protoio.WireReader(data)
        out = cls()
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                out.signed_header = SignedHeader.decode(r.read_bytes())
            elif f == 2:
                out.validator_set = ValidatorSet.decode(r.read_bytes())
            else:
                r.skip(wt)
        return out

    def validate_basic(self, chain_id: str, backend: cryptobatch.Backend = None) -> None:
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        vals_hash = self.validator_set.hash(device=cryptobatch.backend_device(backend))
        if self.signed_header.header.validators_hash != vals_hash:
            raise ValueError(
                "expected validator hash of header to match validator set hash"
            )

    @property
    def height(self) -> int:
        return self.signed_header.height if self.signed_header else 0


def decode_lca_inner(data: bytes):
    """Decode LightClientAttackEvidence inner message (called from
    types.evidence to avoid an import cycle)."""
    from cometbft_tpu_torch.proto.gogo import Timestamp
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
    from cometbft_tpu_torch.types.validator import Validator

    r = protoio.WireReader(data)
    out = LightClientAttackEvidence()
    while not r.at_end():
        f, wt = r.read_tag()
        if f == 1:
            out.conflicting_block = LightBlock.decode(r.read_bytes())
        elif f == 2:
            out.common_height = r.read_varint()
        elif f == 3:
            out.byzantine_validators.append(Validator.decode(r.read_bytes()))
        elif f == 4:
            out.total_voting_power = r.read_varint()
        elif f == 5:
            out.timestamp = Timestamp.decode(r.read_bytes())
        else:
            r.skip(wt)
    return out
