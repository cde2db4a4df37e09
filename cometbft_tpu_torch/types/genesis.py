"""GenesisDoc — the chain's initial conditions.

Ported from cometbft_tpu/types/genesis.py.

Reference: types/genesis.go (GenesisDoc, GenesisValidator,
ValidateAndComplete, SaveAs/GenesisDocFromJSON). JSON uses the amino tagged
form for pubkeys ({"type": "tendermint/PubKeyEd25519", "value": b64}),
matching crypto/ed25519/ed25519.go:37-40 registration.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.types.params import ConsensusParams, default_consensus_params

MAX_CHAIN_ID_LEN = 50

def pub_key_to_json(pk: PubKey) -> dict:
    """Amino-tagged key dict — ONE registry for the wire format
    (libs/amino_json), shared with privval and the RPC serializers."""
    from cometbft_tpu_torch.libs import amino_json

    return amino_json.to_tagged(pk)


def pub_key_from_json(obj: dict) -> PubKey:
    from cometbft_tpu_torch.libs import amino_json

    return amino_json.from_tagged(obj)


@dataclass
class GenesisValidator:
    address: bytes = b""
    pub_key: Optional[PubKey] = None
    power: int = 0
    name: str = ""

    def to_json(self) -> dict:
        return {
            "address": self.address.hex().upper(),
            "pub_key": pub_key_to_json(self.pub_key),
            "power": str(self.power),
            "name": self.name,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "GenesisValidator":
        pk = pub_key_from_json(obj["pub_key"])
        return cls(
            address=bytes.fromhex(obj.get("address", "")),
            pub_key=pk,
            power=int(obj["power"]),
            name=obj.get("name", ""),
        )


@dataclass
class GenesisDoc:
    genesis_time: Timestamp = field(default_factory=Timestamp)
    chain_id: str = ""
    initial_height: int = 1
    consensus_params: Optional[ConsensusParams] = None
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b""  # raw JSON payload for the app

    def validator_hash(self, device="cuda") -> bytes:
        """The validator set's hash, on the card unless ``device`` is
        ``"cpu"`` or None (the host tree)."""
        from cometbft_tpu_torch.types.validator import Validator
        from cometbft_tpu_torch.types.validator_set import ValidatorSet

        vals = [Validator.new(v.pub_key, v.power) for v in self.validators]
        return ValidatorSet(vals).hash(device=device)

    def validate_and_complete(self) -> Optional[str]:
        """Reference: genesis.go ValidateAndComplete — returns an error
        string (None = ok) and fills derived fields in place."""
        if not self.chain_id:
            return "genesis doc must include non-empty chain_id"
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            return f"chain_id in genesis doc is too long (max: {MAX_CHAIN_ID_LEN})"
        if self.initial_height < 0:
            return "initial_height cannot be negative"
        if self.initial_height == 0:
            self.initial_height = 1

        if self.consensus_params is None:
            self.consensus_params = default_consensus_params()
        else:
            try:
                self.consensus_params.validate_basic()
            except ValueError as e:
                return str(e)

        for i, v in enumerate(self.validators):
            if v.power == 0:
                return f"the genesis file cannot contain validators with no voting power: {v}"
            if v.pub_key is None:
                return f"validator {i} has no pub_key"
            addr = v.pub_key.address()
            if v.address and v.address != addr:
                return (
                    f"incorrect address for validator {v} in the genesis file, "
                    f"should be {addr.hex().upper()}"
                )
            v.address = addr

        if self.genesis_time.is_zero():
            self.genesis_time = Timestamp.now()
        return None

    # -- JSON ---------------------------------------------------------------

    def to_json(self) -> str:
        doc = {
            "genesis_time": self.genesis_time.to_rfc3339(),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": (
                self.consensus_params.to_json()
                if self.consensus_params is not None
                else None
            ),
            "validators": [v.to_json() for v in self.validators],
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.app_state:
            doc["app_state"] = json.loads(self.app_state)
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, raw: str) -> "GenesisDoc":
        obj = json.loads(raw)
        doc = cls(
            genesis_time=Timestamp.from_rfc3339(obj["genesis_time"]),
            chain_id=obj["chain_id"],
            initial_height=int(obj.get("initial_height", "1") or 1),
            validators=[
                GenesisValidator.from_json(v) for v in obj.get("validators") or []
            ],
            app_hash=bytes.fromhex(obj.get("app_hash", "")),
        )
        if obj.get("consensus_params") is not None:
            doc.consensus_params = ConsensusParams.from_json(
                obj["consensus_params"]
            )
        if obj.get("app_state") is not None:
            doc.app_state = json.dumps(obj["app_state"]).encode()
        err = doc.validate_and_complete()
        if err:
            raise ValueError(err)
        return doc

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())

    def sha256(self) -> bytes:
        """Hash of the JSON document — pinned in the DB at first boot
        (node/node.go:1394-1449)."""
        import hashlib

        return hashlib.sha256(self.to_json().encode()).digest()
