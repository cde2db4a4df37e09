"""tendermint.crypto.PublicKey — oneof {ed25519=1, secp256k1=2}.

Reference: cometbft_tpu/proto/keys.py (proto/tendermint/crypto/keys.proto;
crypto/encoding/codec.go). Both validator key types of the v0.34 wire
encode, decode and convert; sr25519 has no field there.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.libs import protoio


@dataclass(frozen=True)
class PublicKeyProto:
    type: str  # "ed25519" | "secp256k1"
    data: bytes

    def encode(self) -> bytes:
        if self.type == ed.KEY_TYPE:
            return protoio.field_bytes(1, self.data)
        if self.type == secp.KEY_TYPE:
            return protoio.field_bytes(2, self.data)
        raise ValueError(f"unsupported key type {self.type!r}")

    @classmethod
    def decode(cls, data: bytes) -> "PublicKeyProto":
        r = protoio.WireReader(data)
        typ, raw = None, b""
        while not r.at_end():
            field, wt = r.read_tag()
            if field == 1:
                typ, raw = ed.KEY_TYPE, r.read_bytes()
            elif field == 2:
                typ, raw = secp.KEY_TYPE, r.read_bytes()
            else:
                r.skip(wt)
        if typ is None:
            raise ValueError("empty PublicKey proto")
        return cls(typ, raw)


def pub_key_to_proto(pk: PubKey) -> PublicKeyProto:
    """Reference: crypto/encoding/codec.go PubKeyToProto."""
    return PublicKeyProto(pk.type(), pk.bytes())


def pub_key_from_proto(p: PublicKeyProto) -> PubKey:
    if p.type == ed.KEY_TYPE:
        return ed.PubKeyEd25519(p.data)
    if p.type == secp.KEY_TYPE:
        return secp.PubKeySecp256k1(p.data)
    raise ValueError(f"unsupported key type {p.type!r}")
