"""Amino-compatible JSON with registered type tags.

Ported from cometbft_tpu/libs/amino_json.py.

Reference: libs/json — values of registered interface implementations are
wrapped as {"type": "<amino name>", "value": <json>} so readers can
reconstruct the concrete type (e.g. crypto/ed25519/ed25519.go:37-40
registers "tendermint/PubKeyEd25519"). This is the wire format of genesis
docs, priv_validator files, and RPC key material.

Registration maps a Python class to (amino name, to_value, from_value):

    register_type(PubKeyEd25519, "tendermint/PubKeyEd25519",
                  to_value=lambda k: b64(k.bytes()),
                  from_value=lambda v: PubKeyEd25519(un_b64(v)))

marshal/unmarshal then handle tagged wrapping for registered classes,
recursing through dicts and lists; unregistered values pass through as
plain JSON.
"""

from __future__ import annotations

import base64
import json as _json
from typing import Any, Callable, Dict, Tuple, Type

_by_class: Dict[Type, Tuple[str, Callable, Callable]] = {}
_by_name: Dict[str, Tuple[Type, Callable, Callable]] = {}


def register_type(
    cls: Type,
    amino_name: str,
    to_value: Callable[[Any], Any],
    from_value: Callable[[Any], Any],
) -> None:
    if amino_name in _by_name and _by_name[amino_name][0] is not cls:
        raise ValueError(f"amino name {amino_name!r} already registered")
    _by_class[cls] = (amino_name, to_value, from_value)
    _by_name[amino_name] = (cls, to_value, from_value)


def _encode(obj: Any) -> Any:
    reg = _by_class.get(type(obj))
    if reg is not None:
        name, to_value, _ = reg
        return {"type": name, "value": _encode(to_value(obj))}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, bytes):
        return base64.b64encode(obj).decode()
    return obj


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"type", "value"} and obj["type"] in _by_name:
            _, _, from_value = _by_name[obj["type"]]
            return from_value(_decode(obj["value"]))
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def marshal(obj: Any, indent: int = 0) -> str:
    return _json.dumps(_encode(obj), indent=indent or None, sort_keys=True)


def unmarshal(data: str) -> Any:
    return _decode(_json.loads(data))


def to_tagged(obj: Any) -> dict:
    """One registered value → its {"type", "value"} dict (the building
    block genesis/privval/RPC serializers embed in larger documents)."""
    reg = _by_class.get(type(obj))
    if reg is None:
        raise ValueError(f"type {type(obj).__name__} is not amino-registered")
    name, to_value, _ = reg
    return {"type": name, "value": to_value(obj)}


def from_tagged(obj: dict) -> Any:
    entry = _by_name.get(obj.get("type", ""))
    if entry is None:
        raise ValueError(f"unknown amino type {obj.get('type')!r}")
    _, _, from_value = entry
    return from_value(obj["value"])


# -- standard registrations (crypto key material) ----------------------------


def _register_defaults() -> None:
    from cometbft_tpu_torch.crypto import ed25519, secp256k1

    register_type(
        ed25519.PubKeyEd25519,
        "tendermint/PubKeyEd25519",
        to_value=lambda k: base64.b64encode(k.bytes()).decode(),
        from_value=lambda v: ed25519.PubKeyEd25519(base64.b64decode(v)),
    )
    register_type(
        ed25519.PrivKeyEd25519,
        "tendermint/PrivKeyEd25519",
        to_value=lambda k: base64.b64encode(k.bytes()).decode(),
        from_value=lambda v: ed25519.PrivKeyEd25519(base64.b64decode(v)),
    )
    register_type(
        secp256k1.PubKeySecp256k1,
        "tendermint/PubKeySecp256k1",
        to_value=lambda k: base64.b64encode(k.bytes()).decode(),
        from_value=lambda v: secp256k1.PubKeySecp256k1(base64.b64decode(v)),
    )
    from cometbft_tpu_torch.crypto import sr25519

    register_type(
        sr25519.PubKeySr25519,
        sr25519.PUB_KEY_NAME,
        to_value=lambda k: base64.b64encode(k.bytes()).decode(),
        from_value=lambda v: sr25519.PubKeySr25519(base64.b64decode(v)),
    )


_register_defaults()
