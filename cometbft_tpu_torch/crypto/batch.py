"""Batch signature verification (reference: cometbft_tpu/crypto/batch.py).

``verify()`` returns (all_ok, per-signature mask) with each verdict equal
to the serial ``PubKey.verify_signature``. Two backends:

* ``"cpu"`` — the pure-Python verifier, one signature at a time; the
  semantics ground truth.
* ``"gpu"`` — every Ed25519 batch goes to the card, whatever its size.
  The reference routes batches below 1,024 to the CPU (batch.py:68-88),
  a floor measured over the TPU's link; here a 180-lane commit goes to
  the card like any other. A flush whose keys are all in one resident
  validator set takes the indexed route (``keystore.verify_batch_indexed``,
  the keys stay on the card); any other takes ``ed25519_batch.verify_batch``
  (keys shipped, chunked), as the reference's batch.py:335-344 does. A
  key that is not Ed25519 raises NotImplementedError: the other curves
  are not ported yet, and are never verified on the CPU behind the
  caller's back.

``verify_commit_valset`` is the resident commit route that
``ValidatorSet`` takes under ``"gpu"``: the set's keys stay on the card
across heights and each commit ships R ‖ S ‖ h.

``backend`` is a name from the registry (None means ``"gpu"``: entry
points run on the card unless the caller asks for ``"cpu"``, and raise
when there is no card) or a callable that returns a BatchVerifier, such
as ``lambda: GPUBatchVerifier(device="cpu")``.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Tuple, Union

from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.crypto import ed25519 as ed


class BatchVerifier:
    """add() signatures, then verify() them together."""

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        raise NotImplementedError

    def count(self) -> int:
        raise NotImplementedError

    def verify(self) -> Tuple[bool, List[bool]]:
        """Returns (all_valid, per-entry validity mask) and resets the batch."""
        raise NotImplementedError


class _Collecting(BatchVerifier):
    def __init__(self):
        self._items: List[Tuple[PubKey, bytes, bytes]] = []

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key is None:
            raise ValueError("nil pubkey")
        self._items.append((pub_key, bytes(msg), bytes(sig)))

    def count(self) -> int:
        return len(self._items)

    def _take(self) -> List[Tuple[PubKey, bytes, bytes]]:
        items, self._items = self._items, []
        return items


class CPUBatchVerifier(_Collecting):
    """Serial CPU verification — the port's oracle."""

    def verify(self) -> Tuple[bool, List[bool]]:
        items = self._take()
        if not items:
            return False, []
        mask = [bool(pk.verify_signature(msg, sig)) for pk, msg, sig in items]
        return all(mask), mask


class GPUBatchVerifier(_Collecting):
    """Ed25519 batches through the CUDA kernel (crypto/cuda/ed25519_batch.py).

    ``device`` defaults to the card; ``device="cpu"`` runs the kernel's
    plain torch version, as the CPU tests do. Constructing it for a CUDA
    device that is not there raises RuntimeError."""

    def __init__(self, device="cuda"):
        super().__init__()
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the gpu backend needs a CUDA device; none is available")

    def verify(self) -> Tuple[bool, List[bool]]:
        from cometbft_tpu_torch.crypto.cuda import ed25519_batch, keystore

        items = self._take()
        if not items:
            return False, []
        for pk, _, _ in items:
            if pk.type() != ed.KEY_TYPE:
                raise NotImplementedError(
                    f"the gpu backend verifies ed25519 only, not {pk.type()}"
                )
        pks = [pk.bytes() for pk, _, _ in items]
        msgs = [msg for _, msg, _ in items]
        sigs = [sig for _, _, sig in items]
        mask = keystore.verify_batch_indexed(pks, msgs, sigs, self.device)
        if mask is None:
            mask = ed25519_batch.verify_batch(pks, msgs, sigs, device=self.device)
        return all(mask), mask


_registry: Dict[str, Callable[[], BatchVerifier]] = {
    "cpu": CPUBatchVerifier,
    "gpu": GPUBatchVerifier,
}
DEFAULT_BACKEND = "gpu"

Backend = Union[str, None, Callable[[], BatchVerifier]]


def new_batch_verifier(backend: Backend = None) -> BatchVerifier:
    if callable(backend):
        return backend()
    name = backend or DEFAULT_BACKEND
    factory = _registry.get(name)
    if factory is None:
        raise ValueError(f"unknown crypto backend {name!r}")
    return factory()


def _resident_device(backend: Backend):
    """The device of the resident commit route for ``backend``, or None
    when it does not take that route (anything but a GPUBatchVerifier).
    Building the verifier raises for "gpu" without a card."""
    bv = new_batch_verifier(backend)
    return bv.device if isinstance(bv, GPUBatchVerifier) else None


def resident_commit_eligible(n_present: int, backend: Backend = None) -> bool:
    """True when a commit with ``n_present`` signatures takes the
    resident route: under "gpu" (or a callable giving a GPUBatchVerifier)
    and never under "cpu". There is no routing floor: a one-signature
    commit goes to the card like any other."""
    return n_present > 0 and _resident_device(backend) is not None


def verify_commit_valset(
    pub_keys: List[bytes],
    msgs: List[Optional[bytes]],
    sigs: List[Optional[bytes]],
    backend: Backend = None,
) -> Optional[List[bool]]:
    """Per-lane verdicts of a commit against its whole validator set,
    whose keys stay resident on the card (``ed25519_batch.
    verify_valset_resident``), or None when ``backend`` does not take the
    resident route. Every key must be Ed25519; msgs[i]/sigs[i] None is an
    absent lane, False in the result."""
    device = _resident_device(backend)
    if device is None:
        return None
    from cometbft_tpu_torch.crypto.cuda import ed25519_batch

    valset_id = hashlib.sha256(b"".join(pub_keys)).digest()
    return ed25519_batch.verify_valset_resident(valset_id, pub_keys, msgs, sigs, device=device)
