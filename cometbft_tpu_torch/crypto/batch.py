"""Batch signature verification (reference: cometbft_tpu/crypto/batch.py).

``verify()`` returns (all_ok, per-signature mask) with each verdict equal
to the serial ``PubKey.verify_signature``. Two backends:

* ``"cpu"`` — the pure-Python verifier, one signature at a time; the
  semantics ground truth.
* ``"gpu"`` — packs the batch on the host and launches the Ed25519 CUDA
  kernel for every batch, whatever its size. The reference routes
  batches below 1,024 to the CPU (batch.py:68-88), a floor measured over
  the TPU's link; here a 180-lane commit goes to the card like any other.
  A key that is not Ed25519 raises NotImplementedError: the other curves
  are not ported yet, and are never verified on the CPU behind the
  caller's back.

``backend`` is a name from the registry (None means ``"gpu"``: entry
points run on the card unless the caller asks for ``"cpu"``, and raise
when there is no card) or a callable that returns a BatchVerifier, such
as ``lambda: GPUBatchVerifier(device="cpu")``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

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

        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the gpu backend needs a CUDA device; none is available")

    def verify(self) -> Tuple[bool, List[bool]]:
        from cometbft_tpu_torch.crypto.cuda import ed25519_batch

        items = self._take()
        if not items:
            return False, []
        for pk, _, _ in items:
            if pk.type() != ed.KEY_TYPE:
                raise NotImplementedError(
                    f"the gpu backend verifies ed25519 only, not {pk.type()}"
                )
        mask = ed25519_batch.verify_batch(
            [pk.bytes() for pk, _, _ in items],
            [msg for _, msg, _ in items],
            [sig for _, _, sig in items],
            device=self._device,
        )
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
