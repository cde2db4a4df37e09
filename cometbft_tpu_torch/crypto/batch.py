"""Batch signature verification (reference: cometbft_tpu/crypto/batch.py).

``verify()`` returns (all_ok, per-signature mask) with each verdict equal
to the serial ``PubKey.verify_signature``. Two backends:

* ``"cpu"`` — the CPU ladder (the native OpenSSL rung, else pure
  Python); the semantics ground truth.
* ``"gpu"`` — the batch is split by curve, as the reference's
  batch.py:287-348 does, and every part goes to the card, whatever its
  size. The reference routes Ed25519 batches below 1,024 and secp256k1
  batches below 256 (``CBFT_TPU_SECP_MIN_BATCH``, :273) to the CPU,
  floors measured over the TPU's link; here a 180-lane commit goes to
  the card like any other. Ed25519 lanes whose keys are all in one
  resident validator set take the indexed route
  (``keystore.verify_batch_indexed``, the keys stay on the card); other
  Ed25519 lanes take ``ed25519_batch.verify_batch`` (keys shipped,
  chunked), as the reference's :335-344 does. secp256k1 lanes take
  ``secp256k1_batch.verify_batch`` and sr25519 lanes
  ``sr25519_batch.verify_batch``. A key of any other type raises
  NotImplementedError before anything is launched: no lane is ever
  verified on the CPU behind the caller's back. Verdicts come back in
  input order as Python bools.

``verify_commit_valset`` is the resident commit route that
``ValidatorSet`` takes under ``"gpu"``: the set's keys stay on the card
across heights and each commit ships R ‖ S ‖ h.

``backend`` is a name from the registry (None means the default,
``"gpu"``: entry points run on the card unless the caller asks for
``"cpu"``, and raise when there is no card), a ``BackendSpec``, a
callable that returns a BatchVerifier, such as ``lambda:
GPUBatchVerifier(device="cpu")``, a verify scheduler (``.submit`` and
``.spec``, crypto/scheduler.py) or a backend supervisor
(``.verify_items`` and ``.spec``, crypto/supervisor.py), whose spec
decides every route (reference :26-66, :413-494). A factory has no name,
so a scheduler or supervisor that should reach the gpu routes on the
plain twins takes the name it is registered under
(``register_backend("gpu-plain", lambda: GPUBatchVerifier(device="cpu"))``,
then ``spec="gpu-plain"``), as the reference's tests register theirs; a
name that is not registered raises, it never turns into ``"cpu"``.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto import sr25519 as sr


@dataclass(frozen=True)
class BackendSpec:
    """A backend name with its node's [crypto] tuning, threaded through
    the parameter a bare name travels (reference batch.py:26).
    ``max_chunk`` caps the lanes of one launch of a GPUBatchVerifier made
    from it (``crypto/cuda/mesh.py``'s chunk cap, for that verifier
    only). ``min_batch`` is the reference's CPU/device routing floor; the
    port has none and does not read it, so a node's config carries across
    unchanged."""

    name: str
    min_batch: Optional[int] = None
    max_chunk: Optional[int] = None


# what a verify path takes where a backend goes: a name, a BackendSpec, a
# factory callable, or a scheduler (.submit + .spec) or supervisor
# (.verify_items + .spec) resolved through its spec
Backend = Union[str, BackendSpec, None, Callable[[], "BatchVerifier"], object]


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
    """CPU verification, the port's oracle (reference batch.py:105).
    Ed25519 entries go through ``ed25519.verify_many``: one native call
    over up to 16 threads when the native rung is live, pure Python
    otherwise. Other key types verify one by one."""

    def verify(self) -> Tuple[bool, List[bool]]:
        items = self._take()
        if not items:
            return False, []
        mask: List[Optional[bool]] = [None] * len(items)
        ed_idxs = [i for i, (pk, _, _) in enumerate(items) if isinstance(pk, ed.PubKeyEd25519)]
        if ed_idxs:
            for i, ok in zip(ed_idxs, ed.verify_many([items[i] for i in ed_idxs])):
                mask[i] = ok
        final = [
            bool(m) if m is not None else bool(pk.verify_signature(msg, sig))
            for m, (pk, msg, sig) in zip(mask, items)
        ]
        return all(final), final


class GPUBatchVerifier(_Collecting):
    """Ed25519, secp256k1 and sr25519 batches through the CUDA kernels
    (crypto/cuda/ed25519_batch.py, secp256k1_batch.py, sr25519_batch.py).

    ``device`` defaults to the card; ``device="cpu"`` runs the kernel's
    plain torch version, as the CPU tests do. Constructing it for a CUDA
    device that is not there raises RuntimeError."""

    def __init__(self, device="cuda", max_chunk: Optional[int] = None):
        super().__init__()
        import torch

        self.device = torch.device(device)
        self.max_chunk = max_chunk
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the gpu backend needs a CUDA device; none is available")

    def verify(self) -> Tuple[bool, List[bool]]:
        from cometbft_tpu_torch.crypto.cuda import mesh

        with mesh.chunk_cap_scope(self.max_chunk):
            return self._verify()

    def _verify(self) -> Tuple[bool, List[bool]]:
        from cometbft_tpu_torch.crypto.cuda import ed25519_batch, keystore, secp256k1_batch, sr25519_batch

        items = self._take()
        if not items:
            return False, []
        by_curve: Dict[str, List[int]] = {ed.KEY_TYPE: [], secp.KEY_TYPE: [], sr.KEY_TYPE: []}
        for i, (pk, _, _) in enumerate(items):
            lanes = by_curve.get(pk.type())
            if lanes is None:
                raise NotImplementedError(
                    f"the gpu backend verifies ed25519, secp256k1 and sr25519, not {pk.type()}"
                )
            lanes.append(i)
        mask = [False] * len(items)
        for curve, lanes in by_curve.items():
            if not lanes:
                continue
            pks = [items[i][0].bytes() for i in lanes]
            msgs = [items[i][1] for i in lanes]
            sigs = [items[i][2] for i in lanes]
            if curve == ed.KEY_TYPE:
                ok = keystore.verify_batch_indexed(pks, msgs, sigs, self.device)
                if ok is None:
                    ok = ed25519_batch.verify_batch(pks, msgs, sigs, device=self.device)
            elif curve == secp.KEY_TYPE:
                ok = secp256k1_batch.verify_batch(pks, msgs, sigs, device=self.device)
            else:
                ok = sr25519_batch.verify_batch(pks, msgs, sigs, device=self.device)
            for i, v in zip(lanes, ok):
                mask[i] = bool(v)
        return all(mask), mask


_registry: Dict[str, Callable[[], BatchVerifier]] = {
    "cpu": CPUBatchVerifier,
    "gpu": GPUBatchVerifier,
}
_default_backend = "gpu"
_mtx = threading.Lock()


def register_backend(name: str, factory: Callable[[], BatchVerifier]) -> None:
    with _mtx:
        _registry[name] = factory


def set_default_backend(name: str) -> None:
    global _default_backend
    with _mtx:
        if name not in _registry:
            raise ValueError(f"unknown crypto backend {name!r}")
        _default_backend = name


def default_backend() -> str:
    return _default_backend


def _is_scheduler(backend) -> bool:
    return hasattr(backend, "submit") and hasattr(backend, "spec")


def _is_supervisor(backend) -> bool:
    return hasattr(backend, "verify_items") and hasattr(backend, "spec")


def unwrap_backend(backend: Backend):
    """A scheduler or supervisor travels the same parameter a backend
    name does; every routing decision resolves against its spec."""
    if _is_scheduler(backend) or _is_supervisor(backend):
        return backend.spec
    return backend


def backend_name(backend: Backend) -> Optional[str]:
    """The registry name ``backend`` resolves to; None for a factory
    callable, which has none."""
    backend = unwrap_backend(backend)
    if isinstance(backend, BackendSpec):
        return backend.name
    if callable(backend):
        return None
    return backend or _default_backend


class ScheduledBatchVerifier(_Collecting):
    """add()/verify() on top of a verify scheduler (an object with
    ``.submit`` and ``.spec``, reference crypto/scheduler.py): verify()
    submits the collected items as one request, tagged with the caller's
    subsystem, and blocks on its future, so the scheduler can coalesce
    them with what other callers have pending."""

    def __init__(self, scheduler, subsystem: Optional[str] = None):
        super().__init__()
        self._scheduler = scheduler
        self._subsystem = subsystem

    def verify(self) -> Tuple[bool, List[bool]]:
        items = self._take()
        if not items:
            return False, []
        return self._scheduler.submit(items, subsystem=self._subsystem).result()


def new_batch_verifier(backend: Backend = None, subsystem: Optional[str] = None) -> BatchVerifier:
    """A verifier for ``backend``: a scheduler gets a
    ScheduledBatchVerifier that submits under ``subsystem``, a supervisor a
    SupervisedBatchVerifier (crypto/supervisor.py); a callable is
    called; a name or a BackendSpec is looked up in the registry, and a
    GPUBatchVerifier built from a spec carries its ``max_chunk``.
    ``subsystem`` only tags a scheduler's requests (QoS class and
    metering there), as in the reference."""
    if _is_scheduler(backend):
        return ScheduledBatchVerifier(backend, subsystem=subsystem)
    if _is_supervisor(backend):
        # a bare BackendSupervisor (no scheduler in front): dispatches
        # still get the watchdog / breaker / audit treatment
        from cometbft_tpu_torch.crypto.supervisor import SupervisedBatchVerifier

        return SupervisedBatchVerifier(backend)
    if callable(backend):
        return backend()
    with _mtx:
        name = backend_name(backend)
        factory = _registry.get(name)
    if factory is None:
        raise ValueError(f"unknown crypto backend {name!r}")
    bv = factory()
    if isinstance(backend, BackendSpec) and isinstance(bv, GPUBatchVerifier):
        bv.max_chunk = backend.max_chunk
    return bv


def supports_batch_verification(pub_key: PubKey) -> bool:
    return pub_key.type() in (ed.KEY_TYPE, secp.KEY_TYPE, sr.KEY_TYPE)


def backend_device(backend: Backend = None):
    """The device ``backend`` verifies on: a GPUBatchVerifier's device
    (the card under "gpu", raising without one; the plain twins' device
    for ``lambda: GPUBatchVerifier(device="cpu")``), or None for a backend
    that verifies on the host ("cpu"). A scheduler or supervisor is
    resolved to its spec first. The resident commit route runs there, and
    so does the hash of a validator set that a caller verifies against
    (``ValidatorSet.hash(device=None)`` is the host tree)."""
    bv = new_batch_verifier(unwrap_backend(backend))
    return bv.device if isinstance(bv, GPUBatchVerifier) else None


def prepare_backend(backend: Backend = None) -> None:
    """Make one verifier of ``backend`` now and, when it verifies on a
    card (a GPUBatchVerifier on CUDA, or a wrapper whose ``inner`` is
    one), build every kernel library (``crypto/cuda/build.build_all``).
    A scheduler or supervisor calls this where it is made, so that "gpu"
    without a card, or with a kernel that does not build, raises there:
    before anything is queued, and before any verdict could be served
    from the CPU in the card's place."""
    bv = new_batch_verifier(unwrap_backend(backend))
    while not isinstance(bv, GPUBatchVerifier) and getattr(bv, "inner", None) is not None:
        bv = bv.inner
    if isinstance(bv, GPUBatchVerifier) and bv.device.type == "cuda":
        from cometbft_tpu_torch.crypto.cuda import build

        build.build_all()


def resident_commit_eligible(n_present: int, backend: Backend = None) -> bool:
    """True when a commit with ``n_present`` signatures takes the
    resident route: under "gpu" (or a BackendSpec, scheduler or callable
    that resolves to a GPUBatchVerifier) and never under "cpu". There is
    no routing floor: a one-signature commit goes to the card like any
    other."""
    return n_present > 0 and backend_device(backend) is not None


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
    device = backend_device(backend)
    if device is None:
        return None
    from cometbft_tpu_torch.crypto.cuda import ed25519_batch

    valset_id = hashlib.sha256(b"".join(pub_keys)).digest()
    return ed25519_batch.verify_valset_resident(valset_id, pub_keys, msgs, sigs, device=device)
