"""Chunked dispatch of a verify kernel on one device.

Reference: cometbft_tpu/crypto/tpu/mesh.py — the cancel scope (:53-76),
the dispatch route (:78-139), the chunk cap with its OOM shrink ladder
(:225-330) and ``dispatch_batch`` (:396), for one device.
The reference pads every chunk to a power of two, which exists for XLA's
shape cache; a CUDA kernel takes any batch, so the port does not pad.

``dispatch_batch`` runs a batch as chunks of at most ``chunk_cap`` lanes.
The caller's ``packed(start, end)`` builds one chunk's host arrays (the
SHA-512 hashing and byte packing); each is copied to the device and the
chunk's kernel is launched on the current stream. A launch does not wait
for the kernel, so the host packs chunk i+1 while the card verifies
chunk i; the masks are read back together after the last launch. A set
cancel event raises ``DispatchCancelled`` at the next chunk edge.

The reference's side copy stream, pinned staging and pipeline and
prefetch depths are left out: at a blocksync window the host's packing
takes about 50 times the kernel's time, and the plain loop measured the
same as the pipelined one on the card (PERF.md).

``chunk_cap`` is the resolved cap halved once per OOM shrink level of
the fault domain the thread dispatches to (``topology.device_scope``'s
handle, else the default topology's device 0): the supervisor halves it
on an out-of-memory error and it recovers one doubling per
``chunk_recover_n`` clean dispatches. ``route_scope`` carries the
scheduler's routing decision to the dispatching thread;
``sharded_available`` is False until multi-GPU lands (ROADMAP A.7), so a
``"sharded"`` route takes the single-device loop. Still to port: the
memory plane's pre-dispatch guard (its cap stays None), calibration and
the wire ledger (ROADMAP A.4), the sharded mesh (ROADMAP A.7) and
telemetry spans.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

# --- cancellable dispatch (reference :53-76) --------------------------------

_cancel_local = threading.local()


class DispatchCancelled(RuntimeError):
    """The dispatch's cancel event fired."""


def current_cancel_event() -> Optional[threading.Event]:
    """The cancel event installed on this thread, if any."""
    return getattr(_cancel_local, "event", None)


class cancel_scope:
    """Install ``event`` as this thread's dispatch cancel event;
    ``dispatch_batch`` checks it at every chunk edge. Nests."""

    def __init__(self, event: threading.Event):
        self._event = event
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_cancel_local, "event", None)
        _cancel_local.event = self._event
        return self._event

    def __exit__(self, *exc_info):
        _cancel_local.event = self._prev
        return False


# --- dispatch route (reference :78-139) --------------------------------------

ROUTE_SINGLE = "single"    # one card
ROUTE_SHARDED = "sharded"  # the multi-card megabatch (ROADMAP A.7)

_route_local = threading.local()


def current_route() -> Optional[str]:
    """The dispatch route installed on this thread, if any."""
    return getattr(_route_local, "route", None)


class route_scope:
    """Install ``route`` (ROUTE_SINGLE, ROUTE_SHARDED or None) as this
    thread's dispatch route; nests."""

    def __init__(self, route: Optional[str]):
        self._route = route
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_route_local, "route", None)
        _route_local.route = self._route
        return self._route

    def __exit__(self, *exc_info):
        _route_local.route = self._prev
        return False


def parse_route(raw: Optional[str]) -> Optional[str]:
    """One CBFT_MESH_ROUTE value: ROUTE_SINGLE or ROUTE_SHARDED for a
    pin, None for auto or unset, ValueError on anything else."""
    if raw is None:
        return None
    raw = raw.strip().lower()
    if raw in ("", "auto"):
        return None
    if raw in (ROUTE_SINGLE, ROUTE_SHARDED):
        return raw
    raise ValueError(f"CBFT_MESH_ROUTE={raw!r} must be auto, single, or sharded")


def sharded_available(topology=None) -> bool:
    """True when a sharded dispatch is possible. The port has no
    multi-card mesh yet (ROADMAP A.7), so never: the scheduler routes
    every device flush to one card and the supervisor's sharded route
    falls through to its per-domain path, as the reference's does when
    its mesh is unavailable."""
    return False


# --- chunk cap (reference :225-330) -----------------------------------------

_configured_cap: Optional[int] = None


def _positive_int(value, what: str) -> int:
    try:
        n = int(value)
    except (TypeError, ValueError):
        raise ValueError(f"{what}={value!r} is not an integer") from None
    if n < 1:
        raise ValueError(f"{what}={n} must be >= 1")
    return n


def configure_chunk_cap(cap: Optional[int]) -> None:
    """Install a node-wide chunk cap (None drops it). An explicitly set
    CBFT_TPU_MAX_CHUNK still wins."""
    global _configured_cap
    _configured_cap = None if cap is None else _positive_int(cap, "max_chunk")


_scoped = threading.local()


@contextmanager
def chunk_cap_scope(cap: Optional[int]):
    """Within the block, on this thread, ``cap`` takes the place of the
    configured cap (None leaves it). A verifier built from a
    ``crypto.batch.BackendSpec`` carries its node's ``max_chunk`` this
    way, so two nodes in one process keep their own caps."""
    prev = getattr(_scoped, "cap", None)
    _scoped.cap = prev if cap is None else _positive_int(cap, "max_chunk")
    try:
        yield
    finally:
        _scoped.cap = prev


def resolve_chunk_cap(default: int) -> int:
    """CBFT_TPU_MAX_CHUNK (validated) beats this thread's scoped cap beats
    the configured cap beats the caller's per-curve default."""
    raw = os.environ.get("CBFT_TPU_MAX_CHUNK")
    if raw is not None:
        return _positive_int(raw, "CBFT_TPU_MAX_CHUNK")
    scoped = getattr(_scoped, "cap", None)
    if scoped is not None:
        return scoped
    return default if _configured_cap is None else _configured_cap


def chunk_cap(default: int) -> int:
    """The cap a dispatch uses now: the resolved cap halved once per OOM
    shrink level of this thread's fault domain (``topology.device_scope``,
    else the default topology's device 0), never below one lane."""
    from cometbft_tpu_torch.crypto.cuda import topology

    handle = topology.current_device() or _shim_device()
    return handle.chunk_cap(default)


# --- OOM-adaptive chunk cap (reference :276-330) ----------------------------
# A card that runs out of memory is over-chunked, not broken: the
# supervisor halves the cap of that fault domain and retries, and the cap
# recovers one doubling per N clean dispatches (hysteresis). The ladder
# lives on each topology.DeviceHandle; the functions below act on the
# default topology's device 0, for callers that dispatch outside any
# device scope.

MAX_SHRINK_LEVELS = 6


def _shim_device():
    from cometbft_tpu_torch.crypto.cuda import topology

    return topology.default_topology().device(0)


def chunk_shrink_levels() -> int:
    """Halvings applied to the default device's cap."""
    return _shim_device().chunk_shrink_levels()


def shrink_chunk_cap() -> bool:
    """Halve the default device's cap after an OOM; False at the floor."""
    return _shim_device().shrink_chunk_cap()


def note_clean_dispatch(recover_n: int) -> bool:
    """One clean dispatch on the default device; after ``recover_n`` in a
    row one shrink level goes. True when a level was recovered now."""
    return _shim_device().note_clean_dispatch(recover_n)


def reset_chunk_shrink() -> None:
    """Drop the default topology's shrink state, every device's."""
    from cometbft_tpu_torch.crypto.cuda import topology

    topology.default_topology().reset_runtime_state()


# --- the chunk loop (reference :396) ----------------------------------------


def dispatch_batch(
    kernel: Callable[..., torch.Tensor],
    packed: Callable[[int, int], Sequence],
    n: int,
    max_chunk: int,
    device,
) -> np.ndarray:
    """bool[n]: ``kernel(*chunk)`` over chunks of at most
    ``chunk_cap(max_chunk)`` lanes, where ``packed(start, end)`` returns a
    chunk's arguments: numpy arrays (copied to ``device``), tensors
    already on ``device``, or None (passed as is). The kernel returns a
    bool[end - start] tensor."""
    device = torch.device(device)
    if n == 0:
        return np.zeros(0, bool)
    cap = chunk_cap(max_chunk)
    cancel = current_cancel_event()
    masks: List[torch.Tensor] = []
    for start in range(0, n, cap):
        if cancel is not None and cancel.is_set():
            raise DispatchCancelled(
                f"dispatch cancelled before chunk {start // cap} (lanes [{start}:{n}] undone)"
            )
        args = [
            torch.from_numpy(np.ascontiguousarray(a)).to(device) if isinstance(a, np.ndarray) else a
            for a in packed(start, min(start + cap, n))
        ]
        masks.append(kernel(*args))
    return torch.cat(masks).cpu().numpy()
