"""Device topology — the verification plane's fault domains as a
first-class registry (reference: cometbft_tpu/crypto/tpu/topology.py; the
port's own copy).

* a ``DeviceHandle`` is ONE fault domain — a CUDA card, or a logical
  domain for tests and chaos harnesses — and owns the per-device OOM
  chunk-cap ladder (reference :49-147) that ``mesh.chunk_cap`` reads;
* a ``DeviceTopology`` enumerates the node's fault domains: one card
  (``single``), every visible card (``detect``, which counts
  ``torch.cuda.device_count()``), or N logical domains (``virtual``);
  quarantine membership and its ``generation`` live here, and the key
  store (``keystore._topo_generation``) drops entries built under an
  older generation;
* ``device_scope`` installs a handle as the calling thread's dispatch
  target. For a card's handle it also makes that card current on the
  thread and enters the handle's own stream: a fresh Python thread starts
  on card 0 and on the legacy default stream, and every ctypes launcher
  launches on ``torch.cuda.current_stream(device)`` (``build.stream_ptr``).
  One stream per fault domain: a domain's dispatches, canary probes and
  triage passes run on it in launch order (a wedged kernel holds the
  canary behind it, so the canary cannot re-admit a card whose stream is
  still wedged; the watchdog times the probe out instead). Every dispatch
  reads its verdicts back to the host before it returns, and a key-store
  upload waits for its table build before the entry is published
  (``ed25519_batch._build_resident``), so nothing a dispatch reads is
  still being written on another stream.

Three differences from the reference: ``detect()`` raises when there is
no CUDA device instead of falling back to ``single()`` (reference
:184-197): under a device spec no card is an error, raised before
anything is queued. The memory plane's guard cap stays None (ROADMAP
A.4). The sharded mesh waits for multi-GPU (ROADMAP A.7).
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional

KIND_CHIP = "chip"        # one CUDA card
KIND_MESH = "mesh"        # one card of several
KIND_VIRTUAL = "virtual"  # logical domain (tests, chaos harnesses)
_CUDA_KINDS = (KIND_CHIP, KIND_MESH)


class DeviceHandle:
    """One fault domain. Owns the per-device OOM-adaptive chunk-cap
    ladder (halve on RESOURCE_EXHAUSTED, recover one doubling per N
    clean dispatches — hysteresis, see mesh.py); everything else that
    is per-domain (breaker, probes, latency model) lives with the
    supervisor's domain records, keyed by this handle."""

    def __init__(self, index: int, kind: str = KIND_VIRTUAL):
        self.index = int(index)
        self.kind = kind
        self.label = f"dev{int(index)}"
        self._mtx = threading.Lock()
        self._shrink_levels = 0
        self._clean_streak = 0
        self._memory_guard_cap: Optional[int] = None
        self._stream = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DeviceHandle({self.label}, kind={self.kind})"

    # -- per-device OOM-adaptive chunk cap -----------------------------------

    def chunk_shrink_levels(self) -> int:
        """How many halvings are currently applied to this device's cap."""
        with self._mtx:
            return self._shrink_levels

    def shrink_chunk_cap(self) -> bool:
        """Halve this device's effective chunk cap after an OOM. → True
        if a level was added, False at the floor (the caller should then
        treat the OOM as persistent)."""
        from cometbft_tpu_torch.crypto.cuda import mesh

        with self._mtx:
            self._clean_streak = 0  # an OOM restarts the hysteresis
            if self._shrink_levels >= mesh.MAX_SHRINK_LEVELS:
                return False
            self._shrink_levels += 1
            return True

    def note_clean_dispatch(self, recover_n: int) -> bool:
        """Record one clean dispatch on this device; after ``recover_n``
        consecutive clean dispatches one shrink level is removed. → True
        when a level was recovered on this call."""
        with self._mtx:
            if self._shrink_levels == 0:
                return False
            self._clean_streak += 1
            if self._clean_streak < max(1, recover_n):
                return False
            self._clean_streak = 0
            self._shrink_levels -= 1
            return True

    def reset_chunk_shrink(self) -> None:
        """Drop this device's shrink state (supervisor stop, topology
        change, tests) — a restarted supervisor must not inherit a
        shrunken cap from a previous incident. The memory-guard cap is
        dropped too: it is recomputed from live stats on the next
        guarded dispatch."""
        with self._mtx:
            self._shrink_levels = 0
            self._clean_streak = 0
            self._memory_guard_cap = None

    # -- pre-dispatch memory-guard cap (the memory plane, ROADMAP A.4) --------

    def memory_guard_cap(self) -> Optional[int]:
        """The chunk cap the memory plane's pre-dispatch guard imposes
        on this device right now, or None when unconstrained."""
        with self._mtx:
            return self._memory_guard_cap

    def set_memory_guard_cap(self, cap: Optional[int]) -> None:
        """Install (or clear, with None) the memory-guard chunk cap.
        Written only by MemoryPlane.refresh_guard."""
        with self._mtx:
            self._memory_guard_cap = None if cap is None else int(cap)

    def chunk_cap(self, default: int, min_pad: int = 1) -> int:
        """The dispatch chunk cap THIS device serves right now: the
        node-wide resolved cap (env > scope > config > per-curve
        default; a CUDA kernel takes any batch, so no power of two)
        halved once per active shrink level, clamped by the memory
        plane's pre-dispatch guard, floored at min_pad."""
        from cometbft_tpu_torch.crypto.cuda import mesh

        size = mesh.resolve_chunk_cap(default)
        size = max(min_pad, size >> self.chunk_shrink_levels())
        guard = self.memory_guard_cap()
        if guard is not None:
            size = max(min_pad, min(size, guard))
        return size

    # -- the card behind a CUDA handle ----------------------------------------

    def is_cuda(self) -> bool:
        """True for a card's handle (chip or mesh kind) while torch sees
        a card; virtual and host handles never touch CUDA."""
        if self.kind not in _CUDA_KINDS:
            return False
        import torch

        return torch.cuda.is_available()

    def stream(self):
        """This fault domain's own CUDA stream on card ``index``, made on
        first use."""
        import torch

        with self._mtx:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.index)
            return self._stream

    def capacity_fraction(self) -> float:
        """This device's share of its own nominal lane capacity
        (1.0 unshrunk, halved per active OOM shrink level) — the weight
        the supervisor's batch-axis partition and the scheduler's
        healthy lane budget use."""
        return 1.0 / float(1 << self.chunk_shrink_levels())


class DeviceTopology:
    """Registry of the node's verification fault domains."""

    def __init__(self, devices: List[DeviceHandle], kind: str = KIND_VIRTUAL):
        if not devices:
            raise ValueError("a topology needs at least one device")
        self.devices = list(devices)
        self.kind = kind
        # quarantine membership + the change generation live on the
        # TOPOLOGY, not the handle: healthy_devices() must be computed
        # against one consistent set under one lock, so every thread
        # slicing a shard plan from the same generation builds the same
        # mesh (mesh construction from divergent views would hand the
        # sharded program two different device orders).
        self._q_mtx = threading.Lock()
        self._quarantined: set = set()
        self._generation = 0

    # -- constructors --------------------------------------------------------

    @classmethod
    def single(cls, kind: str = KIND_CHIP) -> "DeviceTopology":
        """The 1-chip (or plain-CPU-plane) topology — the default; every
        pre-topology behavior maps onto its device 0."""
        return cls([DeviceHandle(0, kind)], kind)

    @classmethod
    def virtual(cls, n: int) -> "DeviceTopology":
        """``n`` logical fault domains with no hardware binding — chaos
        harnesses, tests, and the CBFT_FAULT_DOMAINS operator knob."""
        n = max(1, int(n))
        return cls([DeviceHandle(i, KIND_VIRTUAL) for i in range(n)],
                   KIND_VIRTUAL)

    @classmethod
    def detect(cls) -> "DeviceTopology":
        """One fault domain per visible CUDA card. Raises RuntimeError
        when there is none: the reference falls back to ``single()``
        when its probe fails (:184-197), which would let a device spec
        run on nothing; here the caller asked for cards, and the error
        comes before anything is queued."""
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 1:
            raise RuntimeError("device topology: no CUDA device is available")
        if n == 1:
            return cls.single()
        return cls([DeviceHandle(i, KIND_MESH) for i in range(n)], KIND_MESH)

    # -- registry ------------------------------------------------------------

    def device(self, index: int) -> DeviceHandle:
        return self.devices[index]

    def labels(self) -> List[str]:
        return [d.label for d in self.devices]

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self) -> Iterator[DeviceHandle]:
        return iter(self.devices)

    def reset_runtime_state(self) -> None:
        """Drop every device's runtime (shrink) state — called on
        supervisor stop and on topology change so no incident state
        leaks into the next lifecycle. Quarantine state goes with it
        (the breakers that imposed it are gone), bumping the generation
        so cached shard plans re-slice."""
        for d in self.devices:
            d.reset_chunk_shrink()
        with self._q_mtx:
            if self._quarantined:
                self._quarantined.clear()
                self._generation += 1

    # -- quarantine / mesh membership ----------------------------------------

    def set_quarantined(self, index: int, flag: bool = True) -> bool:
        """Mark device ``index`` quarantined (excluded from the sharded
        mesh) or readmit it. The supervisor calls this when a domain's
        breaker trips/closes; the sharded plan cache (mesh.py) re-slices
        on the generation bump. → True when membership actually changed
        on this call."""
        index = int(index)
        with self._q_mtx:
            if flag:
                if index in self._quarantined:
                    return False
                self._quarantined.add(index)
            else:
                if index not in self._quarantined:
                    return False
                self._quarantined.discard(index)
            self._generation += 1
            return True

    def is_quarantined(self, index: int) -> bool:
        with self._q_mtx:
            return int(index) in self._quarantined

    def healthy_devices(self) -> List[DeviceHandle]:
        """The non-quarantined devices in STABLE index order — the mesh
        construction order. Deterministic by design: two threads that
        observe the same generation() get the same list, so re-slicing
        under quarantine yields the same sub-mesh everywhere."""
        with self._q_mtx:
            quarantined = set(self._quarantined)
        return [d for d in self.devices if d.index not in quarantined]

    def generation(self) -> int:
        """Topology-change counter: bumps on every quarantine membership
        change (and on reset clearing a non-empty set). Cached shard
        plans key on this and re-slice when it moves."""
        with self._q_mtx:
            return self._generation

    def snapshot(self) -> dict:
        """JSON-ready layout + runtime state for the capacity plane
        (/debug/verify): which fault domains exist and how much of
        their nominal lane capacity each currently serves."""
        return {
            "kind": self.kind,
            "n_devices": len(self.devices),
            "generation": self.generation(),
            "devices": [
                {
                    "label": d.label,
                    "kind": d.kind,
                    "shrink_levels": d.chunk_shrink_levels(),
                    "capacity_fraction": d.capacity_fraction(),
                    "memory_guard_cap": d.memory_guard_cap(),
                    "quarantined": self.is_quarantined(d.index),
                }
                for d in self.devices
            ],
        }

    def fingerprint(self) -> str:
        """Identity of this fault-domain layout (kind and device count),
        excluding runtime state (shrink levels, breaker phases). The
        reference keys its AOT executables on it; the port has no such
        registry and keeps it for snapshots and callers that compare
        layouts."""
        return "{}:{}".format(self.kind, len(self.devices))


# --- default topology (process-wide, like mesh._configured_cap) -------------

_mtx = threading.Lock()
_default: Optional[DeviceTopology] = None


def default_topology() -> DeviceTopology:
    """The process default: lazily a single-card topology (the reference
    also lets node start install another; the port waits for multi-GPU,
    ROADMAP A.7). The mesh module's chunk-cap functions outside any
    device scope act on THIS topology's device 0, and the key store's
    staleness reads its generation."""
    global _default
    with _mtx:
        if _default is None:
            _default = DeviceTopology.single()
        return _default


# --- thread-local device scope ----------------------------------------------
# Same pattern as mesh.cancel_scope: the supervisor installs the target
# domain's handle on the dispatching thread; the mesh chunk loop reads
# it for the per-device chunk cap, fault injection reads it to target
# one domain. Strictly thread-local, so concurrent dispatches to
# different devices never see each other's handle. A card's handle also
# makes its card current and enters its stream for the block.

_scope_local = threading.local()


def current_device() -> Optional[DeviceHandle]:
    """The device handle installed on THIS thread, if any."""
    return getattr(_scope_local, "device", None)


class device_scope:
    """Context manager installing ``handle`` as this thread's dispatch
    target device; nests (restores the previous handle, card and stream
    on exit). For a card's handle, card ``handle.index`` is current and
    the handle's stream is the current stream inside the block."""

    def __init__(self, handle: DeviceHandle):
        self._handle = handle
        self._prev = None
        self._cuda = None

    def __enter__(self) -> DeviceHandle:
        self._prev = getattr(_scope_local, "device", None)
        _scope_local.device = self._handle
        if self._handle.is_cuda():
            import torch

            prev_dev = torch.cuda.current_device()
            torch.cuda.set_device(self._handle.index)
            ctx = torch.cuda.stream(self._handle.stream())
            ctx.__enter__()
            self._cuda = (prev_dev, ctx)
        return self._handle

    def __exit__(self, *exc_info) -> bool:
        if self._cuda is not None:
            import torch

            prev_dev, ctx = self._cuda
            self._cuda = None
            ctx.__exit__(*exc_info)
            torch.cuda.set_device(prev_dev)
        _scope_local.device = self._prev
        return False
