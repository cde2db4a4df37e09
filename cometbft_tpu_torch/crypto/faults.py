"""Fault injection for the verification device plane (reference:
cometbft_tpu/crypto/faults.py, the injection part :1-337 and
``run_chaos_soak`` :338-505; the port's own copy).

The reference's other chaos rungs stay there until the port has what
they drive: the device-put and memory rungs patch JAX's transfer path and
the memory plane, the sharded and multi-device rungs need the multi-card
mesh (ROADMAP A.7), and the service, HA and telemetry rungs need the
verify service (ROADMAP A.8). A ``device`` scope here therefore always
compares the thread's ``topology.device_scope`` with the plan's index: a
dispatch is never one program over several cards.

``FaultyBackend`` wraps any BatchVerifier and injects the failure modes
a device plane exhibits (wedged links, flapping runtimes, miscompiled
kernels). Wrapping ``"gpu"`` (``install(inner="gpu")``) puts the faults
in front of the card's kernels:

* ``exception_rate``  — probability a dispatch raises FaultInjected;
* ``hang_rate`` / ``hang_s`` — probability a dispatch wedges (sleeps
  ``hang_s``; wakes early if the supervisor's watchdog abandons it via
  mesh.cancel_scope — the zombie-thread path);
* ``corrupt_rate``    — probability a dispatch returns silently WRONG
  verdicts (every mask entry flipped, no exception raised) — the
  silent-corruption class only the CPU audit can catch;
* ``die_after``       — dispatches after the Nth all raise (a backend
  that dies and stays dead until "repaired" by ``plan.clear()``);
* ``jitter_ms``       — uniform random extra latency per dispatch;
* ``oom_rate``        — probability a dispatch raises a
  RESOURCE_EXHAUSTED-shaped error (classified OOM by the supervisor's
  retry ladder, which halves the chunk cap instead of striking the
  breaker);
* ``oom_above_lanes`` — allocator model for the OOM fault
  (``CBFT_FAULT_OOM_ABOVE=<lanes>``): the injected OOM only fires while
  the dispatch device's EFFECTIVE chunk cap (reactive shrinks + the
  memory plane's pre-dispatch guard, topology.DeviceHandle.chunk_cap)
  exceeds the threshold — a cap at or below it "fits in HBM" and the
  dispatch runs clean. This is what lets the memory-guard rung prove a
  proactive shrink PREVENTS the OOM instead of reacting to it;
* ``transient_n``     — countdown: the next N dispatches raise an
  UNAVAILABLE-shaped error then the backend recovers (the flapping
  tunnel the transient-retry rung absorbs);
* ``device``          — scope every fault above to ONE fault domain
  (``CBFT_FAULT_DEVICE=<idx>``): a dispatch whose thread-installed
  topology.device_scope names a different device bypasses injection
  entirely — the multi-device chaos rung kills device k of N and
  asserts the survivors keep serving.

State (dispatch counter, RNG) lives in the shared ``FaultPlan``, not the
verifier instance — new_batch_verifier constructs a fresh verifier per
dispatch, so per-instance state would reset every batch. Mutating a plan
(e.g. ``plan.clear()``) takes effect on the next dispatch, which is how
tests and the chaos soak model repair/recovery.

``run_chaos_soak`` drives a supervised scheduler through a random fault
schedule over N simulated blocks and asserts the node-path invariants:
no future is ever lost, no wrong verdict is ever released (sync audit
mode), and the breaker re-admits the backend once faults stop.
tests/test_torch_supervisor.py runs a short soak of the port and of the
reference on one seed and holds their invariants equal.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import List, Optional, Tuple

from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.crypto import batch as cryptobatch
from cometbft_tpu_torch.crypto.batch import BatchVerifier


class FaultInjected(RuntimeError):
    """An injected dispatch failure (distinguishable from real bugs)."""


class TransientFault(FaultInjected):
    """Injected transient device error — message is UNAVAILABLE-shaped so
    supervisor.classify_device_error files it under the retry rung."""


class ResourceExhaustedFault(FaultInjected):
    """Injected device OOM — message is RESOURCE_EXHAUSTED-shaped so the
    supervisor's ladder shrinks the chunk cap instead of striking."""


class FaultPlan:
    """Shared, mutable schedule of injected faults. Thread-safe; one
    plan drives every FaultyBackend instance registered against it."""

    def __init__(
        self,
        exception_rate: float = 0.0,
        hang_rate: float = 0.0,
        hang_s: float = 3600.0,
        corrupt_rate: float = 0.0,
        die_after: Optional[int] = None,
        jitter_ms: float = 0.0,
        oom_rate: float = 0.0,
        oom_above_lanes: Optional[int] = None,
        transient_n: int = 0,
        seed: int = 0,
        device: Optional[int] = None,
    ):
        self.exception_rate = exception_rate
        self.hang_rate = hang_rate
        self.hang_s = hang_s
        self.corrupt_rate = corrupt_rate
        self.die_after = die_after
        self.jitter_ms = jitter_ms
        self.oom_rate = oom_rate
        # allocator model: an injected OOM fires only while the dispatch
        # device's effective chunk cap exceeds this many lanes (None =
        # every drawn OOM fires, the pre-guard behavior)
        self.oom_above_lanes = oom_above_lanes
        # countdown: the next N dispatches fail transiently, then the
        # backend recovers on its own (re-armable mid-run by assignment)
        self.transient_n = transient_n
        # fault-domain scope: None = every dispatch; an index = only
        # dispatches whose thread carries that topology.device_scope
        self.device = device
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.dispatches = 0  # total dispatches seen (incl. faulted ones)
        # RESOURCE_EXHAUSTED faults that actually FIRED (drawn OOMs
        # suppressed by the oom_above_lanes allocator model don't count)
        # — the memory-guard rung asserts this stays flat under guard
        self.ooms_fired = 0
        # dispatches seen per fault-domain index (only for dispatches
        # carrying a device scope) — the multi-device rung reads this to
        # prove the survivors kept serving the device path
        self.per_device: dict = {}

    @classmethod
    def from_env(cls) -> "FaultPlan":
        """Env-driven plan so the chaos soak (and a faulty node) can be
        configured without code: CBFT_FAULT_EXC_RATE, CBFT_FAULT_HANG_RATE,
        CBFT_FAULT_HANG_S, CBFT_FAULT_CORRUPT_RATE, CBFT_FAULT_DIE_AFTER,
        CBFT_FAULT_JITTER_MS, CBFT_FAULT_OOM_RATE, CBFT_FAULT_OOM_ABOVE
        (allocator-model lane threshold), CBFT_FAULT_TRANSIENT_N,
        CBFT_FAULT_SEED, CBFT_FAULT_DEVICE (fault-domain scope)."""
        e = os.environ
        die = e.get("CBFT_FAULT_DIE_AFTER")
        dev = e.get("CBFT_FAULT_DEVICE")
        above = e.get("CBFT_FAULT_OOM_ABOVE")
        return cls(
            exception_rate=float(e.get("CBFT_FAULT_EXC_RATE", "0")),
            hang_rate=float(e.get("CBFT_FAULT_HANG_RATE", "0")),
            hang_s=float(e.get("CBFT_FAULT_HANG_S", "3600")),
            corrupt_rate=float(e.get("CBFT_FAULT_CORRUPT_RATE", "0")),
            die_after=int(die) if die is not None else None,
            jitter_ms=float(e.get("CBFT_FAULT_JITTER_MS", "0")),
            oom_rate=float(e.get("CBFT_FAULT_OOM_RATE", "0")),
            oom_above_lanes=int(above) if above is not None else None,
            transient_n=int(e.get("CBFT_FAULT_TRANSIENT_N", "0")),
            seed=int(e.get("CBFT_FAULT_SEED", "0")),
            device=int(dev) if dev is not None else None,
        )

    def clear(self) -> None:
        """Repair the backend: stop injecting everything (in place, so
        already-registered factories see it on their next dispatch)."""
        self.exception_rate = 0.0
        self.hang_rate = 0.0
        self.corrupt_rate = 0.0
        self.die_after = None
        self.jitter_ms = 0.0
        self.oom_rate = 0.0
        self.transient_n = 0

    def _count_bypass(self, device_idx: Optional[int]) -> int:
        """Count a dispatch that bypassed injection because its device
        scope is outside the plan's target domain."""
        with self._lock:
            self.dispatches += 1
            if device_idx is not None:
                self.per_device[device_idx] = (
                    self.per_device.get(device_idx, 0) + 1
                )
            return self.dispatches

    def _decide(
        self, device_idx: Optional[int] = None
    ) -> Tuple[int, bool, bool, bool, float, bool, bool]:
        """→ (dispatch_no, raise?, hang?, corrupt?, jitter_s, transient?,
        oom?) for one dispatch, under the lock so concurrent dispatches
        draw distinct RNG samples and the counters are exact."""
        with self._lock:
            self.dispatches += 1
            no = self.dispatches
            if device_idx is not None:
                self.per_device[device_idx] = (
                    self.per_device.get(device_idx, 0) + 1
                )
            dead = self.die_after is not None and no > self.die_after
            raise_ = dead or self._rng.random() < self.exception_rate
            hang = self._rng.random() < self.hang_rate
            corrupt = self._rng.random() < self.corrupt_rate
            jitter_s = (
                self._rng.random() * self.jitter_ms / 1e3
                if self.jitter_ms > 0 else 0.0
            )
            transient = False
            if self.transient_n > 0:
                self.transient_n -= 1
                transient = True
            oom = self._rng.random() < self.oom_rate
        return no, raise_, hang, corrupt, jitter_s, transient, oom


class FaultyBackend(BatchVerifier):
    """BatchVerifier wrapper applying a FaultPlan to every verify()."""

    def __init__(self, plan: FaultPlan, inner: BatchVerifier):
        self._plan = plan
        self._inner = inner
        self._n = 0

    @property
    def inner(self) -> BatchVerifier:
        """The wrapped verifier (``batch.prepare_backend`` reads it)."""
        return self._inner

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        self._inner.add(pub_key, msg, sig)
        self._n += 1

    def count(self) -> int:
        return self._n

    def verify(self) -> Tuple[bool, List[bool]]:
        n, self._n = self._n, 0
        from cometbft_tpu_torch.crypto.cuda import topology

        dev = topology.current_device()
        dev_idx = dev.index if dev is not None else None
        target = ""
        if self._plan.device is not None and dev_idx != self._plan.device:
            # this dispatch targets a different fault domain than the
            # plan scopes to — it runs clean (that is the whole point of
            # device-targeted chaos: the survivors must not feel it)
            self._plan._count_bypass(dev_idx)
            return self._inner.verify()
        no, raise_, hang, corrupt, jitter_s, transient, oom = (
            self._plan._decide(dev_idx)
        )
        if jitter_s:
            time.sleep(jitter_s)
        if hang:
            _interruptible_hang(self._plan.hang_s)
        if transient:
            self._inner.verify()  # drop the held items like a real death
            raise TransientFault(
                f"UNAVAILABLE: injected transient tunnel flap "
                f"(dispatch #{no}, {n} items){target}"
            )
        if oom and self._plan.oom_above_lanes is not None:
            # allocator model: the OOM only fires while the device would
            # dispatch WIDER than the threshold — a chunk cap already
            # clamped (by the memory guard, or by earlier reactive
            # shrinks) at or below it fits in HBM and runs clean
            handle = dev
            if handle is None:
                handle = topology.default_topology().device(0)
            if handle.chunk_cap(8192, 1) <= self._plan.oom_above_lanes:
                oom = False
        if oom:
            with self._plan._lock:
                self._plan.ooms_fired += 1
            self._inner.verify()
            raise ResourceExhaustedFault(
                f"RESOURCE_EXHAUSTED: injected HBM allocation failure "
                f"(dispatch #{no}, {n} items){target}"
            )
        if raise_:
            self._inner.verify()  # drop the held items like a real death
            raise FaultInjected(
                f"injected dispatch failure (dispatch #{no}, "
                f"{n} items){target}"
            )
        ok, mask = self._inner.verify()
        if corrupt:
            mask = [not b for b in mask]  # silent wrong verdicts, no raise
            ok = all(mask)
        return ok, mask


def _interruptible_hang(seconds: float) -> None:
    """Simulate a wedged dispatch. If a supervisor watchdog has
    abandoned this thread (mesh.cancel_scope), wake early and die the
    way a cancelled chunk loop does — so tests don't strand sleeping
    threads for an hour."""
    from cometbft_tpu_torch.crypto.cuda import mesh

    ev = mesh.current_cancel_event()
    if ev is None:
        time.sleep(seconds)
        return
    if ev.wait(seconds):
        raise mesh.DispatchCancelled("injected hang abandoned by watchdog")


def install(
    name: str = "faulty",
    inner: cryptobatch.Backend = "cpu",
    plan: Optional[FaultPlan] = None,
) -> FaultPlan:
    """Register a FaultyBackend factory under ``name`` wrapping the
    ``inner`` backend; returns the (shared, live-mutable) plan."""
    plan = plan if plan is not None else FaultPlan.from_env()
    cryptobatch.register_backend(
        name,
        lambda: FaultyBackend(plan, cryptobatch.new_batch_verifier(inner)),
    )
    return plan


# ---------------------------------------------------------------------------
# chaos soak: random fault schedule over simulated blocks
# ---------------------------------------------------------------------------


def run_chaos_soak(
    n_blocks: int = 50,
    batch: int = 48,
    seed: int = 1234,
    inner: cryptobatch.Backend = "cpu",
    dispatch_timeout_ms: int = 500,
    probe_base_ms: int = 20,
    n_submitters: int = 3,
    logger=None,
) -> dict:
    """Drive a supervised VerifyScheduler through ``n_blocks`` simulated
    blocks under a randomized fault schedule (regime re-rolled every few
    blocks among: none / exceptions / hangs / corruption / dead), with
    ``n_submitters`` concurrent threads submitting per block, then clear
    the faults and wait for breaker re-admission.

    Invariants checked here (the caller asserts on the summary):
      * every future completes — ``lost_futures`` == 0;
      * every released verdict equals the CPU ground truth —
        ``wrong_verdicts`` == 0 (sync-audit mode re-checks every device
        batch before release, so corruption cannot escape);
      * after faults stop, the breaker re-admits the backend —
        ``readmitted`` is True and the device saw post-recovery traffic.
    """
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto.batch import BackendSpec, CPUBatchVerifier
    from cometbft_tpu_torch.crypto.scheduler import VerifyScheduler
    from cometbft_tpu_torch.crypto.supervisor import HEALTHY, BackendSupervisor

    rng = random.Random(seed)
    name = f"chaos-{seed}-{n_blocks}"
    plan = install(name=name, inner=inner, plan=FaultPlan(seed=seed))
    sup = BackendSupervisor(
        spec=BackendSpec(name),
        dispatch_timeout_ms=dispatch_timeout_ms,
        breaker_threshold=2,
        audit_pct=100,
        audit_sync=True,  # the no-wrong-verdict-ever mode (see supervisor.py)
        probe_base_ms=probe_base_ms,
        probe_max_ms=probe_base_ms * 8,
        logger=logger,
    )
    sched = VerifyScheduler(
        spec=BackendSpec(name), flush_us=1000, supervisor=sup, logger=logger
    )
    sched.start()

    keys = [
        ed.gen_priv_key_from_secret(b"chaos-%d" % i) for i in range(32)
    ]
    regimes = ("none", "exceptions", "hangs", "corruption", "dead",
               "jitter", "oom", "transient")
    wrong = lost = 0
    regime_counts = {r: 0 for r in regimes}

    def make_block(h: int):
        items, truth = [], []
        for i in range(batch):
            k = keys[(h + i) % len(keys)]
            msg = b"chaos block %d sig %d" % (h, i)
            good = rng.random() > 0.1  # ~10% genuinely bad signatures
            sig = k.sign(msg) if good else b"\x11" * 64
            items.append((k.pub_key(), msg, sig))
            truth.append(good)
        return items, truth

    def apply_regime(r: str) -> None:
        plan.clear()
        if r == "exceptions":
            plan.exception_rate = 0.7
        elif r == "hangs":
            plan.hang_rate = 1.0
            plan.hang_s = 30.0
        elif r == "corruption":
            plan.corrupt_rate = 1.0
        elif r == "dead":
            plan.die_after = 0
        elif r == "jitter":
            plan.jitter_ms = 5.0
        elif r == "oom":
            plan.oom_rate = 0.5
        elif r == "transient":
            plan.transient_n = 3

    try:
        for h in range(n_blocks):
            if h % 4 == 0:
                regime = rng.choice(regimes)
                apply_regime(regime)
            regime_counts[regime] += 1
            items, truth = make_block(h)
            # split the block across concurrent submitters, like the
            # node's subsystems racing into one coalesced dispatch
            per = max(1, len(items) // n_submitters)
            slices = [
                (items[i : i + per], truth[i : i + per])
                for i in range(0, len(items), per)
            ]
            futs = [(sched.submit(s), t) for s, t in slices]
            sched.flush()
            for fut, t in futs:
                try:
                    _, mask = fut.result(
                        timeout=dispatch_timeout_ms / 1e3 + 30
                    )
                except Exception:  # noqa: BLE001 - a lost/failed future
                    lost += 1
                    continue
                if mask != t:
                    wrong += 1

        # recovery: faults off, breaker must re-admit via canary probes
        plan.clear()
        deadline = time.monotonic() + 30.0
        readmitted = False
        while time.monotonic() < deadline:
            if sup.state() == HEALTHY:
                readmitted = True
                break
            # traffic while broken is what triggers the lazy probe kick
            ok, _ = sched.submit(
                [(keys[0].pub_key(), b"recovery ping", keys[0].sign(b"recovery ping"))]
            ).result(timeout=30)
            assert ok
            time.sleep(probe_base_ms / 1e3)
        before = plan.dispatches
        post_items, post_truth = make_block(n_blocks + 1)
        _, post_mask = sched.submit(post_items).result(timeout=60)
        if post_mask != post_truth:
            wrong += 1
        device_resumed = plan.dispatches > before
    finally:
        sched.stop()
        sup.stop()

    # sanity: the ground-truth oracle itself agrees with serial verify
    bv = CPUBatchVerifier()
    for pk, m, s in post_items:
        bv.add(pk, m, s)
    _, oracle = bv.verify()
    assert oracle == post_truth

    def total(counter) -> float:
        # labeled counters accumulate in with_labels() children; the
        # parent's own value stays 0 — sum the whole series
        return sum(c.value() for c in counter._series())

    return {
        "blocks": n_blocks,
        "batch": batch,
        "regimes": regime_counts,
        "wrong_verdicts": wrong,
        "lost_futures": lost,
        "trips": total(sup.metrics.trips),
        "watchdog_kills": sup.metrics.watchdog_kills.value(),
        "audit_mismatches": sup.metrics.audit_mismatches.value(),
        "probes": total(sup.metrics.probes),
        "backend_dispatches": plan.dispatches,
        "readmitted": readmitted,
        "device_resumed_after_recovery": device_resumed,
        "final_state": sup.state(),
    }
