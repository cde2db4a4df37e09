"""QoS admission control for the verification scheduler — priority
classes, per-tenant token-bucket quotas, and a brownout controller
(reference: cometbft_tpu/crypto/qos.py, all of it; the port's own copy).

ROADMAP item 2 (the fleet-scale verification service) names the hard
parts of serving one device pool to many clients: priority classes,
per-tenant quotas, and load-shedding. This module is the policy half;
crypto/scheduler.py holds the mechanism (per-class lanes, strict-
priority + weighted-deficit flush assembly, per-class overload
actions). Keeping the policy here — import-light, no jax, no crypto
backends — lets config.py validate ``[crypto] qos_classes`` at startup
without dragging the device plane in, and lets tests drive the
controller with a fake clock.

The class ladder (highest priority first):

  ==========  ========  ==============================================
  class       policy    overload behavior at the class queue bound
  ==========  ========  ==============================================
  consensus   block     submit() blocks (bounded) — today's
                        backpressure; votes are never shed or dropped
  evidence    block     same: equivocation proofs must land
  blocksync   shed      wait up to the shed deadline, then verify
                        inline on the submitter's CPU
  light       shed      same — a light query is latency-tolerant
  mempool     drop      best-effort: complete immediately with a
                        ``rejected`` verdict (callers re-verify on CPU)
  ==========  ========  ==============================================

Requests resolve to a class from their existing ``subsystem`` origin
tag (the same key the telemetry's RED metering buckets by). Untagged and
unknown-tagged traffic maps to the TOP class deliberately: today's
untagged call sites are commit verification (consensus/state.py, the
light verifier, evidence) — work that must never be shed by default.
Tag a subsystem to opt it INTO a lower class, never to protect it.

Spec grammar (``[crypto] qos_classes`` / env ``CBFT_QOS_CLASSES``):
``default`` (or empty) = the built-in ladder above; ``off`` = QoS
disabled, the legacy single FIFO; otherwise a comma-separated list of
``name[:policy[:max_queue[:weight]]]`` entries whose order IS the
priority order, e.g. ``consensus,blocksync:shed:8192:4,mempool:drop``.
Unknown class names and non-positive bounds/weights are rejected at
config validation with the same error style as the other [crypto]
knobs.

The brownout controller is the demand-side half of the supervisor's
supply-side degradation ladder: when the SLO error budget burns
(TelemetryHub watcher — the same hook the incident profiler rides) or the
supervisor aggregate goes DEGRADED/BROKEN, it progressively disables
the sheddable classes, lowest priority first (mempool → light →
blocksync), and re-admits them hysteretically after a configurable
streak of clean observations. Block-policy classes are never browned
out — brownout exists to protect exactly them.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from cometbft_tpu_torch.libs.metrics import Registry

POLICY_BLOCK = "block"
POLICY_SHED = "shed"
POLICY_DROP = "drop"
POLICIES = (POLICY_BLOCK, POLICY_SHED, POLICY_DROP)

# the built-in ladder, highest priority first; order is priority
CLASS_ORDER = ("consensus", "evidence", "blocksync", "light", "mempool")
DEFAULT_POLICIES = {
    "consensus": POLICY_BLOCK,
    "evidence": POLICY_BLOCK,
    "blocksync": POLICY_SHED,
    "light": POLICY_SHED,
    "mempool": POLICY_DROP,
}
# weighted-deficit shares below the top class (the top class is served
# strictly first and needs no weight)
DEFAULT_WEIGHTS = {
    "consensus": 8,
    "evidence": 4,
    "blocksync": 2,
    "light": 1,
    "mempool": 1,
}
# subsystem origin tags that fold into a class under a different name
SUBSYSTEM_ALIASES = {
    "statesync": "light",
    "rpc": "light",
}
TENANT_UNTAGGED = "untagged"  # mirrors telemetry.UNTAGGED (no import cycle)

DEFAULT_SHED_MS = 50
DEFAULT_TENANT_BURST_FACTOR = 2.0
QOS_SUBSYSTEM = "verify_qos"

# sigs of credit per weight unit per deficit round-robin round; small
# relative to the lane budget so proportions emerge across rounds, yet
# large enough that typical commit-sized requests clear in a few rounds
DRR_QUANTUM = 64


@dataclass(frozen=True)
class ClassSpec:
    """One priority class: its admission bound and overload policy.
    ``max_queue`` None = inherit the scheduler-wide [crypto] max_queue."""

    name: str
    policy: str
    max_queue: Optional[int] = None
    weight: int = 1
    shed_ms: int = DEFAULT_SHED_MS


def _default_spec(name: str) -> ClassSpec:
    return ClassSpec(
        name=name,
        policy=DEFAULT_POLICIES[name],
        max_queue=None,
        weight=DEFAULT_WEIGHTS[name],
        shed_ms=shed_ms_default(),
    )


def shed_ms_default(config_value: Optional[int] = None) -> int:
    """Per-class shed deadline (ms): how long a shed-policy submit waits
    for queue room before verifying inline on the submitter's CPU.
    CBFT_QOS_SHED_MS env > config > built-in 50."""
    raw = os.environ.get("CBFT_QOS_SHED_MS")
    if raw is not None:
        return int(raw)
    if config_value is not None:
        return int(config_value)
    return DEFAULT_SHED_MS


def qos_classes_default(config_value: Optional[str] = None) -> str:
    """Raw class-spec resolution, same precedence shape as every other
    [crypto] knob: CBFT_QOS_CLASSES env > [crypto] qos_classes >
    built-in ``default``."""
    raw = os.environ.get("CBFT_QOS_CLASSES")
    if raw is not None:
        return raw
    if config_value is not None:
        return config_value
    return "default"


def tenant_rate_default(config_value: Optional[int] = None) -> int:
    """Per-tenant token-bucket refill rate (sigs/sec; 0 = unlimited).
    CBFT_QOS_TENANT_RATE env > [crypto] qos_tenant_rate > 0."""
    raw = os.environ.get("CBFT_QOS_TENANT_RATE")
    if raw is not None:
        return int(raw)
    if config_value is not None:
        return int(config_value)
    return 0


def parse_qos_classes(raw: Optional[str]) -> Optional[List[ClassSpec]]:
    """Parse a qos_classes spec into the priority-ordered class list,
    or None when QoS is disabled (``off``). Raises ValueError in the
    [crypto]-knob validation style for unknown class names, unknown
    policies, and non-positive bounds/weights — config.validate_basic
    calls this so a malformed TOML fails at startup, not at the first
    overload."""
    if raw is None:
        raw = "default"
    if not isinstance(raw, str):
        raise ValueError(
            f"crypto.qos_classes must be a string, got {raw!r}"
        )
    text = raw.strip().lower()
    if text in ("", "default"):
        return [_default_spec(name) for name in CLASS_ORDER]
    if text == "off":
        return None
    specs: List[ClassSpec] = []
    seen = set()
    for token in text.split(","):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":")
        name = parts[0].strip()
        if name not in CLASS_ORDER:
            raise ValueError(
                f"crypto.qos_classes: unknown class {name!r} "
                f"(known: {', '.join(CLASS_ORDER)})"
            )
        if name in seen:
            raise ValueError(
                f"crypto.qos_classes: class {name!r} listed twice"
            )
        seen.add(name)
        policy = DEFAULT_POLICIES[name]
        max_queue: Optional[int] = None
        weight = DEFAULT_WEIGHTS[name]
        if len(parts) > 1 and parts[1].strip():
            policy = parts[1].strip()
            if policy not in POLICIES:
                raise ValueError(
                    f"crypto.qos_classes: {name} policy must be one of "
                    f"{list(POLICIES)}, got {policy!r}"
                )
        if len(parts) > 2 and parts[2].strip():
            max_queue = _positive_int(name, "max_queue", parts[2].strip())
        if len(parts) > 3 and parts[3].strip():
            weight = _positive_int(name, "weight", parts[3].strip())
        if len(parts) > 4:
            raise ValueError(
                f"crypto.qos_classes: {name!r} has too many fields "
                "(grammar: name[:policy[:max_queue[:weight]]])"
            )
        specs.append(ClassSpec(
            name=name, policy=policy, max_queue=max_queue,
            weight=weight, shed_ms=shed_ms_default(),
        ))
    if not specs:
        raise ValueError("crypto.qos_classes: no classes specified")
    return specs


def _positive_int(cls_name: str, field_name: str, token: str) -> int:
    try:
        v = int(token)
    except ValueError:
        raise ValueError(
            f"crypto.qos_classes: {cls_name} {field_name} must be a "
            f"positive integer, got {token!r}"
        ) from None
    if v < 1:
        raise ValueError(
            f"crypto.qos_classes: {cls_name} {field_name} must be a "
            f"positive integer, got {v!r}"
        )
    return v


def resolve_class(
    subsystem: Optional[str], names: Sequence[str]
) -> str:
    """Map a request's subsystem origin tag to a configured class name.
    ``names`` is the configured priority order (highest first).
    Untagged, unknown, and aliased-but-unconfigured traffic resolves to
    the TOP class: untagged production traffic today is commit
    verification, which must never be shed by a default mapping."""
    if subsystem:
        tag = SUBSYSTEM_ALIASES.get(subsystem, subsystem)
        if tag in names:
            return tag
    return names[0]


# wire code for "no class tag" — rides the verify-service frame header,
# where a QoS class is one byte, not a string
CLASS_CODE_UNTAGGED = 0xFF


def class_code(name: Optional[str]) -> int:
    """One-byte wire code for a class name (its CLASS_ORDER position).
    Unknown or absent names travel as CLASS_CODE_UNTAGGED and resolve
    server-side exactly like an untagged in-process submit — to the top
    class, never to a sheddable one."""
    if name in CLASS_ORDER:
        return CLASS_ORDER.index(name)
    return CLASS_CODE_UNTAGGED


def class_name(code: int) -> Optional[str]:
    """Inverse of class_code. None for the untagged sentinel; raises
    ValueError for codes outside the ladder (the service answers those
    with a typed bad_class error frame instead of guessing)."""
    if code == CLASS_CODE_UNTAGGED:
        return None
    if 0 <= code < len(CLASS_ORDER):
        return CLASS_ORDER[code]
    raise ValueError(f"unknown qos class code {code}")


class TokenBucket:
    """Classic token bucket in signature units. ``rate`` <= 0 means
    unlimited (every take succeeds). Not thread-safe — callers hold the
    scheduler's admission lock."""

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = float(
            burst if burst is not None
            else max(1.0, self.rate * DEFAULT_TENANT_BURST_FACTOR)
        )
        self._clock = clock
        self._tokens = self.burst
        self._t_last = clock()

    def try_take(self, n: int) -> bool:
        if self.rate <= 0:
            return True
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._t_last) * self.rate
        )
        self._t_last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class TenantQuotas:
    """Per-tenant token buckets keyed by the subsystem origin tag — the
    same tenant identity the telemetry's RED metering buckets by, so the quota
    ledger and /debug/verify's per-tenant rates line up. rate 0 =
    quotas off (every admit succeeds, no buckets built)."""

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = burst
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def try_take(self, tenant: Optional[str], n: int) -> bool:
        if not self.enabled:
            return True
        key = tenant or TENANT_UNTAGGED
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = TokenBucket(self.rate, self.burst, self._clock)
            self._buckets[key] = bucket
        return bucket.try_take(n)


class BrownoutController:
    """Hysteretic demand shedding: on overload evidence (SLO burn past
    ``trip_burn``, or supervisor aggregate DEGRADED/BROKEN) disable the
    next class in the ladder (lowest priority first); after
    ``readmit_clears`` consecutive clean observations (burn below
    ``clear_burn`` AND supervisor healthy) re-admit the most recently
    disabled class. The gap between trip_burn and clear_burn plus the
    clear streak is the hysteresis — a burn hovering at the trip point
    cannot flap a class on and off every scrape.

    Observations arrive from two planes (the telemetry hub's burn
    watcher and the supervisor's state listener) plus the scheduler
    worker's poll; the controller keeps its own lock and never calls
    out under it, so it is safe to invoke from any of them.
    """

    def __init__(
        self,
        ladder: Sequence[str],
        trip_burn: float = 2.0,
        clear_burn: float = 1.0,
        readmit_clears: int = 3,
        step_cooldown_s: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
        on_change: Optional[Callable[[str, bool], None]] = None,
    ):
        # disable order: lowest priority first; block-policy classes
        # are excluded by the caller (they are who brownout protects)
        self._ladder = list(ladder)
        self._trip_burn = float(trip_burn)
        self._clear_burn = float(clear_burn)
        self._readmit_clears = max(1, int(readmit_clears))
        self._cooldown_s = float(step_cooldown_s)
        self._clock = clock
        self._on_change = on_change
        self._mtx = threading.Lock()
        self._disabled: List[str] = []  # stack: last disabled = first back
        self._last_burn = 0.0
        self._last_state = "healthy"
        self._clear_streak = 0
        self._t_last_step = float("-inf")
        self.trips = 0
        self.readmissions = 0

    def observe_burn(self, burn: float) -> None:
        with self._mtx:
            self._last_burn = float(burn)
            change = self._evaluate_locked()
        self._notify(change)

    def observe_state(self, state: str) -> None:
        with self._mtx:
            self._last_state = str(state)
            change = self._evaluate_locked()
        self._notify(change)

    def _evaluate_locked(self):
        now = self._clock()
        overloaded = (
            self._last_burn >= self._trip_burn
            or self._last_state in ("degraded", "broken")
        )
        clear = (
            self._last_burn < self._clear_burn
            and self._last_state == "healthy"
        )
        if overloaded:
            self._clear_streak = 0
            if (
                len(self._disabled) < len(self._ladder)
                and now - self._t_last_step >= self._cooldown_s
            ):
                cls = self._ladder[len(self._disabled)]
                self._disabled.append(cls)
                self._t_last_step = now
                self.trips += 1
                return (cls, True)
            return None
        if not clear:
            # between the thresholds: hold — neither escalate nor count
            # toward re-admission (the hysteresis band)
            self._clear_streak = 0
            return None
        self._clear_streak += 1
        if (
            self._disabled
            and self._clear_streak >= self._readmit_clears
            and now - self._t_last_step >= self._cooldown_s
        ):
            cls = self._disabled.pop()
            self._t_last_step = now
            self._clear_streak = 0
            self.readmissions += 1
            return (cls, False)
        return None

    def _notify(self, change) -> None:
        if change is None or self._on_change is None:
            return
        try:
            self._on_change(change[0], change[1])
        except Exception:  # noqa: BLE001 - observer is advisory
            pass

    def allows(self, cls: str) -> bool:
        with self._mtx:
            return cls not in self._disabled

    def disabled(self) -> List[str]:
        with self._mtx:
            return list(self._disabled)

    def snapshot(self) -> Dict[str, object]:
        with self._mtx:
            return {
                "disabled": list(self._disabled),
                "trips": self.trips,
                "readmissions": self.readmissions,
                "last_burn": round(self._last_burn, 4),
                "last_state": self._last_state,
                "clear_streak": self._clear_streak,
            }


class QoSMetrics:
    """The verify_qos_* family: per-class queue state and admission
    outcomes, per-tenant quota rejections, and the brownout ladder —
    wired into the node's Prometheus registry next to the scheduler's
    own instruments."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry if registry is not None else Registry()
        self.depth = r.gauge(
            QOS_SUBSYSTEM, "depth",
            "Requests waiting in each priority-class lane.",
        )
        self.pending_sigs = r.gauge(
            QOS_SUBSYSTEM, "pending_sigs",
            "Signatures waiting in each priority-class lane.",
        )
        self.admits = r.counter(
            QOS_SUBSYSTEM, "admits",
            "Requests admitted to a priority-class lane.",
        )
        self.sheds = r.counter(
            QOS_SUBSYSTEM, "sheds",
            "Requests refused lane admission by the class overload "
            "policy (shed = verified inline on the submitter's CPU; "
            "drop = completed with a rejected verdict).",
        )
        self.shed_sigs = r.counter(
            QOS_SUBSYSTEM, "shed_sigs",
            "Signatures carried by shed or dropped requests.",
        )
        self.quota_rejections = r.counter(
            QOS_SUBSYSTEM, "quota_rejections",
            "Submissions that exceeded their tenant's token-bucket "
            "quota (block-policy classes are still admitted and only "
            "counted here).",
        )
        self.brownouts = r.counter(
            QOS_SUBSYSTEM, "brownouts",
            "Brownout trips: a class disabled by the overload "
            "controller.",
        )
        self.readmits = r.counter(
            QOS_SUBSYSTEM, "readmits",
            "Brownout recoveries: a class hysteretically re-admitted.",
        )
        self.brownout_active = r.gauge(
            QOS_SUBSYSTEM, "brownout_active",
            "1 while a class is disabled by the brownout controller.",
        )

    @classmethod
    def nop(cls) -> "QoSMetrics":
        return cls(None)
