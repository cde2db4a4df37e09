"""Minimal Prometheus-compatible metrics core (reference:
cometbft_tpu/libs/metrics.py; the port's own copy).

The instruments, the registry with its v0.0.4 text exposition,
``MICRO_BUCKETS`` and ``global_registry`` are the reference's. Its
``MetricsServer`` (the /metrics and /debug HTTP endpoint, :296-411)
stands on ``libs/net.RouteServer`` and comes with the node (ROADMAP
A.6); until then a caller reads ``Registry.expose()`` itself.

Upstream model: the go-kit metrics interfaces the reference wraps
(libs in every engine's metrics.go) and the Prometheus text exposition
format served from node/node.go:1221. No external client library — the
three instrument kinds (Counter, Gauge, Histogram) and the v0.0.4 text
format are small enough to own, and owning them keeps the dependency
surface zero.

Usage:
    reg = Registry(namespace="cometbft")
    height = reg.gauge("consensus", "height", "Height of the chain.")
    height.set(42)
    text = reg.expose()   # Prometheus text format
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple


DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Latency buckets for the verify hot path. DEFAULT_BUCKETS starts at 5ms
# — chain-level timescales — so every sub-millisecond verify stage
# (coalesce wait, dispatch issue, per-chunk device wait) collapses into
# the first bucket. verify_* latency families use this µs-resolution
# ladder instead; it still reaches seconds for the watchdog tail.
MICRO_BUCKETS = (
    0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # v0.0.4: HELP text escapes backslash and newline (quotes stay raw).
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Instrument:
    """One named metric; label-value combinations are child series."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: Dict[str, str]):
        self.name = name
        self.help = help_
        self._labels = labels
        self._mtx = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], "_Instrument"] = {}

    def with_labels(self, **labels: str):
        """Child instrument with additional label values."""
        merged = dict(self._labels)
        merged.update({k: str(v) for k, v in labels.items()})
        key = tuple(sorted(merged.items()))
        with self._mtx:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help, merged)
                self._children[key] = child
            return child

    def _series(self) -> List["_Instrument"]:
        with self._mtx:
            children = list(self._children.values())
        out = [self]
        for c in children:
            out.extend(c._series())
        return out

    def _sample_lines(self) -> List[str]:
        raise NotImplementedError

    def _touched(self) -> bool:
        raise NotImplementedError

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        n = 0
        for series in self._series():
            if series._touched():
                lines.extend(series._sample_lines())
                n += 1
        return lines if n else []


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help_: str, labels: Dict[str, str]):
        super().__init__(name, help_, labels)
        self._value = 0.0
        self._used = False

    def add(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError("counters only go up")
        with self._mtx:
            self._value += delta
            self._used = True

    def value(self) -> float:
        with self._mtx:
            return self._value

    def _touched(self) -> bool:
        return self._used

    def _sample_lines(self) -> List[str]:
        return [
            f"{self.name}{_fmt_labels(self._labels)} "
            f"{_fmt_value(self.value())}"
        ]


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, help_: str, labels: Dict[str, str]):
        super().__init__(name, help_, labels)
        self._value = 0.0
        self._used = False

    def set(self, value: float) -> None:
        with self._mtx:
            self._value = float(value)
            self._used = True

    def add(self, delta: float = 1.0) -> None:
        with self._mtx:
            self._value += delta
            self._used = True

    def value(self) -> float:
        with self._mtx:
            return self._value

    def _touched(self) -> bool:
        return self._used

    def _sample_lines(self) -> List[str]:
        return [
            f"{self.name}{_fmt_labels(self._labels)} "
            f"{_fmt_value(self.value())}"
        ]


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        labels: Dict[str, str],
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_, labels)
        self._buckets = sorted(buckets)
        self._counts = [0] * (len(self._buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0

    def with_labels(self, **labels: str):
        merged = dict(self._labels)
        merged.update({k: str(v) for k, v in labels.items()})
        key = tuple(sorted(merged.items()))
        with self._mtx:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.name, self.help, merged, self._buckets)
                self._children[key] = child
            return child

    def observe(self, value: float) -> None:
        with self._mtx:
            self._counts[bisect_right(self._buckets, value)] += 1
            self._sum += value
            self._count += 1

    def _touched(self) -> bool:
        return self._count > 0

    def _sample_lines(self) -> List[str]:
        with self._mtx:
            counts = list(self._counts)
            total, sum_ = self._count, self._sum
        lines = []
        cumulative = 0
        for bound, c in zip(self._buckets, counts):
            cumulative += c
            labels = dict(self._labels)
            labels["le"] = _fmt_value(bound)
            lines.append(f"{self.name}_bucket{_fmt_labels(labels)} {cumulative}")
        labels = dict(self._labels)
        labels["le"] = "+Inf"
        lines.append(f"{self.name}_bucket{_fmt_labels(labels)} {total}")
        lines.append(
            f"{self.name}_sum{_fmt_labels(self._labels)} {_fmt_value(sum_)}"
        )
        lines.append(f"{self.name}_count{_fmt_labels(self._labels)} {total}")
        return lines


class Registry:
    """Namespace-scoped collection of instruments, exposable as text."""

    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._mtx = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _full_name(self, subsystem: str, name: str) -> str:
        parts = [p for p in (self.namespace, subsystem, name) if p]
        return "_".join(parts)

    def _register(self, inst: _Instrument) -> _Instrument:
        with self._mtx:
            existing = self._instruments.get(inst.name)
            if existing is not None:
                if type(existing) is not type(inst):
                    raise ValueError(
                        f"metric {inst.name} re-registered as a different kind"
                    )
                if isinstance(existing, Histogram) and (
                    existing._buckets != inst._buckets
                ):
                    # Silently returning the first registration would let
                    # two callers believe they picked the buckets; the
                    # second one's observations would land in a ladder it
                    # never asked for.
                    raise ValueError(
                        f"histogram {inst.name} re-registered with "
                        f"different buckets"
                    )
                return existing
            self._instruments[inst.name] = inst
            return inst

    def counter(self, subsystem: str, name: str, help_: str = "") -> Counter:
        return self._register(Counter(self._full_name(subsystem, name), help_, {}))

    def gauge(self, subsystem: str, name: str, help_: str = "") -> Gauge:
        return self._register(Gauge(self._full_name(subsystem, name), help_, {}))

    def histogram(
        self,
        subsystem: str,
        name: str,
        help_: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(
            Histogram(self._full_name(subsystem, name), help_, {}, buckets)
        )

    def expose(self) -> str:
        with self._mtx:
            instruments = sorted(
                self._instruments.values(), key=lambda i: i.name
            )
        lines: List[str] = []
        for inst in instruments:
            lines.extend(inst.expose())
        return "\n".join(lines) + ("\n" if lines else "")


_global_registry: Optional[Registry] = None
_global_mtx = threading.Lock()


def global_registry() -> Registry:
    global _global_registry
    with _global_mtx:
        if _global_registry is None:
            _global_registry = Registry()
        return _global_registry
