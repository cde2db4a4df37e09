"""The verify plane of both packages side by side, for the port's
scheduler, supervisor, QoS, decision, topology and observability tests:
the reference's modules and the port's under the same names, seeded
Ed25519 items made in each package from the same secrets, fault-injected
supervisors over the same seeded FaultPlan, and a summary of a
supervisor's counters that both packages share.

The reference's side only ever runs on ``"cpu"`` or
``faults.install(inner="cpu")`` backends with an explicit
``topology.DeviceTopology.virtual(1)``: never its "tpu" backend, its AOT
registry, ``mesh.dispatch_batch`` or its key store.

Not a test module: tests/test_torch_{libs_obs,qos,decisions,topology,
supervisor,scheduler}.py import it.
"""

import itertools
import threading
import time
import types
from contextlib import contextmanager

from cometbft_tpu.crypto import batch as ref_batch
from cometbft_tpu.crypto import decisions as ref_decisions
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import faults as ref_faults
from cometbft_tpu.crypto import qos as ref_qos
from cometbft_tpu.crypto import scheduler as ref_scheduler
from cometbft_tpu.crypto import supervisor as ref_supervisor
from cometbft_tpu.crypto import telemetry as ref_telemetry
from cometbft_tpu.crypto.tpu import mesh as ref_mesh
from cometbft_tpu.crypto.tpu import topology as ref_topology
from cometbft_tpu.libs import log as ref_log
from cometbft_tpu.libs import metrics as ref_metrics
from cometbft_tpu.libs import service as ref_service
from cometbft_tpu.libs import trace as ref_trace
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import decisions as port_decisions
from cometbft_tpu_torch.crypto import ed25519 as port_ed
from cometbft_tpu_torch.crypto import faults as port_faults
from cometbft_tpu_torch.crypto import qos as port_qos
from cometbft_tpu_torch.crypto import scheduler as port_scheduler
from cometbft_tpu_torch.crypto import supervisor as port_supervisor
from cometbft_tpu_torch.crypto.cuda import mesh as port_mesh
from cometbft_tpu_torch.crypto.cuda import topology as port_topology
from cometbft_tpu_torch.libs import log as port_log
from cometbft_tpu_torch.libs import metrics as port_metrics
from cometbft_tpu_torch.libs import service as port_service
from cometbft_tpu_torch.libs import trace as port_trace

REF = types.SimpleNamespace(
    name="ref", batch=ref_batch, decisions=ref_decisions, ed=ref_ed, faults=ref_faults, qos=ref_qos,
    scheduler=ref_scheduler, supervisor=ref_supervisor, mesh=ref_mesh, topology=ref_topology,
    log=ref_log, metrics=ref_metrics, service=ref_service, trace=ref_trace,
)
PORT = types.SimpleNamespace(
    name="port", batch=port_batch, decisions=port_decisions, ed=port_ed, faults=port_faults, qos=port_qos,
    scheduler=port_scheduler, supervisor=port_supervisor, mesh=port_mesh, topology=port_topology,
    log=port_log, metrics=port_metrics, service=port_service, trace=port_trace,
)
BOTH = (REF, PORT)

# the port's plain-twin gpu verifier travels as a spec under this name
PLAIN = "gpu-plain"
_names = itertools.count()
_keys = {}


@contextmanager
def quiet_globals():
    """The reference's process-wide decision ledger and telemetry hub set
    to none for the block, as the port's are: other reference tests in
    the same worker process may leave theirs installed, and the
    reference's scheduler and decision ring read them."""
    prev_ledger = ref_decisions.set_default_ledger(None)
    prev_hub = ref_telemetry.set_default_hub(None)
    try:
        yield
    finally:
        ref_telemetry.set_default_hub(prev_hub)
        ref_decisions.set_default_ledger(prev_ledger)


def compare(cases):
    """Run each case in the reference and in the port, with the
    reference's process-wide planes quiet, and hold the results equal."""
    for case in cases:
        with quiet_globals():
            ref, port = case(REF), case(PORT)
        assert port == ref, (case.__name__, port, ref)


def register_plain():
    port_batch.register_backend(PLAIN, lambda: port_batch.GPUBatchVerifier(device="cpu"))


def key(pkg, secret: bytes):
    k = _keys.get((pkg.name, secret))
    if k is None:
        k = _keys[(pkg.name, secret)] = pkg.ed.gen_priv_key_from_secret(secret)
    return k


def make_items(pkg, n, tag=b"", poison=()):
    """n seeded (pub_key, msg, sig) triples in ``pkg``'s own types; the
    lanes in ``poison`` carry a zero signature."""
    items = []
    for i in range(n):
        k = key(pkg, b"plane-" + tag + bytes([i & 0xFF, i >> 8]))
        msg = b"plane-msg-" + tag + i.to_bytes(4, "big")
        sig = b"\x00" * 64 if i in poison else k.sign(msg)
        items.append((k.pub_key(), msg, sig))
    return items


def cpu_mask(pkg, items):
    bv = pkg.batch.CPUBatchVerifier()
    for it in items:
        bv.add(*it)
    return bv.verify()[1]


def faulty(pkg, plan_kw=None, seed=1, inner="cpu", **sup_kw):
    """A FaultyBackend registered under a fresh name over ``inner`` and
    a supervisor over it on one virtual fault domain."""
    name = f"plane-faulty-{pkg.name}-{next(_names)}"
    plan = pkg.faults.install(name=name, inner=inner, plan=pkg.faults.FaultPlan(seed=seed, **(plan_kw or {})))
    sup_kw.setdefault("dispatch_timeout_ms", 5000)
    sup_kw.setdefault("breaker_threshold", 3)
    sup_kw.setdefault("audit_pct", 0)
    sup_kw.setdefault("probe_base_ms", 60_000)
    sup_kw.setdefault("probe_max_ms", 480_000)
    sup_kw.setdefault("hedge_pct", 0)
    sup_kw.setdefault("retry_ms", 1)
    sup_kw.setdefault("topology", pkg.topology.DeviceTopology.virtual(1))
    sup = pkg.supervisor.BackendSupervisor(spec=pkg.batch.BackendSpec(name), **sup_kw)
    return plan, sup


def total(counter) -> float:
    """A counter summed over its labelled series."""
    return sum(c.value() for c in counter._series())


def labelled(counter) -> dict:
    """{labels: value} of a counter's labelled children."""
    out = {}
    for c in counter._series():
        labels = tuple(sorted(getattr(c, "_labels", {}).items()))
        if labels:
            out[labels] = c.value()
    return out


COUNTERS = (
    "trips", "probes", "audits", "audit_mismatches", "audit_drops", "watchdog_kills", "failures",
    "device_dispatches", "cpu_routed", "retries", "hedge_fires", "hedge_wins", "hedge_divergence",
    "chunk_shrinks", "chunk_recoveries", "triage_runs", "triage_passes", "triage_offenders",
    "triage_divergence", "triage_cpu_fallbacks", "quarantines", "readmissions", "redistributions",
    "indexed_dispatches", "indexed_fallbacks", "sharded_fallbacks",
)


def sup_summary(sup) -> dict:
    """The supervisor's state and every counter both packages keep, by
    label, and the chunk-cap gauge."""
    m = sup.metrics
    out = {"state": sup.state(), "devices": sup.device_states(), "chunk_cap": m.chunk_cap.value()}
    for name in COUNTERS:
        c = getattr(m, name)
        out[name] = (c.value(), labelled(c))
    return out


def wait_for(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def live_threads(name: str) -> int:
    return sum(1 for t in threading.enumerate() if t.name == name and t.is_alive())
