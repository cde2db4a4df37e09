"""The port's decision plane (cometbft_tpu_torch/crypto/decisions.py)
against the JAX package's (cometbft_tpu/crypto/decisions.py), on the CPU.

Synthetic decisions on an injected clock go through a ledger in each
package: the same flush sizes, priced menus (a stub cost profile and a
calibration seed), feasibility, taken and final routes, supervisor events
and walls. The records (all but their wall-clock stamp), the per-route
EWMA profiles, the windowed MAPE and regret, the time-series ring's
ledger columns, the anomaly watchdog's trips and re-arming with its
``on_anomaly`` calls, the counts and the exposition must be equal; so
must the thread-local ``use``/``current``/``note_*`` context, the knobs'
env precedence and ``calibration_seed_ms`` (None: no calibration table).

One test loops over every case (see tests/test_torch_field.py for why
each of these files holds one test).
"""

import os
import threading

import torch_plane as tp


class _Profile:
    def __init__(self, table):
        self.table = table

    def predict_ms(self, route, bucket):
        return self.table.get(route)


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


def ledger_walk(pkg):
    d = pkg.decisions
    t = [0.0]
    fires = []
    reg = pkg.metrics.Registry()
    led = d.DecisionLedger(
        window=d.MIN_TRIP_OBS, ring_interval_s=0.5, clock=lambda: t[0],
        cost_profile=_Profile({"single": 2.0, "indexed": 1.5}), metrics=d.Metrics(reg),
        on_anomaly=lambda cause, value: fires.append((cause, round(value, 6))),
        seed=lambda route, bucket: {"cpu": 40.0, "sharded": 9.0}.get(route),
    )
    script = []
    for i in range(d.MIN_TRIP_OBS + d.MIN_SELF_OBS):
        script.append((16 + i, "size", "single", None, [], 2.0 + 0.01 * i))
    script += [(64, "deadline", "cpu", None, ["cpu_fallback"], 30.0), (64, "explicit", "sharded", "single",
                                                                        ["sharded_fallback"], 11.0)]
    script += [(16, "size", "single", None, [], 60.0)] * 6  # a stale world: the watchdog trips once
    # back to the model, long enough for the ring (every third decision) to re-arm
    script += [(16, "size", "single", None, [], None)] * (3 * (d.MIN_TRIP_OBS + d.REARM_CLEAN) + 2)
    snaps = []
    for n, reason, taken, final, events, wall in script:
        t[0] += 0.2
        feasible = {"cpu": True, "single": True, "sharded": n >= 64, "indexed": n >= 64, "device_hash": False}
        dec = led.open(n=n, reason=reason, capacity=1.0, breakers={"dev0": "healthy"},
                       keystore={"entries": 1}, qos={"consensus": n}, feasible=feasible)
        with d.use(dec):
            assert d.current() is dec
            d.note_taken(taken)
            d.note_router("threshold")
            for ev in events:
                d.note_event(ev, final=final)
        assert d.current() is None
        if wall is None:
            wall = led.predict_ms(taken, n)
        led.finish(dec, wall / 1e3)
        snaps.append((led.windowed(), led.watchdog_state()))
    snap = led.snapshot()
    snap["recent"] = [_strip(r) for r in snap["recent"]]
    snap["ring"] = [{k: v for k, v in r.items() if k != "ts"} for r in snap["ring"]]
    return {"snaps": snaps, "snapshot": snap, "fires": fires, "counts": led.counts(),
            "predict": [led.predict_ms(r, b) for r in ("cpu", "single", "sharded", "indexed", "device_hash")
                        for b in (1, 16, 64, 1000)],
            "expose": reg.expose()}


def context(pkg):
    d = pkg.decisions
    out = []
    d.note_taken("single")  # no decision: no-ops
    d.note_event("x")
    out.append(d.current())
    led = d.DecisionLedger()
    outer, inner = led.open(n=3, reason="size"), led.open(n=5, reason="drain")
    seen = {}
    with d.use(outer):
        with d.use(inner):
            d.note_event("inner_ev", final="cpu")
            t = threading.Thread(target=lambda: seen.setdefault("other", d.current()))
            t.start()
            t.join()
        d.note_taken("sharded")
        out.append(d.current() is outer)
    with d.use(None):
        out.append(d.current())
    out.append((_strip(outer.as_dict()), _strip(inner.as_dict()), seen["other"], inner.diverted))
    return out


def knobs(pkg):
    d = pkg.decisions
    out = [d.decision_ledger_default(), d.decision_ledger_default(False), d.decision_window_default(),
           d.decision_window_default(32), d.decision_mape_trip_default(), d.decision_mape_trip_default(3.5)]
    for env, val in (("CBFT_DECISION_LEDGER", "0"), ("CBFT_DECISION_WINDOW", "9"), ("CBFT_DECISION_MAPE_TRIP", "1.25")):
        os.environ[env] = val
        try:
            out += [d.decision_ledger_default(True), d.decision_window_default(32), d.decision_mape_trip_default(3.5)]
        finally:
            del os.environ[env]
    prev = d.set_default_ledger(None)
    out.append((prev, d.default_ledger()))
    out.append([d.calibration_seed_ms(r, 16) for r in d.ROUTES])
    return out


def test_decisions_match_reference():
    tp.compare((ledger_walk, context, knobs))
    walk = ledger_walk(tp.PORT)
    assert walk["fires"] and walk["fires"][0][0] == "mape" and walk["snapshot"]["watchdog"]["trips"] == 1, walk["fires"]
    assert walk["snapshot"]["watchdog"]["tripped"] is None  # re-armed after the clean windows
