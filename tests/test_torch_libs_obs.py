"""The port's observability libraries (cometbft_tpu_torch/libs/log.py,
service.py, metrics.py, trace.py) against the JAX package's
(cometbft_tpu/libs/), on the CPU.

* log: the same calls through a Logger with bound context and
  per-module levels write the same lines, timestamps aside;
  ``parse_log_level`` and the no-op logger agree;
* service: start, stop, reset and their errors in the same order, the
  hooks called the same number of times;
* metrics: counters, gauges and histograms (``MICRO_BUCKETS`` among them)
  with labels give the same text exposition; ``global_registry`` is one
  registry;
* trace: a span tree built across threads with ``use`` and
  ``child_of_current``, its flight recorder and ``chrome_trace`` agree
  modulo ids and times; so do the span trees of a supervised dispatch,
  whose ``device`` span is opened on the calling thread and installed in
  the dispatch thread (a span the wrapped backend opens there is its
  child), and the counts ``attach_stage_metrics`` records.

One test loops over every case (see tests/test_torch_field.py for why
each of these files holds one test).
"""

import io
import re
import threading

import torch_plane as tp


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def logs(pkg):
    lg = pkg.log
    sink = io.StringIO()
    levels = lg.parse_log_level("consensus:error,p2p:debug,*:info")
    root = lg.Logger(sink, lg.LEVEL_DEBUG, module_levels=levels)
    for logger in (root, root.with_(module="consensus"), root.with_(module="p2p", peer="ab"), root.with_(module="other")):
        logger.debug("dbg", n=1)
        logger.info("inf", height=5, ok=True)
        logger.error("err", err="boom")
    lg.new_nop_logger().error("never")
    quiet = io.StringIO()
    lg.Logger(quiet, lg.LEVEL_ERROR).info("filtered")
    return {"lines": re.sub(r"\[[0-9T:\-]+\]", "[ts]", sink.getvalue()).splitlines(), "quiet": quiet.getvalue(),
            "levels": levels, "bad": _outcome(lambda: lg.parse_log_level("x:loud")),
            "default": lg.parse_log_level("", default="error")}


def services(pkg):
    calls = []

    class Svc(pkg.service.BaseService):
        def on_start(self):
            calls.append("start")

        def on_stop(self):
            calls.append("stop")

        def on_reset(self):
            calls.append("reset")

    s = Svc("svc")
    steps = [_outcome(s.stop), _outcome(s.reset), _outcome(s.start), s.is_running(), _outcome(s.start),
             _outcome(s.stop), s.is_running(), s.quit_event().is_set(), _outcome(s.stop), _outcome(s.start),
             _outcome(s.reset), _outcome(s.start), s.is_running(), s.wait(0.01), _outcome(s.stop), str(s)]
    return {"steps": [(x[0], type(x[1]).__name__) if isinstance(x, tuple) else x for x in steps], "calls": calls}


def metrics(pkg):
    m = pkg.metrics
    reg = m.Registry(namespace="cometbft")
    c = reg.counter("verify", "requests", "Requests.")
    c.add()
    c.with_labels(subsystem="consensus").add(3)
    c.with_labels(subsystem="blocksync").add(2.5)
    g = reg.gauge("verify", "depth", 'Depth "now"\\n.')
    g.set(4)
    g.with_labels(qclass="light").set(-1.5)
    h = reg.histogram("verify", "wait_seconds", "Waits.", buckets=m.MICRO_BUCKETS)
    for v in (0.000001, 0.00003, 0.0007, 0.02, 3.0):
        h.observe(v)
    h2 = reg.histogram("verify", "size", "Sizes.", buckets=(1, 10, 100))
    h2.with_labels(route="single").observe(50)
    reg.gauge("verify", "untouched", "Never set.")
    return {"text": reg.expose(), "buckets": m.MICRO_BUCKETS, "default": m.DEFAULT_BUCKETS,
            "global": m.global_registry() is m.global_registry(), "values": (c.value(), g.value())}


def _tree(trace):
    spans = trace["spans"]
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"]), sorted((k, str(v)) for k, v in s["tags"].items()
                                                          if k not in ("wait_us",))) for s in spans]


def _chrome(doc):
    events = []
    for ev in doc["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur")}
        args = dict(ev.get("args", {}))
        args.pop("span_id", None)
        args.pop("parent_id", None)
        if ev["ph"] == "M":
            args = {}
        ev["args"] = sorted(args.items())
        events.append(ev)
    return events


def traces(pkg):
    tr = pkg.trace
    tracer = tr.Tracer(sample=1.0, seed=5, buffer=8)
    root = tracer.start_span("request", n_sigs=3)
    with tr.use(root):
        disp = tracer.span("dispatch", reason="size")
        with tr.use(disp):
            with tr.child_of_current("cpu", n_sigs=3):
                pass
            hop = tr.child_of_current("device", n_sigs=3)

            def worker():
                with tr.use(hop):
                    tr.child_of_current("chunk", index=0).end(lanes=3)
                hop.end(outcome="ok")

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        disp.end(route="single")
    assert tr.current_span() is None and tr.child_of_current("x") is tr.NOOP_SPAN
    root.end(ok=True)
    late = disp.child("straggler")
    late.end()  # after the root: dropped
    off = tr.Tracer(sample=0.0)
    assert off.start_span("r") is tr.NOOP_SPAN
    recent = tracer.recent()
    return {"trees": [_tree(t) for t in recent], "chrome": _chrome(tr.chrome_trace(recent)),
            "counts": (tracer.n_started, tracer.n_completed), "roots": [t["root"] for t in recent]}


def supervised(pkg):
    """The supervisor's spans across its dispatch thread."""
    tr = pkg.trace

    class Traced(pkg.batch.CPUBatchVerifier):
        def verify(self):
            with tr.child_of_current("inner", thread=threading.current_thread().name):
                return super().verify()

    name = "plane-traced"  # each package's own registry
    pkg.batch.register_backend(name, Traced)
    tracer = tr.Tracer(sample=1.0, seed=6)
    reg = pkg.metrics.Registry()
    tr.attach_stage_metrics(tracer, reg)
    sup = pkg.supervisor.BackendSupervisor(
        spec=pkg.batch.BackendSpec(name), audit_pct=100, audit_sync=True, hedge_pct=0, tracer=tracer,
        topology=pkg.topology.DeviceTopology.virtual(1),
    )
    items = tp.make_items(pkg, 4, b"trace", poison=(2,))
    sup.verify_items(items, reason="size")
    sup.stop()
    counts = sorted(line for line in reg.expose().splitlines() if "_count" in line)
    return {"trees": [_tree(t) for t in tracer.recent()], "counts": counts}


def test_libs_obs_match_reference():
    tp.compare((logs, services, metrics, traces, supervised))
    tree = supervised(tp.PORT)["trees"][0]
    inner = [t for t in tree if t[0] == "inner"]
    assert inner and all(t[1] == "device" and ("thread", "supervised-dispatch") in t[2] for t in inner), tree
