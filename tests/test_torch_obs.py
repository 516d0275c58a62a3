"""The port's observability core (``fedtpu_torch.obs``) against fedtpu's
(``fedtpu.obs``) on the same events, on the host.

The registry and its exporters must render the same Prometheus text byte
for byte: counters with labels (quotes and backslashes escaped), gauges,
histograms at the default buckets and at ``run_async``'s staleness bounds,
values on a bound, past the last one, negative, integers at and past
1e15, an empty histogram. ``snapshot()``, the parser (what it accepts and
what it rejects), the round-record writer and reader and the kind
collision follow. Then the telemetry modes, the flight recorder (ring,
dump keys and path, dumps on an exception in a thread and on SIGUSR1; each
installed recorder uninstalled) and the HTTP plane (routes, 404s,
``/healthz``'s 503 with its reason, a scrape that never raises). Mirrors
``tests/test_obs_exporters.py``, ``test_observability.py`` and
``test_obs_propagation.py``, which hold fedtpu to the same behaviour.
"""

import json
import logging
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import fedtpu.obs as jobs
import fedtpu_torch.obs as tobs

PACKAGES = pytest.mark.parametrize("obs", [jobs, tobs], ids=["fedtpu", "port"])
STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)


def _feed(obs):
    """One sequence of events into a fresh registry of ``obs``."""
    reg = obs.MetricsRegistry()
    reg.counter("fedtpu_rounds_completed_total", "rounds").inc(3)
    reg.counter("fedtpu_rpc_failures_total", "RpcErrors by failing RPC", labels={"rpc": "StartTrain"}).inc()
    reg.counter("fedtpu_rpc_failures_total", "RpcErrors by failing RPC", labels={"rpc": "SendModel"}).inc(2.5)
    reg.counter("fedtpu_odd_total", 'quote " and \\ slash', labels={"who": 'a"b\\c', "rpc": "x"}).inc(0.1)
    reg.counter("fedtpu_rpc_bytes_up_total").inc(10**15)
    reg.counter("fedtpu_rpc_bytes_up_total", labels={"codec": "topk"}).inc(10**15 - 1)
    reg.gauge("fedtpu_client_compression_ratio", "ratio").set(0.125)
    reg.gauge("fedtpu_neg").set(-7)
    reg.gauge("fedtpu_neg_frac").set(-3.25)
    reg.gauge("fedtpu_big").set(2.0**60)
    reg.gauge("fedtpu_inc").inc(4)
    h = reg.histogram("fedtpu_round_phase_seconds", "phases", labels={"phase": "decode"})
    for v in (0.001, 0.0005, 0.25, 2.5, 60.0, 61.0, -1.0, 1e-9, 0.1):
        h.observe(v)
    reg.histogram("fedtpu_round_phase_seconds", labels={"phase": "collect"}).observe(0.3)
    s = reg.histogram("fedtpu_async_staleness", "staleness", buckets=STALENESS_BUCKETS)
    for v in (0, 0, 1, 3, 64, 65, 7, -2):
        s.observe(v)
    reg.histogram("fedtpu_empty_seconds")
    return reg


def test_prometheus_text_and_snapshot_are_fedtpus_byte_for_byte(tmp_path):
    j, t = _feed(jobs), _feed(tobs)
    text = tobs.prometheus_text(t)
    assert text == jobs.prometheus_text(j)
    assert 'le="0.0"' in text and "fedtpu_rpc_bytes_up_total 1000000000000000.0\n" in text
    assert 'fedtpu_rpc_bytes_up_total{codec="topk"} 999999999999999\n' in text
    assert t.snapshot() == j.snapshot()
    jobs.write_prometheus(j, str(tmp_path / "j.prom"))
    tobs.write_prometheus(t, str(tmp_path / "t.prom"))
    assert (tmp_path / "t.prom").read_bytes() == (tmp_path / "j.prom").read_bytes()
    assert tobs.parse_prometheus_text(text) == jobs.parse_prometheus_text(text)
    assert tobs.parse_prometheus_text(text)["fedtpu_async_staleness_bucket"]['le=64.0'] == 7


@pytest.mark.parametrize("line", [
    "fedtpu_x 1", 'fedtpu_x{a="b"} 2.5', "fedtpu_x{} 3", "  # a comment", "",
    "fedtpu_x", "fedtpu_x 1 2", "9bad 1", 'fedtpu_x{a="b" 1', "fedtpu_x{a=b} 1",
    "fedtpu_x notanumber",
])
def test_parser_accepts_and_rejects_what_fedtpus_does(line):
    def parse(obs):
        try:
            return obs.parse_prometheus_text(line)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert parse(tobs) == parse(jobs)


def test_round_records_match_fedtpus_legacy_and_garbage_included(tmp_path):
    fields = [dict(loss=1.25, pipeline="stream", bytes_up=1024), dict(loss=0.5, alive=[True, False]),
              dict(note=None, acc=float("nan"))]
    out = {}
    for name, obs in (("j", jobs), ("t", tobs)):
        path = str(tmp_path / f"{name}.jsonl")
        with obs.RoundRecordWriter(path, echo=False) as w:
            for step, kw in enumerate(fields):
                w.log(step, **kw)
        with open(path, "a") as fh:
            fh.write('{"step": 9, "loss": 2.0}\nnot json at all\n[1, 2]\n{"truncated": \n')
        out[name] = [obs.read_round_records(path), tobs.read_round_records(path)]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"} for r in recs]
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 1
    j_by_j, t_by_j = out["j"][0], out["t"][0]
    assert json.dumps(strip(out["t"][1])) == json.dumps(strip(j_by_j)) == json.dumps(strip(t_by_j))
    assert [r["schema_version"] for r in out["t"][1]] == [1, 1, 1, 0]


@PACKAGES
def test_kind_collision_raises(obs):
    reg = obs.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered as counter, cannot re-register as gauge"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="increment must be >= 0"):
        reg.counter("x").inc(-1)
    assert reg.counter("x") is reg.counter("x", labels={})
    assert obs.get_global_registry() is obs.get_global_registry()


# -------------------------------------------------------------- telemetry
def test_telemetry_modes_gate_as_fedtpus(tmp_path):
    for obs in (jobs, tobs):
        off = obs.Telemetry("off")
        with off.span("x") as s:
            assert s.id is None
        off.counter("c").inc()
        off.gauge("g").set(1.0)
        off.histogram("h").observe(1.0)
        assert off.registry.snapshot() == {}
        basic = obs.Telemetry("basic", role="engine")
        basic.counter("c", "help c").inc(2)
        basic.histogram("h", buckets=STALENESS_BUCKETS).observe(3)
        with basic.span("x") as s:
            assert s.id is None
        assert basic.registry.snapshot()["c"][0]["value"] == 2
        basic.export_prometheus(str(tmp_path / f"{obs.__name__}.prom"))
        with pytest.raises(ValueError, match="telemetry"):
            obs.Telemetry("verbose")
        assert obs.NULL_TELEMETRY.enabled is False and obs.TELEMETRY_MODES == ("off", "basic", "trace")
    assert (tmp_path / "fedtpu_torch.obs.prom").read_bytes() == (tmp_path / "fedtpu.obs.prom").read_bytes()
    # trace runs since slice 8 part 5b (tests/test_torch_trace.py): the
    # tracer exists in trace mode only, and its spans take ids from 1.
    for obs in (jobs, tobs):
        traced = obs.Telemetry("trace", role="engine")
        assert traced.tracing and traced.tracer is not None and traced.enabled
        with traced.span("x", k=1) as s:
            assert s.id == 1
        assert [e["args"] for e in traced.trace_events()] == [{"span_id": 1, "k": 1}]
        assert obs.Telemetry("basic").tracer is None and not obs.Telemetry("basic").tracing


def test_obs_names_are_fedtpus_without_5b_and_5c():
    """The port exports fedtpu's names but the performance observatory's
    (item 5c); part 5b's tracer names are exported since it was ported."""
    not_yet = {"CaptureWindow", "CompileWatcher",
               "CostModel", "RoundProfiler", "analytic_flops", "device_peaks", "latency_summary",
               "parse_round_window", "roofline"}
    assert set(tobs.__all__) == set(jobs.__all__) - not_yet


# -------------------------------------------------------- flight recorder
@PACKAGES
def test_flight_recorder_ring_dump_keys_and_path(obs, tmp_path):
    fr = obs.FlightRecorder(capacity=3, role="client:127.0.0.1:5", artifacts_dir=str(tmp_path))
    for i in range(5):
        fr.record("tick", i=i)
    fr.record_span({"name": "round", "dur": 12, "args": {"round": 0}, "ph": "X"})
    assert [e.get("i") for e in fr.snapshot()] == [3, 4, None]
    assert fr.snapshot()[-1] == dict(fr.snapshot()[-1], kind="span", name="round", dur_us=12,
                                     args={"round": 0})
    path = fr.dump(reason="manual", extra={"note": 1})
    assert path == fr.dump_path() == os.path.join(
        str(tmp_path), f"flightrecorder-client-127.0.0.1-5-{os.getpid()}.json")
    doc = json.loads(open(path).read())
    assert set(doc) == {"reason", "role", "pid", "dumped_at", "recorder_started_at", "dump_count",
                        "num_events", "events", "note"}
    assert (doc["reason"], doc["num_events"], doc["dump_count"]) == ("manual", 3, 1)
    assert fr.dump(reason="again", path=str(tmp_path / "no" / "such" / "dir" / "f.json")) is not None
    blocker = tmp_path / "a-file"
    blocker.write_text("x")
    assert fr.dump(reason="unwritable", path=str(blocker / "f.json")) is None  # never raises


@PACKAGES
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_flight_recorder_dumps_on_an_exception_and_a_thread_crash(obs, tmp_path):
    fr = obs.FlightRecorder(role="crash", artifacts_dir=str(tmp_path))
    hooks = (sys.excepthook, threading.excepthook)
    fr.install(signum=None)
    try:
        fr.record("work", step=1)
        try:
            raise ValueError("injected boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        doc = json.loads(open(fr.dump_path()).read())
        assert doc["reason"] == "unhandled:ValueError"
        assert [e["kind"] for e in doc["events"]] == ["work", "exception"]
        assert "injected boom" in doc["events"][-1]["message"] and "traceback" in doc["events"][-1]
        os.remove(fr.dump_path())
        t = threading.Thread(target=lambda: 1 / 0, name="worker")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        doc = json.loads(open(fr.dump_path()).read())
        assert doc["reason"] == "thread-unhandled:ZeroDivisionError"
        assert doc["events"][-1]["thread"] == "worker"
        # Warning+ records of the package's loggers land in the ring.
        root = "fedtpu_torch" if obs is tobs else "fedtpu"
        logging.getLogger(root + ".ft").warning("client %s marked dead", "a")
        logging.getLogger(root + ".ft").info("not recorded")
        assert fr.snapshot()[-1]["message"] == "client a marked dead"
    finally:
        fr.uninstall()
    assert (sys.excepthook, threading.excepthook) == hooks


@PACKAGES
def test_flight_recorder_dumps_on_sigusr1(obs, tmp_path):
    fr = obs.FlightRecorder(role="sig", artifacts_dir=str(tmp_path))
    before = signal.getsignal(signal.SIGUSR1)
    fr.install()
    try:
        fr.record("before_signal")
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not os.path.exists(fr.dump_path()) and time.monotonic() < deadline:
            time.sleep(0.01)
        doc = json.loads(open(fr.dump_path()).read())
        assert doc["reason"] == "signal:SIGUSR1" and doc["events"][0]["kind"] == "before_signal"
    finally:
        fr.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == before


# ---------------------------------------------------------- status plane
def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def _status(url):
    try:
        return _get(url)
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def test_obs_server_routes_match_fedtpus(tmp_path):
    reg = {"j": _feed(jobs), "t": _feed(tobs)}
    healthy = [True]

    def health():
        return (True, "ok") if healthy[0] else (False, "fenced: stale coordinator pending re-base")

    def broken():
        raise RuntimeError("status source down")

    seen = {}
    for name, obs in (("j", jobs), ("t", tobs)):
        board = obs.StatusBoard(role="primary", phase="init", round=0)
        board.update(round=5, phase="collect")
        fr = obs.FlightRecorder(role="p", artifacts_dir=str(tmp_path))
        fr.record("round", round=4)
        servers = [
            obs.ObsServer(port=0, registry=reg[name], status_fn=board.snapshot, flight=fr,
                          health_fn=health).start(),
            obs.ObsServer(port=0, status_fn=broken).start(),
        ]
        try:
            full, bare = (s.url for s in servers)
            got = {p: _status(full + p) for p in ("/metrics", "/statusz", "/flightz", "/nope")}
            healthy[0] = False
            got["/healthz-fenced"] = _status(full + "/healthz?probe=1")
            healthy[0] = True
            got["/healthz"] = _status(full + "/healthz")
            got["bare"] = {p: _status(bare + p) for p in ("/healthz", "/metrics", "/flightz", "/statusz")}
            seen[name] = got
        finally:
            for s in servers:
                s.stop()
    j, t = seen["j"], seen["t"]
    assert t["/metrics"] == j["/metrics"] and t["/metrics"][1] == tobs.prometheus_text(reg["t"])
    assert t["/healthz"] == j["/healthz"] == (200, "ok\n")
    assert t["/healthz-fenced"] == j["/healthz-fenced"] == (503, "fenced: stale coordinator pending re-base\n")
    assert t["/nope"] == j["/nope"] == (404, "have: /metrics /healthz /statusz /flightz\n")
    assert t["bare"] == j["bare"]
    assert t["bare"]["/healthz"] == (200, "ok\n") and t["bare"]["/statusz"] == (500, "status source down\n")
    assert t["bare"]["/metrics"][0] == t["bare"]["/flightz"][0] == 404
    status = json.loads(t["/statusz"][1])
    assert (status["role"], status["round"], status["phase"]) == ("primary", 5, "collect")
    assert status["updated_at"] > 0
    assert [(e["kind"], e["round"]) for e in json.loads(t["/flightz"][1])] == [("round", 4)]


def test_process_observations_are_fedtpus():
    assert tobs.process_rss_bytes() > 0 and tobs.process_fd_count() > 0
    assert abs(tobs.process_fd_count() - jobs.process_fd_count()) <= 2
