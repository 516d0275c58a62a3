"""The port's performance observatory (``fedtpu_torch/obs/profile.py``)
against fedtpu's (``fedtpu/obs/profile.py``) on the same inputs, on the
CPU.

The pure parts give fedtpu's outputs: ``roofline``, ``CostModel``,
``latency_summary``, ``parse_round_window`` (its messages too),
``device_peaks`` under fedtpu's overrides, and ``RoundProfiler``'s three
gauges as byte-equal Prometheus text after fedtpu's observations
(``tests/test_perf_obs.py``). The counts: ``analytic_flops`` on a matmul
and on plain, grouped and depthwise convolutions with their gradients,
``analytic_bytes`` on a matmul, and the engine's cost model on fedtpu's
seconds-scale MLP config, fedtpu's figure at one local step and twice it at
two (fedtpu counts its local-step scan once). Accounting leaves the next
round bit-equal; ``run()``'s records and ``/statusz`` carry the MFU.
The compile watcher counts the kernel builds (``kernels.build`` with
``nvcc`` stubbed by a script that writes its output file). A capture
window on the CPU opens and closes on fedtpu's rounds and writes a trace
that ``tools/trace_merge.py`` reads against its sidecar. fedtpu's engine
is only traced (``xla_check=False``); nothing of fedtpu is compiled.
"""

import json
import stat
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.core.engine import Federation as JFederation
from fedtpu.obs import Telemetry as JTelemetry
from fedtpu.obs import profile as jprofile
from fedtpu.obs import prometheus_text as jprometheus_text
from fedtpu_torch import config as tconfig
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.obs import FlightRecorder, Telemetry, prometheus_text
from fedtpu_torch.obs import profile as tprofile
from fedtpu_torch.ops import kernels
from fedtpu_torch.sim.engine import SimFederation

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import trace_merge  # noqa: E402


@pytest.fixture(autouse=True)
def no_peak_overrides(monkeypatch):
    monkeypatch.delenv("FEDTPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("FEDTPU_PEAK_HBM_BYTES", raising=False)


# --------------------------------------------------------- the pure parts
@pytest.mark.parametrize("args", [
    (1e12, 1e9, 2e14, 1e12, 1e14),
    (1e10, 1e9, 2e14, 1e13, 1e12),
    (1e10, 1e9, 2e14, 1e13, None),
    (1e10, None, 2e14, 1e13, 1e12),
    (None, 1e9, 2e14, 1e13, 1e12),
    (1e10, 1e9, None, 1e13, 1e12),
    (2e10, 1e9, 989e12, 3.35e12, 0.0),
], ids=["compute", "bandwidth", "no-rate", "no-bytes", "no-flops", "no-peak", "zero-rate"])
def test_roofline_equals_fedtpus(args):
    assert tprofile.roofline(*args) == jprofile.roofline(*args)


@pytest.mark.parametrize("kw", [
    dict(xla_flops=1e10, xla_bytes=1e9, analytic=1.02e10),
    dict(xla_flops=None, xla_bytes=None, analytic=5e9),
    dict(xla_flops=None, xla_bytes=None, analytic=5e9, analytic_bytes=8e8),
    dict(xla_flops=0.0, xla_bytes=0.0, analytic=None),
], ids=["xla", "analytic", "analytic-bytes", "empty"])
def test_cost_model_equals_fedtpus(kw):
    t, j = tprofile.CostModel(**kw), jprofile.CostModel(**kw)
    assert (t.flops, t.source, t.agreement, t.as_dict()) == (j.flops, j.source, j.agreement, j.as_dict())


def test_latency_summary_equals_fedtpus():
    cases = [
        [],
        [(f"c{i}", (i + 1) / 100.0) for i in range(100)],
        [("a", 0.2), ("b", 0.7)],
        [("x", 0.1234567891), ("y", 0.1234567891), ("z", 3.0)],
    ]
    for pairs in cases:
        for k in (1, 3, 5):
            assert tprofile.latency_summary(pairs, top_k=k) == jprofile.latency_summary(pairs, top_k=k)


def test_device_peaks_overrides_equal_fedtpus_and_the_h100_row(monkeypatch):
    for kind in ("cpu", "", "NVIDIA H100 80GB HBM3"):
        want = jprofile.device_peaks(kind) if kind in ("cpu", "") else (989e12, 3.35e12)
        assert tprofile.device_peaks(kind) == want
    # The port's table holds no TPU: fedtpu's TPU figures are not the port's.
    assert jprofile.device_peaks("TPU v5 lite") == (197e12, 819e9)
    assert tprofile.device_peaks("TPU v5 lite") == (None, None)
    monkeypatch.setenv("FEDTPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("FEDTPU_PEAK_HBM_BYTES", "5e10")
    for kind in ("cpu", "TPU v4", "NVIDIA H100 80GB HBM3"):
        assert tprofile.device_peaks(kind) == jprofile.device_peaks(kind) == (1e12, 5e10)
    monkeypatch.setenv("FEDTPU_PEAK_FLOPS", "not-a-number")
    assert tprofile.device_peaks("NVIDIA H100 80GB HBM3")[0] == 989e12
    assert tprofile.device_peaks("cpu") == jprofile.device_peaks("cpu") == (None, 5e10)


def _observe(profile, telemetry):
    """fedtpu's RoundProfiler case (tests/test_perf_obs.py) on one package."""
    prof = profile.RoundProfiler(telemetry, n_devices=2, device_kind="cpu")
    seen = [prof.observe_round(0.5), prof.record_fields()]
    prof.set_cost_model(profile.CostModel(xla_flops=1e10, xla_bytes=1e9, analytic=1.01e10))
    seen += [prof.observe_round(0.5, rounds=5), prof.record_fields(), prof.snapshot()]
    return seen


def test_round_profiler_text_fields_and_snapshot_equal_fedtpus(monkeypatch):
    monkeypatch.setenv("FEDTPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("FEDTPU_PEAK_HBM_BYTES", "5e10")
    ttel, jtel = Telemetry("basic"), JTelemetry("basic")
    tseen, jseen = _observe(tprofile, ttel), _observe(jprofile, jtel)
    assert tseen == jseen
    assert tseen[-1]["mfu"] == pytest.approx(0.05) and tseen[-1]["roofline_utilization"] == pytest.approx(0.1)
    assert prometheus_text(ttel.registry) == jprometheus_text(jtel.registry)
    assert "fedtpu_mfu_ratio 0.05" in prometheus_text(ttel.registry)
    # Without XLA bytes the port's roofline reads the analytic bytes, where
    # fedtpu's has no intensity: the port's cost model has no XLA figure.
    cost = dict(xla_flops=None, xla_bytes=None, analytic=1e10, analytic_bytes=1e9)
    snaps = []
    for profile in (tprofile, jprofile):
        prof = profile.RoundProfiler(Telemetry("off"), device_kind="cpu")
        prof.set_cost_model(profile.CostModel(**cost))
        prof.observe_round(0.1)
        snaps.append(prof.snapshot())
    assert snaps[0]["arith_intensity_flops_per_byte"] == 10.0 and snaps[0]["roofline_bound"] == "bandwidth"
    assert snaps[1]["arith_intensity_flops_per_byte"] is None
    roof = {k for k in snaps[0] if k.startswith(("arith", "ridge", "roofline"))}
    assert {k: v for k, v in snaps[0].items() if k not in roof} == {k: v for k, v in snaps[1].items() if k not in roof}


# ------------------------------------------------------------- the counts
def _conv_pair(groups, cin, cout, rng):
    x = rng.normal(size=(2, 9, 9, cin)).astype(np.float32)
    w = rng.normal(size=(3, 3, cin // groups, cout)).astype(np.float32)

    def jconv(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            feature_group_count=groups)

    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_(True)

    def tconv(x, w):
        return torch.nn.functional.conv2d(x, w, padding=1, groups=groups)

    return (jconv, x, w), (tconv, tx, tw)


@pytest.mark.parametrize("groups,cin,cout", [(1, 3, 8), (4, 8, 8), (8, 8, 16)], ids=["plain", "grouped", "depthwise"])
def test_analytic_flops_of_convolutions_and_gradients_equal_fedtpus(groups, cin, cout):
    (jconv, x, w), (tconv, tx, tw) = _conv_pair(groups, cin, cout, np.random.default_rng(groups))
    assert tprofile.analytic_flops(tconv, tx, tw) == jprofile.analytic_flops(jconv, x, w)
    jgrad = jax.grad(lambda x, w: jconv(x, w).sum(), argnums=(0, 1))
    assert tprofile.analytic_flops(lambda: torch.autograd.grad(tconv(tx, tw).sum(), (tx, tw))) == (
        jprofile.analytic_flops(jgrad, x, w))
    jgrad_w = jax.grad(lambda w, x: jconv(x, w).sum())
    assert tprofile.analytic_flops(lambda: torch.autograd.grad(tconv(tx, tw).sum(), tw)) == (
        jprofile.analytic_flops(jgrad_w, w, x))


def test_analytic_flops_and_bytes_of_a_matmul_equal_fedtpus():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(16, 32)).astype(np.float32), rng.normal(size=(32, 8)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert tprofile.analytic_flops(torch.mm, ta, tb) == jprofile.analytic_flops(jnp.dot, a, b) == 2 * 16 * 32 * 8
    assert tprofile.analytic_bytes(torch.mm, ta, tb) == jprofile.analytic_bytes(jnp.dot, a, b) == 4 * (16 * 32 + 32 * 8 + 16 * 8)
    # Views are free; eager mode fuses nothing, so an elementwise chain
    # costs each op its reads and writes, where fedtpu charges one pass.
    assert tprofile.analytic_bytes(lambda x: x.reshape(-1).view(32, 16).t()[1:], ta) == 0
    chain = 4 * 16 * 32
    assert jprofile.analytic_bytes(lambda x: jnp.tanh(x * 2 + 1), a) == 2 * chain
    assert tprofile.analytic_bytes(lambda x: torch.tanh(x * 2 + 1), ta) == 6 * chain


def _mlp(mod, steps, **fed_kw):
    """fedtpu's seconds-scale engine config (tests/test_perf_obs.py)."""
    return mod.RoundConfig(
        model="mlp", num_classes=10,
        data=mod.DataConfig(dataset="synthetic", batch_size=8, num_examples=64),
        fed=mod.FedConfig(num_clients=2, num_rounds=2, telemetry="basic", **fed_kw),
        steps_per_round=steps,
    )


@pytest.fixture(scope="module")
def accounted():
    """A port engine with accounting armed and its twin without."""
    fed = TFederation(_mlp(tconfig, 1), seed=0, device="cpu")
    fed.enable_mfu_accounting(xla_check=False)
    return fed, TFederation(_mlp(tconfig, 1), seed=0, device="cpu")


@pytest.mark.parametrize("steps", [1, 2])
def test_engine_flops_per_round_is_fedtpus_per_local_step(steps, accounted):
    """fedtpu counts its local-step scan once; the port counts each step."""
    want = jprofile.engine_cost_model(JFederation(_mlp(jconfig, steps), seed=0), xla_check=False)
    port = accounted[0] if steps == 1 else TFederation(_mlp(tconfig, steps), seed=0, device="cpu")
    cost = tprofile.engine_cost_model(port, xla_check=False) if steps == 2 else port.profiler.cost
    assert cost.flops == steps * want.flops == steps * 50_577_408
    assert (cost.source, cost.xla_flops, cost.xla_bytes) == ("analytic", None, None) == (
        want.source, want.xla_flops, want.xla_bytes)
    assert set(cost.as_dict()) == set(want.as_dict())
    assert cost.analytic_bytes > want.analytic_bytes  # eager moves every intermediate


def test_accounting_leaves_the_next_round_bit_equal(accounted):
    fed, twin = accounted
    assert fed.state.round_idx == twin.state.round_idx == 0
    assert torch.equal(fed._generator.get_state(), twin._generator.get_state())
    m, mt = fed.step(), twin.step()
    for name in fed.state.params:
        assert torch.equal(fed.state.params[name], twin.state.params[name]), name
        assert torch.equal(fed.state.opt_state[name], twin.state.opt_state[name]), name
    assert all(torch.equal(a, b) for a, b in zip(m, mt))
    assert fed.profiler.snapshot()["rounds_observed"] == 1
    assert "perf" not in twin.status_snapshot()


def test_run_records_and_statusz_carry_mfu(monkeypatch, accounted):
    monkeypatch.setenv("FEDTPU_PEAK_FLOPS", "1e12")
    fed = TFederation(_mlp(tconfig, 1), seed=0, device="cpu")
    prof = fed.enable_mfu_accounting(xla_check=False)
    assert fed.enable_mfu_accounting() is prof and prof.cost.flops == accounted[0].profiler.cost.flops
    recs = []

    class Recorder:
        def log(self, r, **rec):
            recs.append(rec)

    fed.run(num_rounds=2, logger=Recorder())
    assert len(recs) == 2
    for rec in recs:
        assert rec["mfu"] > 0 and rec["achieved_flops_per_s"] > 0
        assert rec["achieved_flops_per_s"] * rec["round_s"] == pytest.approx(prof.cost.flops, rel=0.2)
    watcher = tprofile.CompileWatcher()
    fed.compile_watcher = watcher
    snap = fed.status_snapshot()
    assert snap["perf"]["mfu"] > 0 and snap["perf"]["flops_per_round"] == prof.cost.flops
    assert snap["perf"]["device_kind"] == "cpu" and snap["perf"]["rounds_observed"] == 2
    assert snap["compile"] == watcher.snapshot()
    fused = fed.run_on_device(2)
    assert fused.loss.shape == (2,) and prof.snapshot()["rounds_observed"] == 4
    assert SimFederation.enable_mfu_accounting is TFederation.enable_mfu_accounting


# ------------------------------------------------------ compile watcher
def test_compile_watcher_counts_flags_steady_builds_and_guards(tmp_path):
    tel = Telemetry("basic")
    flight = FlightRecorder(role="test", artifacts_dir=str(tmp_path))
    watcher = tprofile.CompileWatcher(telemetry=tel, flight=flight)
    tprofile.report_build(9.0, "nobody")  # no watcher installed: dropped
    watcher.install()
    try:
        assert watcher.install() is watcher
        with pytest.raises(RuntimeError):
            tprofile.CompileWatcher().install()
        tprofile.report_build(1.5, "threshold_feedback")
        tprofile.report_build(0.25, "hadamard_rotate")
        assert watcher.snapshot() == {"compiles": 2, "compile_seconds": 1.75, "steady": False,
                                      "recompiles_after_steady": 0}
        watcher.mark_steady()
        assert watcher.steady and flight.snapshot() == []
        tprofile.report_build(2.0, "quantdequant_int8")
        assert watcher.snapshot() == {"compiles": 3, "compile_seconds": 3.75, "steady": True,
                                      "recompiles_after_steady": 1}
        (event,) = flight.snapshot()
        assert {k: event[k] for k in ("kind", "duration_s", "compiles_total", "kernel")} == {
            "kind": "xla_recompile", "duration_s": 2.0, "compiles_total": 3, "kernel": "quantdequant_int8"}
        text = prometheus_text(tel.registry)
        assert "fedtpu_xla_compiles_total 3" in text and "fedtpu_xla_recompiles_steady_total 1" in text
        assert 'fedtpu_xla_compile_seconds_count 3' in text
    finally:
        watcher.uninstall()
    tprofile.report_build(1.0)
    assert watcher.snapshot()["compiles"] == 3
    other = tprofile.CompileWatcher().install()
    other.uninstall()


def test_build_reports_each_compiled_library_to_the_watcher(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\necho stub\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    watcher = tprofile.CompileWatcher(telemetry=Telemetry("basic")).install()
    try:
        logs = kernels.build()
        assert sorted(logs) == sorted(kernels.KERNELS) and set(logs.values()) == {"stub\n"}
        assert all(kernels.library_path(name).exists() for name in kernels.KERNELS)
        snap = watcher.snapshot()
        assert snap["compiles"] == len(kernels.KERNELS) and snap["compile_seconds"] > 0
        watcher.mark_steady()
        assert kernels.build() == {} and watcher.snapshot()["compiles"] == len(kernels.KERNELS)
        kernels.library_path("hadamard_rotate").unlink()
        assert list(kernels.build()) == ["hadamard_rotate"]
        assert watcher.snapshot()["recompiles_after_steady"] == 1
    finally:
        watcher.uninstall()


# ------------------------------------------------------ capture windows
@pytest.mark.parametrize("spec", ["3:7", "5", " 0:2 ", "", "a:b", "4:", "7:3", "-1:2", "2:2"])
def test_parse_round_window_equals_fedtpus(spec):
    try:
        want = jprofile.parse_round_window(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tprofile.parse_round_window(spec)
        assert str(got.value) == str(e)
    else:
        assert tprofile.parse_round_window(spec) == want


class _FakeTrace:
    def __init__(self, _dir):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def test_capture_window_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(jax.profiler, "trace", _FakeTrace)
    blocks = [(0, 0), (1, 2), (3, 3), (4, 4), (5, 6), (7, 7)]
    twin = jprofile.CaptureWindow("2:5", str(tmp_path / "jax"))
    window = tprofile.CaptureWindow("2:5", str(tmp_path / "port"), role="engine", trace_id="abc123", device="cpu")
    x = torch.ones(64, 64)
    opened = []
    for lo, hi in blocks:
        for w in (twin, window):
            w.maybe_start(lo, hi)
        assert window.active == twin.active
        opened.append(window.active)
        x = x @ x / 64
        for w in (twin, window):
            w.maybe_stop(hi + 1)
        assert window.active == twin.active
    assert opened == [False, True, True, True, False, False]
    window.stop()
    window.stop()
    jmeta = json.loads((tmp_path / "jax" / "profile_meta.json").read_text())
    meta = json.loads((tmp_path / "port" / "profile_meta.json").read_text())
    assert set(meta) == set(jmeta) and jmeta["format"] == "jax.profiler"
    assert (meta["role"], meta["trace_id"], meta["format"], meta["round_window"]) == (
        "engine", "abc123", "torch.profiler", [2, 5])
    path = tprofile.find_device_trace(str(tmp_path / "port"))
    assert path == window.path and path.endswith(".trace.json")
    assert Path(path).relative_to(tmp_path / "port").parts[:2] == ("plugins", "profile")
    doc = trace_merge.load_device_trace(str(tmp_path / "port"))
    assert doc["metadata"]["wall_start"] == meta["wall_start"] and doc["metadata"]["role"] == "engine"
    ((lane, ops),) = trace_merge.extract_device_lanes(doc)
    assert lane == "/device:CPU:0" and any(e["name"] == "aten::mm" for e in ops)
    assert min(e["ts"] for e in ops) >= 0 and tprofile._OPEN_MARK not in {e["name"] for e in ops}
    if not torch.cuda.is_available():  # a capture runs on the card unless told otherwise
        with pytest.raises(RuntimeError, match="needs a card"):
            tprofile.CaptureWindow("0", str(tmp_path / "cuda")).maybe_start(0)


def test_a_captured_round_merges_onto_the_engines_spans(tmp_path, capsys):
    fed = TFederation(_mlp(tconfig, 1), seed=0, device="cpu")
    fed.telemetry = Telemetry("trace", role="engine")
    window = tprofile.CaptureWindow("1:2", str(tmp_path / "capture"), role="engine",
                                    trace_id=fed.telemetry.tracer.trace_id, device="cpu")
    for r in range(3):
        window.maybe_start(r)
        fed.step()
        window.maybe_stop(r + 1)
    window.stop()
    fed.telemetry.export_trace(str(tmp_path / "engine.json"))
    out = str(tmp_path / "merged.json")
    rc = trace_merge.main([str(tmp_path / "engine.json"), "--device-trace", str(tmp_path / "capture"), "-o", out,
                           "--check"])
    # An engine has no clients: the client-span check is the one problem.
    problems = [line for line in capsys.readouterr().err.splitlines() if line.startswith("CHECK FAILED")]
    assert (rc, problems) == (1, ["CHECK FAILED: no client_train spans in merged trace"])
    merged = json.loads(Path(out).read_text())
    rounds = {e["args"]["round"]: e for e in merged["traceEvents"] if e.get("name") == "round" and "args" in e
              and "round" in e["args"]}
    ops = [e for e in merged["traceEvents"] if e.get("cat") == "device"]
    lo, hi = rounds[1]["ts"], rounds[1]["ts"] + rounds[1]["dur"]
    assert sorted(rounds) == [0, 1, 2] and merged["metadata"]["device_lanes"] == ["device:/device:CPU:0 (engine)"]
    assert any(e["name"] == "aten::bmm" and lo <= e["ts"] <= e["ts"] + e["dur"] <= hi for e in ops)
    assert not any(e["name"] == "aten::bmm" and e["ts"] > rounds[2]["ts"] for e in ops)


class _Event:
    """A profiler event as ``kineto_results.events()`` yields it."""

    def __init__(self, name, device, start_us, dur_us, activity, index=0, resource=7):
        self._v = (name, device, int(start_us * 1e3), int(dur_us * 1e3), activity, index, resource)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def device_index(self):
        return self._v[5]

    def device_resource_id(self):
        return self._v[6]


def test_a_device_capture_holds_the_cards_work_or_raises():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Event(tprofile._OPEN_MARK, cpu, 100.0, 1, "user_annotation"),
        _Event("aten::mm", cpu, 150.0, 5, "cpu_op"),
        _Event("cudaLaunchKernel", cpu, 151.0, 3, "cuda_runtime"),
    ]
    with pytest.raises(RuntimeError, match="no device event"):
        tprofile._trace_doc(events, cuda=True)
    with pytest.raises(RuntimeError, match="no fedtpu_capture_open"):
        tprofile._trace_doc(events[1:], cuda=False)
    events += [_Event("threshold_feedback_kernel", cuda, 160.5, 2, "kernel", index=1),
               _Event("round", cuda, 150.0, 20, "gpu_user_annotation", index=1),
               _Event("early_kernel", cuda, 99.0, 2, "kernel", index=1)]
    lanes = trace_merge.extract_device_lanes(tprofile._trace_doc(events, cuda=True))
    assert [(name, [(e["name"], e["ts"], e["dur"]) for e in evs]) for name, evs in lanes] == [
        ("/device:GPU:1", [("threshold_feedback_kernel", 60.5, 2.0)])]
