"""The span tracer and trace propagation against fedtpu's.

- One scripted span program (nested, sibling and cross-thread ``parent=``
  spans, args, an exception inside a span) runs through both packages'
  ``SpanTracer``: the events are equal but for ``ts``, ``dur``, ``pid`` and
  ``tid``, a raising sink breaks nothing, and the Chrome-trace round trip
  and ``Telemetry.export_trace`` write fedtpu's document and metadata keys.
- The profiler bridge: inside a CPU ``torch.profiler.profile()`` a span is
  a ``record_function`` event of its name.
- ``encode_context`` is byte-equal to fedtpu's, each package decodes the
  other's bytes, garbage decodes to None, ``span_args`` and ``adopt``
  agree; a port channel with ``trace_source=`` reaches a localhost gRPC
  server whose handler reads the metadata with fedtpu's ``from_metadata``.
- ``BackgroundCheckpointer(telemetry=)`` writes fedtpu's ``checkpoint``
  span; ``LocalTrainer.train_round`` and ``set_global`` take fedtpu's
  parameters in fedtpu's order; the port emits fedtpu's 19 span names, all
  documented in the unedited ``docs/OBSERVABILITY.md``.
"""

import inspect
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from fedtpu.checkpoint import checkpoint as jck
from fedtpu.checkpoint import writer as jwriter
from fedtpu.obs import Telemetry as JTelemetry
from fedtpu.obs import propagate as jprop
from fedtpu.obs import trace as jtrace
from fedtpu.transport import federation as jfederation
from fedtpu.transport import proto as jproto
from fedtpu.transport import service as jservice
from fedtpu_torch.checkpoint import BackgroundCheckpointer, Checkpointer
from fedtpu_torch.obs import Telemetry as TTelemetry
from fedtpu_torch.obs import propagate as tprop
from fedtpu_torch.obs import trace as ttrace
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import service as tservice
from fedtpu_torch.transport.trainer import LocalTrainer
from test_federation import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import span_check  # noqa: E402

# Set by the clock, the process and the thread, not by the program.
UNTIMED = ("ts", "dur", "pid", "tid")

SPAN_NAMES = {"aggregate", "async_tick", "async_update", "broadcast", "checkpoint", "client_rpc",
              "client_train", "cohort_sample", "collect", "decode", "fused_rounds", "fused_ticks", "h2d",
              "install_global", "partial_reduce", "replicate", "round", "screen", "submit_partial"}


def untimed(events):
    return [{k: v for k, v in e.items() if k not in UNTIMED} for e in events]


def span_program(tracer):
    """Nested, sibling and cross-thread spans, args, and a raise inside a
    span. The worker threads run one after the other, so the ids are the
    same in every run."""
    with tracer.span("round", round=0) as rspan:
        with tracer.span("collect", launched=2):
            for i in range(2):
                def work(i=i):
                    with tracer.span("client_rpc", parent=rspan.id, client=f"c{i}"):
                        with tracer.span("decode", client=f"c{i}"):
                            pass
                t = threading.Thread(target=work)
                t.start()
                t.join()
        with tracer.span("aggregate", participants=2):
            assert tracer.current_id() is not None
        with pytest.raises(ValueError):
            with tracer.span("broadcast", parent=rspan.id, client="c0"):
                raise ValueError("boom")
    assert tracer.current_id() is None
    with tracer.span("round", round=1, note="x"):
        pass


def test_span_tracer_records_fedtpus_events():
    jt, tt = jtrace.SpanTracer(), ttrace.SpanTracer()
    seen = []
    for tr in (jt, tt):
        tr.sink = lambda e: (seen.append(e["name"]), 1 / 0)  # a raising sink
        span_program(tr)
    assert untimed(tt.events()) == untimed(jt.events())
    assert seen[:len(seen) // 2] == seen[len(seen) // 2:] == [e["name"] for e in tt.events()]
    events = tt.events()
    assert [e["args"]["span_id"] for e in events] == [4, 3, 6, 5, 2, 7, 8, 1, 9]
    assert events[0] == dict(events[0], name="decode", ph="X", args={"span_id": 4, "parent_id": 3,
                                                                      "client": "c0"})
    assert events[1]["args"] == {"span_id": 3, "parent_id": 1, "client": "c0"}  # across threads
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in events)
    for tr in (jt, tt):
        tr.clear()
        assert tr.events() == []
        assert isinstance(tr.trace_id, str) and len(tr.trace_id) == 16
    assert ttrace.NULL_SPAN.id is None and TTelemetry("basic").span("x") is ttrace.NULL_SPAN


def test_chrome_trace_and_export_keep_fedtpus_documents(tmp_path):
    docs = {}
    for name, mod, tel_cls in (("fedtpu", jtrace, JTelemetry), ("port", ttrace, TTelemetry)):
        tr = mod.SpanTracer()
        span_program(tr)
        path = str(tmp_path / f"{name}.json")
        mod.write_chrome_trace(tr.events(), path, metadata={"trace_id": "ab", "role": "primary"})
        assert not os.path.exists(path + ".tmp")
        assert mod.load_chrome_trace(path) == tr.events()
        bare = str(tmp_path / f"{name}-bare.json")
        with open(bare, "w") as fh:
            json.dump(tr.events()[:2], fh)
        assert mod.load_chrome_trace(bare) == tr.events()[:2]
        tel = tel_cls("trace", role="client:x")
        with tel.span("round", round=0):
            pass
        exported = str(tmp_path / f"{name}-export.json")
        tel.export_trace(exported)
        tel_cls("basic").export_trace(str(tmp_path / f"{name}-none.json"))  # nothing below trace
        assert not os.path.exists(tmp_path / f"{name}-none.json")
        docs[name] = (json.load(open(path)), json.load(open(exported)), tel)
    (jdoc, jexp, jtel), (tdoc, texp, ttel) = docs["fedtpu"], docs["port"]
    assert set(tdoc) == set(jdoc) == {"traceEvents", "displayTimeUnit", "metadata"}
    assert tdoc["metadata"] == jdoc["metadata"] and tdoc["displayTimeUnit"] == jdoc["displayTimeUnit"]
    assert untimed(tdoc["traceEvents"]) == untimed(jdoc["traceEvents"])
    assert set(texp["metadata"]) == set(jexp["metadata"]) == {"trace_id", "role", "pid", "wall_start"}
    assert texp["metadata"] == {"trace_id": ttel.tracer.trace_id, "role": "client:x", "pid": os.getpid(),
                                "wall_start": ttel.tracer.wall_start}
    assert untimed(texp["traceEvents"]) == untimed(jexp["traceEvents"])
    anon = TTelemetry("trace")
    anon.export_trace(str(tmp_path / "anon.json"))
    assert json.load(open(tmp_path / "anon.json"))["metadata"]["role"] == f"pid{os.getpid()}"


def test_spans_are_record_function_ranges_under_the_profiler():
    tel = TTelemetry("trace")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tel.span("round", round=0):
            with tel.span("decode", client="c0"):
                torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("round") == 1 and names.count("decode") == 1
    ranges = {e.name: e for e in prof.events() if e.name in ("round", "decode")}
    assert ranges["round"].time_range.start <= ranges["decode"].time_range.start
    assert ranges["decode"].time_range.end <= ranges["round"].time_range.end
    # Without the bridge no range opens; the spans are recorded all the same.
    quiet = TTelemetry("trace", bridge_profiler=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with quiet.span("round", round=0):
            pass
    assert "round" not in [e.name for e in prof.events()] and len(quiet.trace_events()) == 1


CONTEXTS = [
    dict(trace_id="a3f1", span_id=7, role="primary", round=12),
    dict(trace_id="0123456789abcdef", span_id=0, role="", round=0),
    dict(trace_id="t", span_id=2 ** 40, role="client:localhost:1", round=-1),
    dict(trace_id="é✓", span_id=None, role="aggregator:x", round=3),
]
GARBAGE = [b"not json", b'{"span_id": 1}', b"\xff\xfe", b"[]", b"null", b'{"trace_id": "a", "span_id": "x"}',
           b'{"trace_id": "a", "round": [1]}']


def test_context_codec_is_fedtpus_byte_for_byte():
    assert tprop.METADATA_KEY == jprop.METADATA_KEY == "fedtpu-trace-bin"
    for kw in CONTEXTS:
        jctx, tctx = jprop.TraceContext(**kw), tprop.TraceContext(**kw)
        jb, tb = jprop.encode_context(jctx), tprop.encode_context(tctx)
        assert tb == jb
        assert tprop.decode_context(jb) == tprop.TraceContext(**{**kw, "span_id": kw["span_id"] or 0})
        assert jprop.decode_context(tb) == jprop.TraceContext(**{**kw, "span_id": kw["span_id"] or 0})
        meta = [("other-key", b"x"), (tprop.METADATA_KEY, tb)]
        assert tprop.from_metadata(meta) == tprop.decode_context(tb)
        assert tprop.from_metadata([(tprop.METADATA_KEY, tb.decode())]) == tprop.decode_context(tb)
        assert tprop.span_args(tprop.decode_context(tb)) == jprop.span_args(jprop.decode_context(jb))
        jt, tt = jtrace.SpanTracer(), ttrace.SpanTracer()
        jprop.adopt(jt, jctx)
        tprop.adopt(tt, tctx)
        assert tt.trace_id == jt.trace_id == kw["trace_id"]
    for blob in GARBAGE:
        assert tprop.decode_context(blob) is None and jprop.decode_context(blob) is None, blob
    for meta in (None, [], [("other-key", b"x")]):
        assert tprop.from_metadata(meta) is None and jprop.from_metadata(meta) is None
    assert tprop.span_args(None) == jprop.span_args(None) == {}
    tt = ttrace.SpanTracer()
    before = tt.trace_id
    tprop.adopt(tt, None)
    tprop.adopt(None, tprop.TraceContext("x"))
    tprop.adopt(tt, tprop.TraceContext(""))
    assert tt.trace_id == before


class _Recorder(jservice.TrainerServicer):
    """Reads each HeartBeat's metadata with fedtpu's own decoder."""

    def __init__(self):
        self.seen = []

    def HeartBeat(self, request, context):
        self.seen.append(jprop.from_metadata(context.invocation_metadata()))
        return jproto.HeartBeatResponse(status=1)


def test_a_traced_port_channel_reaches_fedtpus_decoder():
    rec = _Recorder()
    addr = f"localhost:{free_port()}"
    server = jservice.create_server(addr, rec)
    server.start()
    ctx = tprop.TraceContext("feed", span_id=4, role="primary", round=2)

    def broken():
        raise RuntimeError("a source that fails never fails the RPC")

    try:
        for source in (lambda: ctx, lambda: None, broken):
            channel = tservice.create_channel(addr, trace_source=source)
            stub = tservice.TrainerStub(channel)
            assert stub.HeartBeat(tproto.Request(), timeout=30).status == 1
            channel.close()
    finally:
        server.stop(0)
    assert rec.seen == [jprop.TraceContext("feed", span_id=4, role="primary", round=2), None, None]


def test_background_writer_opens_fedtpus_checkpoint_span(tmp_path):
    state = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, "round": np.int32(4)}
    spans = []
    for name, ck, bg, tel in (("fedtpu", jck.Checkpointer, jwriter.BackgroundCheckpointer, JTelemetry("trace")),
                              ("port", Checkpointer, BackgroundCheckpointer, TTelemetry("trace"))):
        writer = bg(ck(str(tmp_path / name), backend="wire"), telemetry=tel)
        for r in (4, 5):
            writer.save(r, state)
        writer.close()
        spans.append(untimed(tel.trace_events()))
    assert spans[1] == spans[0] == [
        {"name": "checkpoint", "ph": "X", "args": {"span_id": 1, "round": 4}},
        {"name": "checkpoint", "ph": "X", "args": {"span_id": 2, "round": 5}},
    ]


def test_trainer_takes_fedtpus_trace_parameters():
    for method in ("train_round", "set_global"):
        want = inspect.signature(getattr(jfederation.LocalTrainer, method)).parameters
        got = inspect.signature(getattr(LocalTrainer, method)).parameters
        assert list(got) == list(want), method
        assert [p.default for p in got.values()] == [p.default for p in want.values()], method


def test_the_port_emits_fedtpus_documented_span_names():
    port = os.path.join(REPO, "fedtpu_torch")
    emitted = span_check.emitted_span_names(port)
    assert set(emitted) == set(span_check.emitted_span_names()) == SPAN_NAMES
    assert span_check.check(package_dir=port) == []
