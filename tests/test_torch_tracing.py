"""The port's request tracing (paddle_tpu_torch/monitor/tracing.py) on the
CPU, against the JAX package's (paddle_tpu/monitor/tracing.py).

* ``format_traceparent`` / ``parse_traceparent`` round-trip, and every
  malformed header is rejected (None) by both packages alike.
* ``sample_decision`` equals the reference's on 1,000 seeded trace ids at
  rates 0, 0.01, 0.5 and 1 (and on ids that are not hex).
* ``Tracer``: the span ring's bound, child parentage, events, the unsampled
  ``NullSpan`` paths and the chrome-trace document, as the reference's.
* The span tree of one HTTP ``/generate`` (blocking and streamed) through
  the port's ``ServingServer`` and ``GenerationEngine`` equals the tree
  of the same request through the reference's (tests/test_tracing.py's
  GPT config, the reference's weights): ``server.generate`` under the
  client's span, ``gen.queued``, ``gen.prefill`` and ``gen.decode`` under
  it with their parent ids linked, the same attributes and event names.
  A request submitted in process gets an engine-owned
  ``genserve.request`` root.
"""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.monitor as jmonitor
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.monitor import tracing as jtracing
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu.serving.client import ServingClient as JServingClient
from paddle_tpu.serving.server import ServingServer as JServingServer
from paddle_tpu_torch import monitor
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.monitor import tracing
from paddle_tpu_torch.serving import (GenerationEngine, ServingClient,
                                      ServingServer)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
ENGINE = dict(max_slots=2, max_seq_len=32, prompt_buckets="8")
TID, SID = "ab" * 16, "cd" * 8


def test_traceparent_round_trip_and_rejects():
    for sampled in (True, False):
        hdr = tracing.format_traceparent(TID, SID, sampled)
        assert hdr == jtracing.format_traceparent(TID, SID, sampled)
        assert tracing.parse_traceparent(hdr) == (TID, SID, sampled)
    hdr = tracing.format_traceparent(TID, SID, True)
    bad = ["", None, 7, "00-xyz", f"00-{TID}-{SID}", f"00-{'0' * 32}-{SID}-01",
           f"00-{TID}-{'0' * 16}-01", "zz-" + hdr[3:], f"0-{TID}-{SID}-01",
           f"00-{TID[:-1]}g-{SID}-01", f"00-{TID}-{SID}-zz",
           f"00-{TID}x-{SID}-01"]
    for h in bad + [hdr.upper(), " " + hdr + " ", hdr + "-extra"]:
        assert tracing.parse_traceparent(h) == jtracing.parse_traceparent(h)
    for h in bad:
        assert tracing.parse_traceparent(h) is None, h


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.5, 1.0])
def test_sample_decision_equals_the_reference(rate):
    rs = np.random.RandomState(1234)
    ids = [rs.bytes(16).hex() for _ in range(1000)]
    got = [tracing.sample_decision(t, rate) for t in ids]
    assert got == [jtracing.sample_decision(t, rate) for t in ids]
    if 0 < rate < 1:
        assert 0 < sum(got) < len(ids)
    for odd in ("zzzzzzzz" + "a" * 24, None, ""):
        assert tracing.sample_decision(odd, rate) == \
            jtracing.sample_decision(odd, rate)


def _shape(records):
    """A tracer's finished spans without ids and times: (name, parent's
    name, attribute keys, event names), in order."""
    names = {r["span_id"]: r["name"] for r in records}
    return [(r["name"], names.get(r["parent_id"], r["parent_id"]),
             sorted(r["attrs"]), [e["name"] for e in r["events"]])
            for r in records]


def test_tracer_core_equals_the_reference():
    out = []
    for mod in (tracing, jtracing):
        t = mod.Tracer(sample_rate=1.0, max_spans=3)
        root = t.start_span("root", attrs={"a": 1})
        child = root.child("child", b=2)
        child.event("tick", i=1)
        child.end(status="ok")
        child.end(status="again")                   # idempotent
        with root.child("ctx"):
            pass
        root.end()
        extra = t.start_span("extra", traceparent=root.traceparent)
        extra.end()
        assert len(t.spans()) == 3 and t.spans_finished == 4
        assert t.spans(trace_id=root.trace_id, limit=1)[0]["name"] == \
            "extra"
        doc = t.chrome_trace()
        out.append((_shape(t.spans()[:2]), [e["ph"] for e in
                                             doc["traceEvents"]],
                    t.trace_ids() == [root.trace_id]))
        # unsampled and disabled paths
        off = mod.Tracer(sample_rate=0.0)
        assert not off.enabled and not off.start_span("x").sampled
        dropped = t.start_span("y", traceparent=mod.format_traceparent(
            TID, SID, False))
        assert isinstance(dropped, mod.NullSpan)
        assert dropped.traceparent == mod.format_traceparent(TID, SID, False)
        assert dropped.child("z") is dropped
    assert out[0] == out[1]


@pytest.fixture()
def tracer_on():
    """Every request sampled, on both packages, for one test."""
    old = flags.flag("FLAGS_trace_sample_rate")
    jold = jflags.flag("FLAGS_trace_sample_rate")
    flags.set_flags({"FLAGS_trace_sample_rate": 1.0})
    jflags.set_flags({"FLAGS_trace_sample_rate": 1.0})
    monitor.reset()
    jmonitor.reset()
    yield tracing.default_tracer(), jtracing.default_tracer()
    flags.set_flags({"FLAGS_trace_sample_rate": old})
    jflags.set_flags({"FLAGS_trace_sample_rate": jold})
    monitor.reset()
    jmonitor.reset()


@pytest.fixture(scope="module")
def servers():
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**CFG))
    jm.eval()
    pm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_numpy_state(pm, {k: np.asarray(v.numpy())
                          for k, v in jm.state_dict().items()})
    pm.eval()
    jsrv = JServingServer(None, gen_engine=JGenerationEngine(jm, **ENGINE),
                          port=0, install_signal_handlers=False).start()
    psrv = ServingServer(None, gen_engine=GenerationEngine(
        pm, device="cpu", **ENGINE), port=0,
        install_signal_handlers=False).start()
    yield jsrv, psrv
    psrv.shutdown()
    jsrv.shutdown()


WANT = ("server.generate", "gen.queued", "gen.prefill", "gen.decode")


def _tree(tracer, trace_id, want=WANT):
    """Spans of one trace, polled until ``want`` are there (the server
    records its span after the response body is flushed)."""
    deadline = time.monotonic() + 5.0
    while True:
        spans = tracer.spans(trace_id=trace_id)
        if set(want) <= {s["name"] for s in spans} \
                or time.monotonic() > deadline:
            return spans


@pytest.mark.parametrize("stream", [False, True])
def test_http_generate_span_tree_equals_the_reference(tracer_on, servers,
                                                      stream):
    trees = []
    for (Client, srv), tracer in zip(((JServingClient, servers[0]),
                                      (ServingClient, servers[1])),
                                     tracer_on[::-1]):
        tracer.clear()
        client = Client(srv.url)
        hdr = tracing.format_traceparent(TID, SID, True)
        if stream:
            events = list(client.generate_stream([5, 6, 7], 4,
                                                 traceparent=hdr))
            toks = [e["token"] for e in events if "token" in e]
            assert events[-1]["done"] and sorted(events[-1]) == [
                "done", "latency_ms", "tokens", "ttft_ms"]
        else:
            toks = client.generate([1, 2, 3, 4], 5,
                                   traceparent=hdr)["tokens"]
        spans = _tree(tracer, TID)
        by = {s["name"]: s for s in spans}
        assert set(WANT) <= set(by)
        assert by["server.generate"]["parent_id"] == SID
        for child in WANT[1:]:
            assert by[child]["parent_id"] == by["server.generate"]["span_id"]
            assert by[child]["trace_id"] == TID
        assert by["server.generate"]["attrs"]["tokens"] == len(toks)
        assert len(by["gen.decode"]["events"]) == len(toks) - 1
        trees.append((toks, sorted(_shape(spans))))
    assert trees[0] == trees[1]


def test_in_process_submit_roots_its_own_span(tracer_on, servers):
    ptracer, jtracer = tracer_on
    shapes = []
    for srv, tracer in ((servers[0], jtracer), (servers[1], ptracer)):
        tracer.clear()
        srv.gen_engine.generate([2, 3, 4], 3, timeout=60)
        deadline = time.monotonic() + 5.0
        while len(tracer.spans()) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        spans = tracer.spans()
        root = [s for s in spans if s["name"] == "genserve.request"]
        assert len(root) == 1 and root[0]["parent_id"] is None
        assert root[0]["attrs"]["status"] == "ok"
        shapes.append(sorted(_shape(spans)))
    assert shapes[0] == shapes[1]


def test_unsampled_rate_records_nothing(servers):
    old = flags.flag("FLAGS_trace_sample_rate")
    flags.set_flags({"FLAGS_trace_sample_rate": 0.0})
    monitor.reset()
    try:
        client = ServingClient(servers[1].url)
        assert len(client.generate([1, 2, 3], 2)["tokens"]) == 2
        assert client.last_traceparent is None
        assert tracing.default_tracer().spans() == []
    finally:
        flags.set_flags({"FLAGS_trace_sample_rate": old})
        monitor.reset()
