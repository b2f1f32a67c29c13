"""The port's HTTP front end (paddle_tpu_torch/serving/server.py and
client.py) on the CPU, beside the JAX package's on the same requests.

Each server mounts both engines: the example's BERT (vocab 400, hidden 48,
2 layers, 4 heads, FFN 96; examples/bert_serving.py) behind the adaptive
batcher (buckets 1,2,4 x 8,16) and tests/test_generation_serving.py's GPT
(vocab 211, hidden 48, 2 layers, 4 heads) behind the generation engine
(3 slots, max_seq_len 40, buckets 8 and 16); the port's models hold the
reference's weights (``load_numpy_state``).

* ``/generate``: greedy tokens equal, JSON and SSE; the SSE event sequence
  and the ``done`` event's keys equal.  ``/predict``: outputs within
  atol = rtol = 1e-5 (float32).
* Status codes and ``Retry-After`` equal on the same bad, unknown,
  backpressured (429), draining (503) and expired (504) requests;
  ``/healthz`` carries the reference's keys with ``torch_version`` in
  place of ``jax_version``; ``/metrics`` both engines' names.
* ``ServingClient``'s retry against a stub server (429 with Retry-After,
  5xx, 504 never retried, a refused connection) as the reference's.
* ``Model.serve`` / ``serve_generate(blocking=False)``, and
  ``serve_generate(mesh=)`` raising until tensor-parallel serving lands.
* ``python -m paddle_tpu_torch.serving.client`` drives a server; a
  SIGTERM to a CPU subprocess serving a stream drains it: the stream ends
  with its ``done`` event and the process exits 0; a client that closes
  its SSE connection mid-stream cancels its request and frees its slot.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import paddle_tpu as paddle
from conftest import cpu_subprocess_env
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertModel as JBertModel
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.client import ServingClient as JServingClient
from paddle_tpu.serving.client import ServingHTTPError as JServingHTTPError
from paddle_tpu.serving.server import ServingServer as JServingServer
from paddle_tpu_torch import Model
from paddle_tpu_torch.models import (BertConfig, BertModel, GPTConfig,
                                     GPTForCausalLM, load_numpy_state)
from paddle_tpu_torch.serving import (GenerationEngine, ServingEngine,
                                      ServingServer)
from paddle_tpu_torch.serving.client import ServingClient, ServingHTTPError

BERT = dict(vocab_size=400, hidden_size=48, num_layers=2, num_heads=4,
            intermediate_size=96, max_position_embeddings=64, dropout=0.0)
GPT = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
GEN = dict(max_slots=3, max_seq_len=40, prompt_buckets="8,16")
BUCKETS = "1,2,4x8,16"
TOL = dict(atol=1e-5, rtol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _carry(jax_model, port_model):
    load_numpy_state(port_model, {k: np.asarray(v.numpy())
                                  for k, v in jax_model.state_dict().items()})
    return port_model.eval()


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jb = JBertModel(JBertConfig(**BERT))
    jb.eval()
    paddle.seed(0)
    jg = JGPTForCausalLM(JGPTConfig(**GPT))
    jg.eval()
    return (jb, _carry(jb, BertModel(BertConfig(**BERT), device="cpu")),
            jg, _carry(jg, GPTForCausalLM(GPTConfig(**GPT), device="cpu")))


@pytest.fixture(scope="module")
def servers(models):
    jb, pb, jg, pg = models
    jsrv = JServingServer(
        JServingEngine(jb, batch_timeout_ms=2, buckets=BUCKETS,
                       input_specs=[((-1, -1), "int32")]),
        gen_engine=JGenerationEngine(jg, **GEN), port=0,
        install_signal_handlers=False).start()
    psrv = ServingServer(
        ServingEngine(pb, batch_timeout_ms=2, buckets=BUCKETS,
                      input_specs=[((-1, -1), "int64")]),
        gen_engine=GenerationEngine(pg, device="cpu", **GEN), port=0,
        install_signal_handlers=False).start()
    yield jsrv, psrv
    psrv.shutdown()
    jsrv.shutdown()


def _raw(url, path, data=None, method=None):
    """(status, headers, body) of one request with a raw byte body."""
    req = urllib.request.Request(
        url + path, data=data, method=method or ("POST" if data is not None
                                                 else "GET"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


PROMPTS = [[3, 4, 5, 6, 7, 8, 9], [5, 9, 2], list(range(50, 62))]


def test_generate_tokens_and_sse_equal_the_reference(servers):
    jc, pc = (JServingClient(s.url) for s in servers)
    for p in PROMPTS:
        want = jc.generate(p, 10)
        got = pc.generate(p, 10)
        assert got["tokens"] == want["tokens"]
        assert sorted(got) == sorted(want) == ["latency_ms", "tokens",
                                               "ttft_ms"]
        jev = list(jc.generate_stream(p, 10))
        pev = list(pc.generate_stream(p, 10))
        assert [e.get("token") for e in pev] == [e.get("token") for e in jev]
        assert [sorted(e) for e in pev] == [sorted(e) for e in jev]
        assert pev[-1]["done"] is True and pev[-1]["tokens"] == 10
        assert [e["token"] for e in pev[:-1]] == want["tokens"]


def test_predict_outputs_match_the_reference(servers):
    jc, pc = (JServingClient(s.url) for s in servers)
    rs = np.random.RandomState(0)
    for n in (3, 8, 11, 16):
        ids = rs.randint(0, BERT["vocab_size"], n)
        want = jc.predict([ids.astype(np.int32)])
        got = pc.predict([ids.astype(np.int64)])
        assert [g.shape for g in got] == [w.shape for w in want] == [
            (n, BERT["hidden_size"]), (BERT["hidden_size"],)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g, w, **TOL)


BAD = [
    ("/predict", b"{not json"),
    ("/predict", json.dumps({"not_inputs": 1}).encode()),
    ("/predict", json.dumps({"inputs": []}).encode()),
    ("/predict", json.dumps({"inputs": [[[1], [1, 2]]]}).encode()),
    ("/predict", json.dumps({"inputs": [[[1, 2], [3, 4]]]}).encode()),
    ("/predict", json.dumps({"inputs": [list(range(17))]}).encode()),
    ("/predict", json.dumps({"inputs": [[1, 2]], "dtypes": ["nope"]})
     .encode()),
    ("/generate", b"[1, 2"),
    ("/generate", json.dumps({"prompt": []}).encode()),
    ("/generate", json.dumps({"prompt": "abc"}).encode()),
    ("/generate", json.dumps({"prompt": [1], "max_new_tokens": 0}).encode()),
    ("/generate", json.dumps({"prompt": [1] * 17}).encode()),
    ("/generate", json.dumps({"prompt": [1], "top_k": "x"}).encode()),
    ("/generate", json.dumps({"prompt": [1], "resume_pos": -2}).encode()),
    ("/nope", b"{}"),
]


def test_bad_and_unknown_requests_get_the_references_codes(servers):
    for path, body in BAD:
        codes = [_raw(s.url, path, body)[0] for s in servers]
        assert codes[0] == codes[1], (path, body, codes)
        assert codes[1] in (400, 404)
    for path in ("/nope", "/healthz/x"):
        codes = [_raw(s.url, path)[0] for s in servers]
        assert codes == [404, 404]


def test_healthz_and_metrics(servers):
    jh, ph = (_raw(s.url, "/healthz") for s in servers)
    assert jh[0] == ph[0] == 200
    jb, pb = json.loads(jh[2]), json.loads(ph[2])
    assert set(pb) == set(jb) - {"jax_version"} | {"torch_version"}
    assert pb["status"] == "ok" and pb["pid"] == os.getpid()
    assert pb["uptime_s"] >= 0.0 and pb["device_count"] == 0
    text = ServingClient(servers[1].url).metrics()
    for needle in ("paddle_serving_qps", "paddle_serving_p99_ms",
                   "paddle_serving_padding_waste_ratio",
                   "paddle_serving_batch_size_bucket",
                   "paddle_serving_queue_latency_ms_bucket",
                   "paddle_serving_compile_count",
                   "paddle_genserve_decode_tokens_per_sec",
                   "paddle_genserve_ttft_p50_ms"):
        assert needle in text, needle


class _BlockingRunner:
    def __init__(self):
        self.release = threading.Event()
        self.calls = 0

    def run(self, arrays):
        self.calls += 1
        assert self.release.wait(30)
        return [np.asarray(arrays[0]) * 2.0]


def _codes_under_pressure(Engine, Server):
    """Status codes and Retry-After of: a request held in the model, one
    queued, one beyond the queue (429), one whose deadline passes while
    queued (504), one after the drain began (503), and /healthz then."""
    runner = _BlockingRunner()
    eng = Engine(runner, max_batch_size=1, batch_timeout_ms=0, buckets="1",
                 queue_depth=2)
    srv = Server(eng, port=0, install_signal_handlers=False).start()
    body = json.dumps({"inputs": [[1.0, 2.0]]}).encode()
    doomed = json.dumps({"inputs": [[1.0, 2.0]], "deadline_ms": 20}).encode()
    out = {}

    def fire(key, data):
        out[key] = _raw(srv.url, "/predict", data)

    try:
        held = threading.Thread(target=fire, args=("held", body))
        held.start()
        deadline = time.monotonic() + 10
        while runner.calls == 0:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        queued = threading.Thread(target=fire, args=("expired", doomed))
        queued.start()
        while eng._queue.qsize() < 1:
            time.sleep(0.001)
        other = threading.Thread(target=fire, args=("queued", body))
        other.start()
        while eng._queue.qsize() < 2:
            time.sleep(0.001)
        fire("full", body)
        time.sleep(0.05)                    # the deadline passes
        runner.release.set()
        for t in (held, queued, other):
            t.join(30)
        eng._draining = True                # the drain's first step
        fire("draining", body)
        out["healthz"] = _raw(srv.url, "/healthz")
    finally:
        runner.release.set()
        srv.shutdown()
    return {k: (v[0], v[1].get("Retry-After")) for k, v in out.items()}


def test_status_codes_and_retry_after_equal_the_reference():
    want = _codes_under_pressure(JServingEngine, JServingServer)
    got = _codes_under_pressure(ServingEngine, ServingServer)
    assert got == want
    assert got == {"held": (200, None), "queued": (200, None),
                   "expired": (504, None), "full": (429, "1"),
                   "draining": (503, "1"), "healthz": (503, "1")}


class _Stub(BaseHTTPRequestHandler):
    """Answers from a script of (status, headers) then 200."""
    protocol_version = "HTTP/1.1"

    def _answer(self):
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        self.server.hits += 1
        script = self.server.script
        status, headers = script.pop(0) if script else (200, {})
        body = json.dumps({"outputs": [[1.0]], "dtypes": ["float32"],
                           "error": "scripted"}).encode()
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = _answer

    def log_message(self, *a):
        pass


@pytest.fixture()
def stub():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()


@pytest.mark.parametrize("script,retries,outcome", [
    ([(429, {"Retry-After": "0"})], 2, (200, 2)),
    ([(503, {}), (500, {})], 2, (200, 3)),
    ([(503, {}), (500, {})], 1, (500, 2)),
    ([(429, {"Retry-After": "0"})], 0, (429, 1)),
    ([(504, {})], 3, (504, 1)),
])
def test_client_retry_equals_the_reference(stub, script, retries, outcome):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    seen = []
    for Client, Err in ((JServingClient, JServingHTTPError),
                        (ServingClient, ServingHTTPError)):
        stub.script, stub.hits = list(script), 0
        c = Client(url, retries=retries, retry_backoff_s=0.001)
        try:
            c.predict([np.zeros(1, np.float32)])
            status = 200
        except Err as e:
            status = e.status
        seen.append((status, c.last_attempts, stub.hits))
    assert seen[0] == seen[1] == (*outcome, outcome[1])


def test_client_refused_connection_raises_after_retries():
    with ThreadingHTTPServer(("127.0.0.1", 0), _Stub) as s:
        port = s.server_address[1]      # closed when the block ends
    for Client in (JServingClient, ServingClient):
        c = Client(f"http://127.0.0.1:{port}", retries=2,
                   retry_backoff_s=0.001, timeout=2)
        with pytest.raises(OSError):
            c.healthz()
        assert c.last_attempts == 3


def test_model_serve_and_serve_generate(models):
    _, pb, _, pg = models
    srv = Model(pb).serve(port=0, blocking=False,
                          install_signal_handlers=False,
                          input_spec=[((-1, -1), "int64")], buckets="1,2x8",
                          batch_timeout_ms=2)
    try:
        ids = np.arange(1, 6, dtype=np.int64)
        out = ServingClient(srv.url).predict([ids])
        padded = np.zeros((1, 8), np.int64)
        padded[0, :5] = ids
        direct = srv.engine._predictor.run([padded])
        np.testing.assert_array_equal(out[0], direct[0][0, :5])
        np.testing.assert_array_equal(out[1], direct[1][0])
    finally:
        assert srv.shutdown() is True
    gsrv = Model(pg).serve_generate(port=0, blocking=False, device="cpu",
                                    install_signal_handlers=False, **GEN)
    try:
        got = ServingClient(gsrv.url).generate(PROMPTS[0], 6)["tokens"]
        assert got == gsrv.gen_engine.generate(PROMPTS[0], 6, timeout=60)
    finally:
        assert gsrv.shutdown() is True
        assert gsrv.wait(5) == 0
    with pytest.raises(NotImplementedError, match="A9"):
        Model(pg).serve_generate(port=0, blocking=False, device="cpu",
                                 mesh={"tp": 2})


def test_load_generator_drives_a_server(servers):
    env = cpu_subprocess_env()
    url = servers[1].url
    for args in (["--mode", "generate", "--vocab", "200", "--prompt-len",
                  "6", "--max-new", "4", "--sample"],
                 ["--mode", "predict", "--shape", "8", "--dtype", "int64"],
                 ["--mode", "mixed", "--vocab", "200", "--prompt-len", "6",
                  "--max-new", "3", "--shape", "8", "--dtype", "int64"]):
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.serving.client",
             "--url", url, "--requests", "4", "--concurrency", "2", *args],
            capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["ok"] == 4 and summary["errors"] == 0, summary


_CHILD = r"""
import sys, time
from paddle_tpu_torch import Model
from paddle_tpu_torch.framework.random import seed
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

seed(0)
net = GPTForCausalLM(GPTConfig(vocab_size=211, hidden_size=48, num_layers=2,
                               num_heads=4, max_position_embeddings=64,
                               dropout=0.0, attn_dropout=0.0), device="cpu")
srv = Model(net).serve_generate(port=0, blocking=False, device="cpu",
                                max_slots=3, max_seq_len=40,
                                prompt_buckets="8,16")
eng = srv.gen_engine
step = eng.step

def slow_step():
    time.sleep(0.02)      # a decode step long enough to SIGTERM mid-stream
    return step()

eng.step = slow_step
print(srv.url, flush=True)
sys.exit(srv.wait())
"""


def test_sigterm_drains_an_open_stream_and_exits_0():
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=cpu_subprocess_env(), cwd=ROOT)
    try:
        url = proc.stdout.readline().strip()
        assert url.startswith("http://"), proc.stderr.read()
        events = []
        for evt in ServingClient(url, timeout=60).generate_stream(
                [3, 4, 5], 30):
            events.append(evt)
            if len(events) == 1:
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, proc.stderr.read()
    assert events[-1]["done"] is True and "error" not in events[-1]
    assert events[-1]["tokens"] == 30
    assert sum("token" in e for e in events) == 30


def test_a_client_that_goes_away_cancels_its_stream(models):
    """An SSE client that closes its connection mid-stream: the handler's
    next write fails, it cancels the request, and the engine frees the
    slot at the next iteration (the decode loop never waits on it)."""
    import socket

    eng = GenerationEngine(models[3], device="cpu", **GEN)
    srv = ServingServer(None, gen_engine=eng, port=0,
                        install_signal_handlers=False).start()
    step = eng.step

    def slow_step():
        time.sleep(0.01)
        return step()

    eng.step = slow_step
    try:
        body = json.dumps({"prompt": [3, 4, 5], "max_new_tokens": 30,
                           "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while b"data: " not in got:              # the stream has begun
            chunk = sock.recv(4096)
            assert chunk, got
            got += chunk
        sock.close()
        deadline = time.monotonic() + 30
        while eng.metrics.counters["cancelled"] < 1:
            assert time.monotonic() < deadline, eng.metrics.snapshot()
            time.sleep(0.01)
        while eng._sched.occupied:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        snap = eng.metrics.snapshot()
        assert snap["preempted"] == 1 and snap["retired"] == 0
        assert snap["tokens"] < 30
        # the engine serves on
        assert len(ServingClient(srv.url).generate([5, 6], 4)["tokens"]) == 4
    finally:
        srv.shutdown()
