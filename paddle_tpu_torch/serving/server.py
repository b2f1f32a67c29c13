"""Dependency-free HTTP front end for the ServingEngine (port of
paddle_tpu/serving/server.py, whole).

stdlib ``http.server.ThreadingHTTPServer`` only — one handler thread per
connection, all of them funneling into the engine's bounded queue, so
the adaptive batcher (not the HTTP layer) is the concurrency boundary.

Endpoints:
  POST /predict   {"inputs": [nested-list, ...], "dtypes"?, "deadline_ms"?}
                  → {"outputs": [...], "dtypes": [...], "latency_ms": t}
                  429 on queue-full backpressure, 503 while draining,
                  504 on deadline expiry
  POST /generate  {"prompt": [ids], "max_new_tokens"?, "do_sample"?,
                  "temperature"?, "top_k"?, "seed"?, "resume_pos"?,
                  "eos_token_id"?, "deadline_ms"?, "stream"?} —
                  continuous-batching generation (requires a mounted
                  GenerationEngine).  `resume_pos` is the router's
                  mid-stream failover hook: the request's PRNG chain is
                  fast-forwarded past that many already-emitted tokens
                  so a re-admitted stream resumes deterministically.
                  stream=false → one JSON body {"tokens": [...]};
                  stream=true  → Server-Sent Events over chunked
                  transfer, one `data: {"token": t}` event per decoded
                  token as the decode loop produces it, then a final
                  `data: {"done": true, ...}` event.  Same 400/429/503/
                  504 admission split as /predict.
  GET  /healthz   200 {"status": "ok", ...} | 503 {"status": "draining",
                  ...} — plus framework/torch versions, device kind/count,
                  uptime_s and pid (fleet version-skew detection)
  GET  /metrics   Prometheus text from every mounted engine (batching
                  qps/p50/p99 + genserve decode tokens/s, TTFT,
                  inter-token quantiles, slot occupancy)

Graceful shutdown reuses the resilience latch pattern
(distributed/resilience.py PreemptionGuard): SIGTERM/SIGINT is LATCHED,
new work is rejected (healthz flips to draining), every queued and
in-flight request completes, then the listener closes and ``wait()``
returns 0 — the serving analog of "finish the in-flight step, then exit
clean".  The reference also leaves a flight-recorder record at drain;
the port's recorder is not ported yet (ROADMAP.md A11).

A /generate stream blocks its handler thread on ``handle.next_token``; the
decode loop never waits on an HTTP thread, and a client that goes away
mid-stream cancels its request, which frees its slot.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..distributed.resilience import PreemptionGuard
from ..monitor import tracing as _tracing
from ..monitor.server import runtime_health
from .engine import (DeadlineExceededError, EngineStoppedError,
                     QueueFullError, ServingEngine)

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["ServingServer"]


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # stdlib default listen backlog is 5 — a thundering herd of clients
    # gets TCP resets before the engine's queue (the REAL admission
    # control) ever sees them.  Backpressure must come from HTTP 429,
    # not the kernel.
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # ``self.server`` is the ThreadingHTTPServer; the ServingServer
    # attaches itself as ``.owner``.
    def _send(self, code: int, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if code in (429, 503):
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode())

    def do_GET(self):  # noqa: N802 - http.server API
        owner = self.server.owner
        if self.path == "/healthz":
            info = {"uptime_s": owner.uptime_s, **runtime_health()}
            if owner.draining:
                self._send_json(503, {"status": "draining", **info})
            else:
                self._send_json(200, {"status": "ok", **info})
        elif self.path == "/metrics":
            from ..utils.metrics import default_registry

            parts = [e.metrics.prometheus_text() for e in
                     (owner.engine, owner.gen_engine) if e is not None]
            # the process-wide shared registry (the checkpoint
            # durability counters of distributed/checkpoint.py)
            parts.append(default_registry().prometheus_text())
            self._send(200, "".join(parts).encode(),
                       ctype="text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 - http.server API
        owner = self.server.owner
        # always drain the declared body FIRST: an early error response
        # on a keep-alive connection would otherwise leave the body
        # bytes to be misparsed as the next request line
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n)
        # adopt the caller's W3C trace context (or head-sample a fresh
        # trace); a NullSpan when unsampled/disabled, so every handler
        # below threads it through unconditionally
        tracer = _tracing.default_tracer()
        tp = self.headers.get("traceparent")
        if self.path == "/generate":
            span = tracer.start_span("server.generate", traceparent=tp)
            try:
                self._do_generate(owner, raw, span)
            finally:
                span.end()
            return
        if self.path != "/predict":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        span = tracer.start_span("server.predict", traceparent=tp)
        try:
            self._do_predict(owner, raw, span)
        finally:
            span.end()

    def _do_predict(self, owner, raw, span):
        if owner.engine is None:
            self._send_json(404, {"error": "no predict engine mounted"})
            return
        t0 = time.monotonic()
        try:
            payload = json.loads(raw or b"{}")
            inputs = payload["inputs"]
            if not isinstance(inputs, list) or not inputs:
                raise ValueError("'inputs' must be a non-empty list")
            arrays = owner._decode(inputs, payload.get("dtypes"))
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        # admission errors (the client's fault / state) get 4xx-503 —
        # separately from execution errors, so a server-side ValueError
        # out of the model can never masquerade as "bad request"
        try:
            fut = owner.engine.submit(
                arrays, deadline_ms=payload.get("deadline_ms"), span=span)
        except ValueError as e:  # shape/spec mismatch caught at submit
            span.set_attr("status", "bad_request")
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        except QueueFullError as e:
            span.set_attr("status", "rejected_queue_full")
            self._send_json(429, {"error": str(e)})
            return
        except EngineStoppedError as e:
            span.set_attr("status", "rejected_draining")
            self._send_json(503, {"error": str(e)})
            return
        try:
            # bounded wait: a stalled model execution must release the
            # handler thread (queued-phase deadlines are the engine's
            # job; this is the dispatched-phase backstop)
            outs = fut.result(timeout=owner.request_timeout_s)
        except DeadlineExceededError as e:
            self._send_json(504, {"error": str(e)})
            return
        except concurrent.futures.TimeoutError:
            fut.cancel()
            self._send_json(504, {"error": "request timed out in "
                                  f"{owner.request_timeout_s:g}s"})
            return
        except Exception as e:  # noqa: BLE001 - model failure → 500
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        latency_ms = round((time.monotonic() - t0) * 1e3, 3)
        span.set_attr("latency_ms", latency_ms)
        self._send_json(200, {
            "outputs": [np.asarray(o).tolist() for o in outs],
            "dtypes": [str(np.asarray(o).dtype) for o in outs],
            "latency_ms": latency_ms,
        })

    def _do_generate(self, owner, raw, span):
        gen = owner.gen_engine
        if gen is None:
            self._send_json(404, {"error": "no generation engine mounted"})
            return
        t0 = time.monotonic()
        try:
            payload = json.loads(raw or b"{}")
            prompt = payload["prompt"]
            if not isinstance(prompt, list) or not prompt:
                raise ValueError(
                    "'prompt' must be a non-empty list of token ids")
            stream = bool(payload.get("stream", False))
            kw = dict(
                max_new_tokens=int(payload.get("max_new_tokens", 32)),
                do_sample=bool(payload.get("do_sample", False)),
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                seed=int(payload.get("seed", 0)),
                resume_pos=int(payload.get("resume_pos", 0)),
                eos_token_id=payload.get("eos_token_id"),
                deadline_ms=payload.get("deadline_ms"),
            )
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        try:
            handle = gen.submit(prompt, span=span, **kw)
        except ValueError as e:  # geometry/sampling bounds, at submit
            span.set_attr("status", "bad_request")
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        except QueueFullError as e:
            span.set_attr("status", "rejected_queue_full")
            self._send_json(429, {"error": str(e)})
            return
        except EngineStoppedError as e:
            span.set_attr("status", "rejected_draining")
            self._send_json(503, {"error": str(e)})
            return
        if stream:
            self._stream_tokens(owner, handle, t0, span)
            return
        try:
            toks = handle.result(timeout=owner.request_timeout_s)
        except DeadlineExceededError as e:
            self._send_json(504, {"error": str(e)})
            return
        except TimeoutError:
            handle.cancel()
            self._send_json(504, {"error": "generation timed out in "
                                  f"{owner.request_timeout_s:g}s"})
            return
        except EngineStoppedError as e:
            self._send_json(503, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - engine failure → 500
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if handle.ttft_ms is not None:
            span.set_attr("ttft_ms", round(handle.ttft_ms, 3))
        span.set_attr("tokens", len(toks))
        self._send_json(200, {
            "tokens": toks,
            "ttft_ms": round(handle.ttft_ms, 3)
            if handle.ttft_ms is not None else None,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
        })

    def _stream_tokens(self, owner, handle, t0, span):
        """Server-Sent Events over explicit chunked framing.  The
        response is open-ended, so the connection is marked close — a
        keep-alive client would otherwise wait on a Content-Length that
        can never be known up front."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True

        def event(obj):
            data = b"data: " + json.dumps(obj).encode() + b"\n\n"
            self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        n = 0
        try:
            try:
                while True:
                    tok = handle.next_token(timeout=owner.request_timeout_s)
                    if tok is None:
                        break
                    n += 1
                    event({"token": tok})
                span.set_attr("tokens", n)
                if handle.ttft_ms is not None:
                    span.set_attr("ttft_ms", round(handle.ttft_ms, 3))
                event({"done": True, "tokens": n,
                       "ttft_ms": round(handle.ttft_ms, 3)
                       if handle.ttft_ms is not None else None,
                       "latency_ms": round((time.monotonic() - t0) * 1e3,
                                           3)})
            except TimeoutError as e:  # covers DeadlineExceededError
                handle.cancel()
                event({"done": True, "tokens": n, "error": str(e)})
            except Exception as e:  # noqa: BLE001 - surface in-band
                event({"done": True, "tokens": n,
                       "error": f"{type(e).__name__}: {e}"})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            handle.cancel()  # client went away mid-stream: free the slot

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % args)


class ServingServer:
    """HTTP server + engine lifecycle + SIGTERM drain.

    ``start()`` warms the engine and begins serving; ``wait()`` blocks
    until a latched SIGTERM/SIGINT (or ``shutdown()``) finishes the
    graceful drain, and returns 0 on a clean exit.  Signal handlers are
    installed when running on the main thread (the PreemptionGuard
    pattern); off the main thread only programmatic shutdown works.
    """

    def __init__(self, engine: ServingEngine, host="127.0.0.1", port=8866,
                 install_signal_handlers=True, drain_timeout_s=60.0,
                 request_timeout_s=120.0, *, gen_engine=None):
        if engine is None and gen_engine is None:
            raise ValueError("ServingServer needs at least one engine "
                             "(predict and/or generation)")
        self.engine = engine
        self.gen_engine = gen_engine
        self._host = host
        self._requested_port = int(port)
        self._install_signals = install_signal_handlers
        self.drain_timeout_s = drain_timeout_s
        self.request_timeout_s = request_timeout_s
        self._httpd = None
        self._guard = None
        self._threads = []
        self._done = threading.Event()
        self._drain_clean = None
        self._shutdown_once = threading.Lock()
        self._started_at = None

    @property
    def uptime_s(self) -> float:
        return round(time.monotonic() - self._started_at, 1) \
            if self._started_at is not None else 0.0

    # -- input decode ------------------------------------------------------
    def _decode(self, inputs, dtypes=None):
        specs = self.engine._input_specs
        arrays = []
        for i, x in enumerate(inputs):
            if dtypes and i < len(dtypes):
                dt = np.dtype(dtypes[i])
            elif specs and i < len(specs):
                dt = np.dtype(specs[i][1])
            else:
                dt = None
            a = np.asarray(x) if dt is None else np.asarray(x, dtype=dt)
            if a.dtype == object:
                raise ValueError(f"inputs[{i}] is ragged/non-numeric")
            arrays.append(a)
        return arrays

    # -- lifecycle ---------------------------------------------------------
    @property
    def _engines(self):
        return [e for e in (self.engine, self.gen_engine) if e is not None]

    @property
    def draining(self) -> bool:
        return any(e.draining for e in self._engines) or self._done.is_set()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd \
            else self._requested_port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "ServingServer":
        for e in self._engines:
            e.start()
        self._httpd = _HTTPServer((self._host, self._requested_port),
                                  _Handler)
        self._httpd.owner = self
        self._started_at = time.monotonic()
        if self._install_signals:
            # latch, don't die: the handler only sets .preempted — the
            # watcher thread performs the drain (same latch→finish→exit
            # contract as the training runtime)
            self._guard = PreemptionGuard()
            self._guard.__enter__()
        t_serve = threading.Thread(target=self._httpd.serve_forever,
                                   kwargs={"poll_interval": 0.05},
                                   daemon=True, name="paddle-serving-http")
        t_watch = threading.Thread(target=self._watch, daemon=True,
                                   name="paddle-serving-sigwatch")
        self._threads = [t_serve, t_watch]
        t_serve.start()
        t_watch.start()
        logger.info(
            "serving on %s (%s)", self.url,
            ", ".join(f"{b}" for b in [
                self.engine.buckets if self.engine is not None else None,
                f"genserve slots={self.gen_engine.max_slots}"
                if self.gen_engine is not None else None] if b))
        return self

    def _watch(self):
        while not self._done.wait(0.05):
            if self._guard is not None and self._guard.preempted:
                logger.warning("signal %s latched — draining serving "
                               "engine", self._guard.signum)
                self.shutdown()
                return

    def shutdown(self) -> bool:
        """Graceful drain: reject new work, finish queued + in-flight
        requests, close the listener.  Idempotent; returns True when the
        drain completed cleanly."""
        with self._shutdown_once:
            if self._drain_clean is not None:
                return self._drain_clean
            clean = True
            for e in self._engines:
                clean = e.drain(timeout=self.drain_timeout_s) and clean
                e.stop()
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
            if self._guard is not None:
                self._guard.__exit__(None, None, None)
                self._guard = None
            self._drain_clean = clean
            self._done.set()
            logger.info("serving drain %s", "clean" if clean else "TIMED OUT")
            return clean

    def wait(self, timeout=None) -> int:
        """Block until shutdown completes; 0 = clean drain."""
        if not self._done.wait(timeout):
            return -1
        for t in self._threads:
            t.join(5.0)
        return 0 if self._drain_clean else 1

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch serving server (adaptive batching "
                    "over an exported artifact)")
    parser.add_argument("--model", required=True,
                        help="export path prefix (save_inference_model)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8866,
                        help="0 picks a free port (printed on stdout)")
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--timeout-ms", type=float, default=None)
    parser.add_argument("--buckets", default=None,
                        help='e.g. "1,2,4,8" or "1,2,4,8x16,32"')
    parser.add_argument("--queue-depth", type=int, default=None)
    parser.add_argument("--seq-axis", type=int, default=0)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    engine = ServingEngine(args.model, max_batch_size=args.max_batch,
                           batch_timeout_ms=args.timeout_ms,
                           buckets=args.buckets,
                           queue_depth=args.queue_depth,
                           seq_axis=args.seq_axis)
    server = ServingServer(engine, host=args.host, port=args.port).start()
    # parse-friendly readiness line
    print(f"paddle_tpu_torch.serving listening on {server.url}", flush=True)
    return server.wait()


if __name__ == "__main__":
    import sys

    sys.exit(main())
