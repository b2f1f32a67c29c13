"""Minimal stdlib client for the serving HTTP API (port of
paddle_tpu/serving/client.py, whole; ``generate``/``generate_stream`` also
take ``resume_pos=``, which the server's /generate reads).

`ServingClient` wraps /predict, /generate (blocking and token-streaming
SSE), /healthz, and /metrics with urllib.request (no dependencies —
usable from any host that can reach the server).  The __main__ entry
(``python -m paddle_tpu_torch.serving.client --url URL ...``) is a load
generator: N requests from K
threads — pure /predict, pure streaming /generate, or a mixed blend —
then a one-line JSON summary on stdout (with client-side TTFT and
inter-token quantiles for generation traffic).  `--mixed-wave L:S@LL,SL`
interleaves long and short prompts at a fixed ratio and reports
per-class percentiles — the one-flag probe for "does chunked prefill
hold short streams' inter-token p99 while a long prompt streams in".

Tracing: when the process tracer is enabled (FLAGS_trace_sample_rate >
0) every predict/generate starts a client-side root span and sends its
W3C `traceparent` header, so the server's queue/prefill/decode spans
join the caller's trace; the head-sampling decision is derived from the
trace_id, so client and server agree without coordination.  Pass
`traceparent=` explicitly to join an existing trace instead; the header
actually sent is kept on `client.last_traceparent`.
"""
from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from ..monitor import tracing as _tracing

__all__ = ["ServingClient", "ServingHTTPError"]


class ServingHTTPError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ServingClient:
    def __init__(self, url: str, timeout: float = 30.0, tracer=None,
                 retries: int = 0, retry_backoff_s: float = 0.05):
        """`retries` > 0 turns on client-side retry of IDEMPOTENT
        non-streaming requests (predict, blocking generate, GETs): a
        connection reset or replica 5xx is retried up to `retries` times
        with jittered exponential backoff, and a 429's `Retry-After`
        header is honored as the wait.  504 (deadline) is never retried
        — the deadline is just as blown on attempt two.  Streaming
        generate is NOT retried here: mid-stream resume is the router's
        job (journaled failover), not the client's.  Default 0 keeps the
        historical raise-on-first-failure behavior."""
        self.base = url.rstrip("/")
        self.timeout = timeout
        self._tracer = tracer
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.last_traceparent = None  # header sent on the last request
        self._tls = threading.local()  # per-thread attempt accounting

    @property
    def last_attempts(self) -> int:
        """Attempts the calling thread's last request took (>=1)."""
        return getattr(self._tls, "attempts", 1)

    @property
    def tracer(self):
        return self._tracer if self._tracer is not None \
            else _tracing.default_tracer()

    def _start_span(self, name: str, traceparent, attrs=None):
        """(span, header) for one outgoing request: an explicit
        `traceparent=` is forwarded as-is (the caller owns that span);
        otherwise a client root span supplies the header."""
        if traceparent is not None:
            self.last_traceparent = traceparent
            return None, traceparent
        tracer = self.tracer
        if not tracer.enabled:
            self.last_traceparent = None
            return None, None
        span = tracer.start_span(name, attrs=attrs)
        self.last_traceparent = span.traceparent
        return span, span.traceparent

    def _retry_delay(self, attempt: int, retry_after=None) -> float:
        if retry_after is not None:
            try:
                return float(retry_after) * (1.0 + 0.1 * random.random())
            except (TypeError, ValueError):
                pass
        return self.retry_backoff_s * attempt * (0.5 + random.random())

    def _request(self, path: str, body=None, traceparent=None):
        headers = {"Content-Type": "application/json"}
        if traceparent:
            headers["traceparent"] = traceparent
        data = json.dumps(body).encode() if body is not None else None
        attempt = 0
        while True:
            attempt += 1
            self._tls.attempts = attempt
            req = urllib.request.Request(
                self.base + path, data=data, headers=headers,
                method="POST" if body is not None else "GET")
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:  # non-2xx carries a body
                raw = e.read()
                # 429 waits out Retry-After; transient 5xx backs off;
                # 504 means the deadline is gone either way
                retryable = e.code == 429 or (e.code >= 500
                                              and e.code != 504)
                if attempt <= self.retries and retryable:
                    time.sleep(self._retry_delay(
                        attempt, e.headers.get("Retry-After")
                        if e.code == 429 else None))
                    continue
                return e.code, raw
            except OSError:  # connection reset/refused (URLError too)
                if attempt <= self.retries:
                    time.sleep(self._retry_delay(attempt))
                    continue
                raise

    def predict(self, inputs, dtypes=None, deadline_ms=None,
                traceparent=None):
        """inputs: list of single-sample arrays/nested lists (no batch
        dim).  Returns list of numpy outputs; raises ServingHTTPError on
        backpressure (429), draining (503), deadline (504)."""
        body = {"inputs": [np.asarray(x).tolist() for x in inputs]}
        if dtypes:
            body["dtypes"] = [str(d) for d in dtypes]
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        span, header = self._start_span(
            "client.predict", traceparent, attrs={"n_inputs": len(inputs)})
        status, raw = self._request("/predict", body, traceparent=header)
        if span is not None:
            span.set_attr("http_status", status)
            span.end(status="ok" if status == 200 else "error")
        if status != 200:
            # status decides FIRST: a proxy's non-JSON 502/504 body must
            # surface as ServingHTTPError, not a JSONDecodeError
            try:
                detail = json.loads(raw or b"{}").get("error", "?")
            except ValueError:
                detail = (raw or b"").decode(errors="replace")[:200]
            raise ServingHTTPError(status, detail)
        payload = json.loads(raw or b"{}")
        return [np.asarray(o, dtype=np.dtype(dt)) for o, dt in
                zip(payload["outputs"], payload["dtypes"])]

    def _gen_body(self, prompt, max_new_tokens, do_sample, temperature,
                  top_k, seed, eos_token_id, deadline_ms, stream,
                  resume_pos=0):
        body = {"prompt": [int(t) for t in prompt],
                "max_new_tokens": int(max_new_tokens),
                "do_sample": bool(do_sample),
                "temperature": float(temperature), "top_k": int(top_k),
                "seed": int(seed), "stream": stream}
        if resume_pos:
            body["resume_pos"] = int(resume_pos)
        if eos_token_id is not None:
            body["eos_token_id"] = int(eos_token_id)
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        return body

    def generate(self, prompt, max_new_tokens=32, *, do_sample=False,
                 temperature=1.0, top_k=0, seed=0, eos_token_id=None,
                 deadline_ms=None, traceparent=None, resume_pos=0) -> dict:
        """Blocking generation: {"tokens": [...], "ttft_ms",
        "latency_ms"}.  Raises ServingHTTPError on 429/503/504.
        ``resume_pos`` continues a stream cut after that many tokens (the
        prompt then ends with them)."""
        span, header = self._start_span(
            "client.generate", traceparent,
            attrs={"prompt_len": len(prompt),
                   "max_new_tokens": int(max_new_tokens)})
        status, raw = self._request("/generate", self._gen_body(
            prompt, max_new_tokens, do_sample, temperature, top_k, seed,
            eos_token_id, deadline_ms, stream=False, resume_pos=resume_pos),
            traceparent=header)
        if span is not None:
            span.set_attr("http_status", status)
            span.end(status="ok" if status == 200 else "error")
        if status != 200:
            try:
                detail = json.loads(raw or b"{}").get("error", "?")
            except ValueError:
                detail = (raw or b"").decode(errors="replace")[:200]
            raise ServingHTTPError(status, detail)
        return json.loads(raw or b"{}")

    def generate_stream(self, prompt, max_new_tokens=32, *,
                        do_sample=False, temperature=1.0, top_k=0, seed=0,
                        eos_token_id=None, deadline_ms=None,
                        traceparent=None, resume_pos=0):
        """Streaming generation: yields one event dict per SSE frame as
        the server's decode loop produces it — {"token": t} per decoded
        token, then a final {"done": true, "tokens": n, ...} (which
        carries "error" when the request failed mid-decode).  Admission
        failures (429/503) raise ServingHTTPError before the first
        yield."""
        span, header = self._start_span(
            "client.generate_stream", traceparent,
            attrs={"prompt_len": len(prompt),
                   "max_new_tokens": int(max_new_tokens)})
        self._tls.attempts = 1  # streaming never client-retries
        headers = {"Content-Type": "application/json"}
        if header:
            headers["traceparent"] = header
        req = urllib.request.Request(
            self.base + "/generate",
            data=json.dumps(self._gen_body(
                prompt, max_new_tokens, do_sample, temperature, top_k,
                seed, eos_token_id, deadline_ms, stream=True,
                resume_pos=resume_pos)).encode(),
            headers=headers, method="POST")
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read() or b"{}").get("error", "?")
            except ValueError:
                detail = "?"
            if span is not None:
                span.set_attr("http_status", e.code)
                span.end(status="error")
            raise ServingHTTPError(e.code, detail) from None
        ntok = 0
        try:
            with resp:
                for line in resp:  # urllib undoes the chunked framing
                    line = line.strip()
                    if not line.startswith(b"data: "):
                        continue
                    evt = json.loads(line[len(b"data: "):])
                    if "token" in evt:
                        ntok += 1
                        if span is not None and ntok == 1:
                            span.event("first_token")
                    yield evt
                    if evt.get("done"):
                        return
        finally:
            if span is not None:
                span.set_attr("tokens", ntok)
                span.end()

    def healthz(self) -> dict:
        status, raw = self._request("/healthz")
        return {"status_code": status, **json.loads(raw or b"{}")}

    def metrics(self) -> str:
        status, raw = self._request("/metrics")
        if status != 200:
            raise ServingHTTPError(status, raw.decode(errors="replace"))
        return raw.decode()


def main(argv=None):
    import argparse
    import threading

    parser = argparse.ArgumentParser(description="serving load generator")
    parser.add_argument("--url", required=True)
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--concurrency", type=int, default=4)
    parser.add_argument("--mode", default="predict",
                        choices=("predict", "generate", "mixed"),
                        help="traffic blend: /predict, streaming "
                             "/generate, or alternating both")
    parser.add_argument("--shape", default="8",
                        help="comma-separated SAMPLE shape, e.g. '16' or "
                             "'16,8' (no batch dim) — predict traffic")
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--prompt-len", type=int, default=8,
                        help="generate traffic: prompt token count")
    parser.add_argument("--max-new", type=int, default=16,
                        help="generate traffic: max_new_tokens")
    parser.add_argument("--vocab", type=int, default=200,
                        help="generate traffic: prompt id upper bound")
    parser.add_argument("--sample", action="store_true",
                        help="generate traffic: temperature/top-k "
                             "sampling instead of greedy")
    parser.add_argument("--shared-prefix-len", type=int, default=0,
                        help="generate traffic: every prompt starts with "
                             "the SAME fixed-seed token prefix of this "
                             "length (exercises the server's prefix "
                             "cache), followed by a random suffix")
    parser.add_argument("--mixed-wave", default=None, metavar="L:S@LL,SL",
                        help="generate traffic: mix of long and short "
                             "prompts — 'L:S@LL,SL' sends L long (LL "
                             "tokens) per S short (SL tokens) prompts, "
                             "e.g. '1:4@48,8', and the summary reports "
                             "per-class ttft/inter-token percentiles "
                             "(the chunked-prefill p99 claim in one "
                             "flag); overrides --prompt-len")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--retries", type=int, default=0,
                        help="client-side retries for idempotent "
                             "non-streaming requests (connection reset, "
                             "replica 5xx, Retry-After on 429)")
    args = parser.parse_args(argv)

    wave = None
    if args.mixed_wave:
        try:
            ratio, lens = args.mixed_wave.split("@")
            n_long, n_short = (int(x) for x in ratio.split(":"))
            len_long, len_short = (int(x) for x in lens.split(","))
            if min(n_long, n_short, len_long, len_short) < 1 \
                    or len_long <= len_short:
                raise ValueError
        except ValueError:
            parser.error("--mixed-wave must be 'L:S@LONGLEN,SHORTLEN' "
                         "with LONGLEN > SHORTLEN >= 1, e.g. '1:4@48,8'")
        wave = (n_long, n_short, len_long, len_short)

    shared_prefix = []
    if args.shared_prefix_len > 0:
        if args.shared_prefix_len >= args.prompt_len:
            parser.error("--shared-prefix-len must be < --prompt-len "
                         "(at least one random suffix token)")
        shared_prefix = [int(t) for t in np.random.RandomState(1234)
                         .randint(1, args.vocab, args.shared_prefix_len)]

    shape = tuple(int(d) for d in args.shape.split(",") if d.strip())
    client = ServingClient(args.url, retries=args.retries)
    results = {"ok": 0, "backpressure": 0, "errors": 0}
    attempts: list[int] = []
    ttfts, gaps = {"all": []}, {"all": []}
    if wave:
        for cls in ("long", "short"):
            ttfts[cls], gaps[cls] = [], []
    gen_tokens = [0]
    lock = threading.Lock()

    def predict_once(rs):
        x = (rs.randint(0, 100, shape) if "int" in args.dtype
             else rs.randn(*shape)).astype(args.dtype)
        client.predict([x])

    def wave_class(i: int) -> str:
        """Deterministic long/short interleave: the first `n_long` of
        every (n_long + n_short)-request cycle are long."""
        n_long, n_short = wave[0], wave[1]
        return "long" if i % (n_long + n_short) < n_long else "short"

    def generate_once(rs, cls=None):
        plen = args.prompt_len if cls is None \
            else (wave[2] if cls == "long" else wave[3])
        n_rand = plen - len(shared_prefix)
        prompt = shared_prefix + [int(t) for t in rs.randint(1, args.vocab,
                                                             n_rand)]
        t0 = last = time.perf_counter()
        ntok = 0
        my_ttft, my_gaps, err = None, [], None
        for evt in client.generate_stream(
                prompt, args.max_new, do_sample=args.sample,
                temperature=0.8, top_k=5,
                seed=int(rs.randint(1 << 30))):
            now = time.perf_counter()
            if "token" in evt:
                ntok += 1
                if my_ttft is None:
                    my_ttft = now - t0
                else:
                    my_gaps.append(now - last)
                last = now
            if evt.get("done"):
                err = evt.get("error")
        with lock:
            gen_tokens[0] += ntok
            for k in ("all",) + ((cls,) if cls else ()):
                if my_ttft is not None:
                    ttfts[k].append(my_ttft * 1e3)
                gaps[k].extend(g * 1e3 for g in my_gaps)
        if err:
            raise ServingHTTPError(200, err)

    def worker(wid: int, n: int):
        rs = np.random.RandomState(args.seed + wid)
        for i in range(n):
            gen = (args.mode == "generate"
                   or (args.mode == "mixed" and (wid + i) % 2 == 0))
            cls = wave_class(wid + i) if (wave and gen) else None
            try:
                if gen:
                    generate_once(rs, cls)
                else:
                    predict_once(rs)
                key = "ok"
            except ServingHTTPError as e:
                key = "backpressure" if e.status == 429 else "errors"
            except Exception:  # noqa: BLE001
                key = "errors"
            with lock:
                results[key] += 1
                attempts.append(client.last_attempts)

    per = [args.requests // args.concurrency] * args.concurrency
    for i in range(args.requests % args.concurrency):
        per[i] += 1
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i, n))
               for i, n in enumerate(per) if n]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results["elapsed_s"] = round(time.perf_counter() - t0, 3)
    results["client_qps"] = round(results["ok"] /
                                  max(results["elapsed_s"], 1e-9), 1)
    if attempts:
        # attempts-per-request percentiles: >1 means the fleet made the
        # client work for its answer (retried resets / Retry-After)
        results["attempts_p50"] = round(
            float(np.percentile(attempts, 50)), 2)
        results["attempts_p99"] = round(
            float(np.percentile(attempts, 99)), 2)
        results["attempts_max"] = int(max(attempts))
    if args.mode in ("generate", "mixed"):
        results["gen_tokens"] = gen_tokens[0]
        results["client_tokens_per_sec"] = round(
            gen_tokens[0] / max(results["elapsed_s"], 1e-9), 1)

        def pct(xs, q):
            return round(float(np.percentile(xs, q)), 3) if xs else None

        results["ttft_p50_ms"] = pct(ttfts["all"], 50)
        results["inter_token_p50_ms"] = pct(gaps["all"], 50)
        results["inter_token_p99_ms"] = pct(gaps["all"], 99)
        if wave:
            # per-class percentiles: the chunked-prefill claim is that
            # SHORT streams' inter-token p99 stays flat while LONG
            # prompts prefill — per-class is the only way to see it
            for cls in ("long", "short"):
                results[f"{cls}_ttft_p50_ms"] = pct(ttfts[cls], 50)
                results[f"{cls}_ttft_p99_ms"] = pct(ttfts[cls], 99)
                results[f"{cls}_inter_token_p50_ms"] = pct(gaps[cls], 50)
                results[f"{cls}_inter_token_p99_ms"] = pct(gaps[cls], 99)
    print(json.dumps(results), flush=True)
    return 0 if results["errors"] == 0 else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
