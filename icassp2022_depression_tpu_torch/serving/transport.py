"""Serving transport: the stdlib HTTP front (port of
:mod:`icassp2022_depression_tpu.serving.transport`).

POST /predict  {"speakers": [{"texts": ["...", "...", "..."],
                              "wav_b64": ["<base64 int16 LE PCM>", ...],
                              "sr": [16000, 16000, 16000],
                              "ordinal_base": 0 (optional)}, ...]}
  -> {"results": [{...}, ...]}   (one dict per speaker, as predict_batch)
POST /predict_bin  the binary variant: a uint32-LE header length, a JSON
  header ({"speakers": [{"n_samples": [...], "sr": [...], "texts": ...,
  "ordinal_base": ...}]}), then every speaker's int16-LE PCM concatenated;
  the waveforms are read-only views over the request body, copied once
  into the extraction's bucket rows.
POST /predict_stream  -> chunked NDJSON, one line per speaker.
GET  /healthz -> {"ok": true, "task": ..., "cache": {hits, misses},
                  "latency": {request, device_batch histograms}}
A :class:`..predictors.DaicPredictor` answers POST /predict with
{"participants": [{"responses_b64": [...], "sr": 16000,
"start_ordinal": 0 (optional), "texts": [...] (multimodal)}, ...]} and GET
/healthz.

By default the server is a single-threaded ``HTTPServer``: one card, one
request at a time.  With ``batch_window_ms > 0`` it is threaded and a
micro-batcher (:class:`_MicroBatcher` / :class:`_DaicMicroBatcher`)
coalesces concurrent requests into one device batch with bounded
admission (:class:`ServerOverloaded` -> 503 + Retry-After); then only the
batcher's worker thread touches the predictor, its feature cache and the
card.  Every predictor call runs under ``torch.inference_mode()`` on the
predictor's device, entered in the thread that makes it (both are per
thread in torch).  A fault of the card (a CUDA error, or its memory
exhausted) is answered 500; every other error a request causes is a 400,
as the JAX package answers it.  In a coalesced batch either is isolated
to the request that caused it.  A CUDA error poisons the process's CUDA
context, so after one ``/healthz`` answers 503 with ``"ok": false`` and
the error, for a load balancer to take the replica out.
"""

from __future__ import annotations

import base64
import contextlib
import hmac
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from icassp2022_depression_tpu_torch.serving.predictors import DaicPredictor


class ServerOverloaded(RuntimeError):
    """Admission rejected: the pending-speaker queue is full.  The HTTP
    front answers 503 + Retry-After, so sustained overload turns into fast
    rejections instead of unbounded latency."""


@contextlib.contextmanager
def predictor_scope(predictor):
    """Inference mode on the predictor's card for the calling thread
    (``torch.inference_mode`` and the current CUDA device are per thread,
    so a worker thread enters them itself)."""
    device = getattr(predictor, "device", None)
    on_card = (torch.cuda.device(device)
               if device is not None and device.type == "cuda"
               else contextlib.nullcontext())
    with torch.inference_mode(), on_card:
        yield


def _cuda_error(exc: Exception) -> bool:
    """A CUDA error: torch raises an ``AcceleratorError`` (before torch
    2.8, a ``RuntimeError`` naming it)."""
    return (isinstance(exc, getattr(torch, "AcceleratorError", ()))
            or (isinstance(exc, RuntimeError) and "CUDA error" in str(exc)))


def _status(exc: Exception) -> int:
    """500 for a fault of the card, 400 for any other error."""
    return (500 if _cuda_error(exc)
            or isinstance(exc, torch.cuda.OutOfMemoryError) else 400)


class LatencyHistogram:
    """Lock-protected fixed-bucket latency histogram (milliseconds), with
    log-spaced upper edges from sub-ms cache hits to multi-second cold
    starts.  ``snapshot`` gives the counts with the mean and the
    interpolated p50 / p90 / p99 that ``/healthz`` reports."""

    EDGES_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                1000.0, 2500.0, 5000.0, 10000.0)

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.EDGES_MS) + 1)  # last: overflow
        self._sum_ms = 0.0
        self._max_ms = 0.0

    def observe(self, seconds: float) -> None:
        ms = seconds * 1000.0
        i = 0
        while i < len(self.EDGES_MS) and ms > self.EDGES_MS[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum_ms += ms
            if ms > self._max_ms:
                self._max_ms = ms

    def _quantile(self, counts, total, q: float) -> float:
        """Interpolated quantile from bucket counts (0 as the first
        bucket's lower edge; the overflow bucket reports its lower
        edge)."""
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= target and c > 0:
                lo = 0.0 if i == 0 else self.EDGES_MS[i - 1]
                if i >= len(self.EDGES_MS):
                    return lo
                hi = self.EDGES_MS[i]
                frac = (target - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self._max_ms

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            sum_ms = self._sum_ms
            max_ms = self._max_ms
        total = sum(counts)
        if total == 0:
            return {"count": 0}
        labels = [f"le_{e:g}ms" for e in self.EDGES_MS] + ["inf"]
        return {
            "count": total,
            "mean_ms": round(sum_ms / total, 3),
            "max_ms": round(max_ms, 3),
            "p50_ms": round(self._quantile(counts, total, 0.50), 3),
            "p90_ms": round(self._quantile(counts, total, 0.90), 3),
            "p99_ms": round(self._quantile(counts, total, 0.99), 3),
            "buckets": {k: c for k, c in zip(labels, counts) if c},
        }


class _MicroBatcher:
    """Coalesces concurrent prediction requests into single device
    batches on one worker thread, the only thread that touches the
    predictor.  ``submit`` blocks the calling (handler) thread until its
    slice of the batched result is ready.

    Admission is bounded at ``max_queue`` pending SPEAKERS: beyond it
    ``submit`` / ``submit_async`` raise :class:`ServerOverloaded` at once.
    Admitted work drains in FIFO order (a request held over because it
    would overflow a batch goes first in the next one), so the worst-case
    queueing latency is ``ceil(max_queue / max_batch)`` rounds of (window
    + one device batch): overload sheds, it never starves an admitted
    request."""

    def __init__(self, predictor, window_s: float, max_batch: int = 32,
                 max_queue: int = 128):
        self.predictor = predictor
        self.window_s = window_s
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.batches_run = 0
        self.requests_served = 0
        self.requests_shed = 0
        #: device-batch latency (one observation per coalesced batch)
        self.batch_latency = LatencyHistogram()
        self._q: queue.Queue = queue.Queue()
        self._held = None   # overflow request carried to the next round
        self._pending = 0   # admitted speakers not yet answered
        self._lock = threading.Lock()
        threading.Thread(target=self._loop, daemon=True,
                         name="micro-batcher").start()

    def submit_async(self, req: dict):
        """Admit (or shed) a request; returns ``(done_event, box)``, where
        ``box`` holds ``results`` or ``error`` once ``done_event`` is set.
        Raises :class:`ServerOverloaded` when admission would exceed
        ``max_queue`` pending speakers, except on an idle queue, where a
        larger request is admitted whole (its retry could never
        succeed)."""
        with self._lock:
            if (self._pending > 0
                    and self._pending + req["n"] > self.max_queue):
                self.requests_shed += 1
                raise ServerOverloaded(
                    f"{self._pending} speakers pending (max_queue="
                    f"{self.max_queue}); retry later")
            self._pending += req["n"]
        done = threading.Event()
        box: dict = {}
        self._q.put((req, done, box))
        return done, box

    def _release(self, n: int) -> None:
        with self._lock:
            self._pending -= n

    def submit(self, req: dict) -> List[dict]:
        """req: {waves, srs, texts, bases, n} (the fields the predictor's
        task does not use may be None)."""
        done, box = self.submit_async(req)
        done.wait()
        if "error" in box:
            raise box["error"]
        return box["results"]

    def _loop(self):
        with predictor_scope(self.predictor):
            while True:
                first = (self._held if self._held is not None
                         else self._q.get())
                self._held = None
                batch = [first]
                total = first[0]["n"]
                deadline = time.monotonic() + self.window_s
                while total < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if total + nxt[0]["n"] > self.max_batch:
                        self._held = nxt   # would overflow: next round
                        break
                    batch.append(nxt)
                    total += nxt[0]["n"]
                self._run(batch)

    @staticmethod
    def _cat(batch, field, fill=None):
        if all(item[0][field] is None for item in batch):
            return None
        out = []
        for req, _, _ in batch:
            vals = req[field]
            out.extend(vals if vals is not None else [fill] * req["n"])
        return out

    def _predict_merged(self, batch) -> List[dict]:
        """Merge a round's requests and run ONE device batch; results in
        request order.  :class:`_DaicMicroBatcher` merges participants."""
        return self.predictor.predict_batch(
            self._cat(batch, "waves"), self._cat(batch, "srs"),
            self._cat(batch, "texts"), self._cat(batch, "bases", fill=0))

    def _run(self, batch):
        t0 = time.monotonic()
        try:
            results = self._predict_merged(batch)
            self.batch_latency.observe(time.monotonic() - t0)
            self.batches_run += 1
            pos = 0
            for req, done, box in batch:
                box["results"] = results[pos:pos + req["n"]]
                pos += req["n"]
                self.requests_served += 1
                self._release(req["n"])
                done.set()
        except Exception:
            # one bad request must not fail unrelated clients: retry each
            # request alone, so only the one at fault errors
            for req, done, box in batch:
                try:
                    t1 = time.monotonic()
                    box["results"] = self._predict_merged([(req, done,
                                                            box)])
                    self.batch_latency.observe(time.monotonic() - t1)
                    self.batches_run += 1
                    self.requests_served += 1
                except Exception as exc:
                    box["error"] = exc
                self._release(req["n"])
                done.set()


class _DaicMicroBatcher(_MicroBatcher):
    """The micro-batcher of a :class:`DaicPredictor`: a round's
    participants (ragged response lists) run as ONE ``predict_signals``
    call, padded to the round's largest response count on the device.
    Request: ``{"signals": [[resp, ...], ...], "srs": [...], "starts":
    [...] | None, "texts": [[str, ...], ...] | None (multimodal), "n":
    k}``."""

    def _predict_merged(self, batch) -> List[dict]:
        texts = (self._cat(batch, "texts")
                 if self.predictor.multimodal else None)
        return self.predictor.predict_signals(
            self._cat(batch, "signals"), self._cat(batch, "srs"),
            self._cat(batch, "starts", fill=0), texts)


def make_http_server(predictor, host: str = "127.0.0.1", port: int = 8000,
                     batch_window_ms: float = 0.0, max_batch: int = 32,
                     max_queue: int = 128,
                     auth_token: Optional[str] = None,
                     tls_cert: Optional[str] = None,
                     tls_key: Optional[str] = None):
    """Build (not start) an ``http.server`` around a :class:`Predictor` or
    :class:`DaicPredictor` (the endpoints in the module docstring).  With
    ``batch_window_ms > 0`` the server is threaded and concurrent requests
    micro-batch into single device calls, admission bounded at
    ``max_queue`` pending speakers.  ``/predict_stream`` answers NDJSON
    over chunked transfer encoding, one line per speaker as its result is
    ready (each speaker goes to the batcher on its own).

    ``auth_token`` requires ``Authorization: Bearer <token>`` on every
    prediction endpoint (401 otherwise); ``GET /healthz`` stays open.
    ``tls_cert`` / ``tls_key`` (PEM paths) serve HTTPS.  Call
    ``.serve_forever()`` to run."""
    is_daic = isinstance(predictor, DaicPredictor)
    batcher_cls = _DaicMicroBatcher if is_daic else _MicroBatcher
    batcher = (batcher_cls(predictor, batch_window_ms / 1000.0, max_batch,
                           max_queue)
               if batch_window_ms > 0 else None)
    request_latency = LatencyHistogram()   # end-to-end handler latency
    cuda_errors: list = []      # appended from any handler thread

    def answer_status(exc: Exception) -> int:
        if _cuda_error(exc):
            cuda_errors.append(f"{type(exc).__name__}: {exc}")
        return _status(exc)

    def direct(fn, *args):
        """A predictor call on the handler's own thread (the
        single-threaded server)."""
        with predictor_scope(predictor):
            return fn(*args)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 (keep-alive + chunked streaming) only on the threaded
        # server: on the single-threaded HTTPServer a kept-alive client
        # would pin serve_forever in its connection and wedge shutdown();
        # there /predict_stream falls back to read-until-close
        protocol_version = ("HTTP/1.1" if batcher is not None
                            else "HTTP/1.0")

        def _send(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _error(self, exc: Exception) -> None:
            self._send(answer_status(exc),
                       {"error": f"{type(exc).__name__}: {exc}"})

        def _authorized(self) -> bool:
            """Bearer-token gate on the prediction endpoints, compared in
            constant time."""
            if auth_token is None:
                return True
            # compare as bytes: http.server decodes headers as latin-1,
            # and compare_digest raises TypeError on non-ASCII str
            got = self.headers.get("Authorization", "").encode("latin-1")
            if hmac.compare_digest(got,
                                   f"Bearer {auth_token}".encode("utf-8")):
                return True
            # drain the unread body so a kept-alive connection's next
            # request does not start mid-payload; a client that closes
            # early returns b'' (EOF): stop, never spin
            remaining = int(self.headers.get("Content-Length", "0"))
            while remaining > 0:
                got_bytes = self.rfile.read(min(remaining, 1 << 20))
                if not got_bytes:
                    self.close_connection = True
                    break
                remaining -= len(got_bytes)
            self._send(401, {"error": "missing or invalid bearer token"},
                       headers=(("WWW-Authenticate", "Bearer"),))
            return False

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            payload = {
                "ok": True, "task": predictor.task,
                "latency": {"request": request_latency.snapshot()},
                "cache": {"hits": predictor.feature_cache.hits,
                          "misses": predictor.feature_cache.misses}}
            if batcher is not None:
                payload["batcher"] = {
                    "batches_run": batcher.batches_run,
                    "requests_served": batcher.requests_served,
                    "requests_shed": batcher.requests_shed,
                    "pending": batcher._pending,
                    "max_queue": batcher.max_queue}
                payload["latency"]["device_batch"] = (
                    batcher.batch_latency.snapshot())
            if cuda_errors:
                payload.update(ok=False, cuda_errors=len(cuda_errors),
                               first_cuda_error=cuda_errors[0])
            self._send(503 if cuda_errors else 200, payload)

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length",
                                                        "0")))

        def _fields(self, speakers, waves):
            """(srs, texts, bases) of a request's speakers."""
            srs = texts = bases = None
            if not predictor.task.startswith("text"):
                srs = [sp["sr"] for sp in speakers]
            if not predictor.task.startswith("audio"):
                texts = [sp["texts"] for sp in speakers]
            if any("ordinal_base" in sp for sp in speakers):
                bases = [int(sp.get("ordinal_base", 0))
                         for sp in speakers]
            return len(speakers), waves, srs, texts, bases

        def _parse(self):
            speakers = json.loads(self._body())["speakers"]
            waves = None
            if not predictor.task.startswith("text"):
                waves = [[np.frombuffer(base64.b64decode(b), np.int16)
                          for b in sp["wav_b64"]] for sp in speakers]
            return self._fields(speakers, waves)

        def _parse_bin(self):
            """``/predict_bin``: a uint32-LE header-length prefix, a JSON
            header, then every speaker's int16-LE PCM in order.  The
            waveforms are read-only ``np.frombuffer`` views over the body;
            extraction copies them into its own bucket rows."""
            body = self._body()
            if len(body) < 4:
                raise ValueError("binary body shorter than the uint32 "
                                 "header-length prefix")
            hlen = int.from_bytes(body[:4], "little")
            speakers = json.loads(body[4:4 + hlen].decode("utf-8"))[
                "speakers"]
            off = 4 + hlen
            waves = None
            if not predictor.task.startswith("text"):
                waves = []
                for sp in speakers:
                    w = []
                    for ns in sp["n_samples"]:
                        ns = int(ns)
                        if ns < 0:   # count -1 would read "all remaining
                            # bytes", aliasing already-consumed payload
                            raise ValueError(f"negative n_samples {ns}")
                        # a body shorter than the header says raises here
                        w.append(np.frombuffer(body, np.int16, ns, off))
                        off += 2 * ns
                    waves.append(w)
            return self._fields(speakers, waves)

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def _post_daic(self):
            """One ragged response list per participant, answered like
            /predict; with a batch window concurrent requests coalesce into
            one padded device batch (admission bounded in
            participants)."""
            if self.path != "/predict":
                self._send(404, {"error": "DAIC serving exposes /predict "
                                          "and /healthz only"})
                return
            t0 = time.monotonic()
            try:
                parts = json.loads(self._body())["participants"]
                signals = [[np.frombuffer(base64.b64decode(b), np.int16)
                            for b in sp["responses_b64"]] for sp in parts]
                srs = [int(sp["sr"]) for sp in parts]
                starts = ([int(sp.get("start_ordinal", 0)) for sp in parts]
                          if any("start_ordinal" in sp for sp in parts)
                          else None)
                texts = None
                if predictor.multimodal:
                    texts = [sp["texts"] for sp in parts]  # KeyError: 400
                if batcher is not None:
                    results = batcher.submit(
                        {"signals": signals, "srs": srs, "starts": starts,
                         "texts": texts, "n": len(parts)})
                else:
                    results = direct(predictor.predict_signals, signals,
                                     srs, starts, texts)
                request_latency.observe(time.monotonic() - t0)
                self._send(200, {"results": results})
            except ServerOverloaded as exc:
                self._send(503, {"error": f"overloaded: {exc}"},
                           headers=(("Retry-After", "1"),))
            except Exception as exc:
                self._error(exc)

        def do_POST(self):
            if not self._authorized():
                return
            if is_daic:
                self._post_daic()
                return
            if self.path == "/predict_stream":
                self._post_stream()
                return
            if self.path not in ("/predict", "/predict_bin"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            t0 = time.monotonic()
            try:
                n, waves, srs, texts, bases = (
                    self._parse_bin() if self.path == "/predict_bin"
                    else self._parse())
                if batcher is not None:
                    results = batcher.submit(
                        {"waves": waves, "srs": srs, "texts": texts,
                         "bases": bases, "n": n})
                else:
                    results = direct(predictor.predict_batch, waves, srs,
                                     texts, bases)
                request_latency.observe(time.monotonic() - t0)
                self._send(200, {"results": results})
            except ServerOverloaded as exc:   # shed load, invite a retry
                self._send(503, {"error": f"overloaded: {exc}"},
                           headers=(("Retry-After", "1"),))
            except Exception as exc:   # answer as JSON, keep serving
                self._error(exc)

        def _post_stream(self):
            """NDJSON chunked streaming: one ``{"index", "result"}`` (or
            ``{"index", "error"}``) line per speaker, written when that
            speaker's micro-batch completes."""
            try:
                n, waves, srs, texts, bases = self._parse()
            except Exception as exc:
                self._error(exc)
                return
            # chunked framing needs BOTH sides on HTTP/1.1: an HTTP/1.0
            # client would read the hex chunk-size lines as body bytes
            chunked = (self.protocol_version >= "HTTP/1.1"
                       and self.request_version >= "HTTP/1.1")
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            if chunked:
                self.send_header("Transfer-Encoding", "chunked")
            else:  # HTTP/1.0: stream raw lines, client reads until close
                self.close_connection = True
            self.end_headers()

            def one(i):
                return {"waves": None if waves is None else [waves[i]],
                        "srs": None if srs is None else [srs[i]],
                        "texts": None if texts is None else [texts[i]],
                        "bases": None if bases is None else [bases[i]],
                        "n": 1}

            def write_line(i, box):
                if "error" in box:
                    answer_status(box["error"])
                    line = {"index": i, "error": str(box["error"])}
                else:
                    line = {"index": i, "result": box["results"][0]}
                data = (json.dumps(line) + "\n").encode("utf-8")
                if chunked:
                    self._chunk(data)
                else:
                    self.wfile.write(data)

            # submit speakers as capacity allows; when admission sheds,
            # drain (and stream out) our own oldest in-flight speaker to
            # free a slot and retry: a stream never 503s its own speakers,
            # only a queue full of OTHER clients' work with nothing of
            # ours in flight sheds a line
            t0 = time.monotonic()
            pending: list = []
            next_out = 0
            i = 0
            while i < n or next_out < len(pending):
                if i < n:
                    if batcher is not None:
                        try:
                            pending.append((i,) +
                                           batcher.submit_async(one(i)))
                            i += 1
                            continue
                        except ServerOverloaded as exc:
                            if next_out >= len(pending):  # none in flight
                                pending.append((i, None, {
                                    "error": RuntimeError(
                                        f"overloaded: {exc}")}))
                                i += 1
                                continue
                            # fall through: drain our oldest, then retry i
                    else:
                        box = {}
                        r = one(i)
                        try:
                            box["results"] = direct(
                                predictor.predict_batch, r["waves"],
                                r["srs"], r["texts"], r["bases"])
                        except Exception as exc:
                            box["error"] = exc
                        pending.append((i, None, box))
                        i += 1
                        continue
                idx, done, box = pending[next_out]
                if done is not None:
                    done.wait()
                write_line(idx, box)
                next_out += 1
            request_latency.observe(time.monotonic() - t0)
            if chunked:
                self._chunk(b"")  # terminating chunk

    if tls_cert is not None:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert, tls_key)

        class Handler(Handler):  # noqa: F811 - the TLS variant
            def setup(self):
                # handshake here, in the handler's thread, not in the
                # accept loop: a client that connects and sends no
                # ClientHello must not block serve_forever; bounded so a
                # silent peer releases the thread
                old = self.request.gettimeout()
                self.request.settimeout(30.0)
                self.request.do_handshake()
                self.request.settimeout(old)
                super().setup()

    server_cls = ThreadingHTTPServer if batcher is not None else HTTPServer
    server = server_cls((host, port), Handler)
    if tls_cert is not None:
        server.socket = ctx.wrap_socket(server.socket, server_side=True,
                                        do_handshake_on_connect=False)
    return server


def serve_http(predictor, host: str = "127.0.0.1", port: int = 8000,
               batch_window_ms: float = 0.0, max_batch: int = 32,
               max_queue: int = 128, auth_token: Optional[str] = None,
               tls_cert: Optional[str] = None,
               tls_key: Optional[str] = None) -> None:
    """Serve until interrupted (``cli serve``)."""
    server = make_http_server(predictor, host, port, batch_window_ms,
                              max_batch, max_queue, auth_token, tls_cert,
                              tls_key)
    mode = (f"micro-batching ({batch_window_ms} ms window, max {max_batch}, "
            f"queue bound {max_queue})"
            if batch_window_ms > 0 else "single-threaded")
    if auth_token is not None:
        mode += ", bearer auth"
    scheme = "https" if tls_cert is not None else "http"
    endpoints = ("POST /predict; GET /healthz"
                 if isinstance(predictor, DaicPredictor)
                 else "POST /predict, /predict_bin, /predict_stream; "
                      "GET /healthz")
    print(f"serving {predictor.task} on {scheme}://{host}:{port} "
          f"({endpoints}; {mode})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()

