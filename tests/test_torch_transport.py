"""The port's HTTP serving front (``serving/transport.py``) against the JAX
package's: one case for each HTTP test of the JAX ``tests/test_serve.py``
and ``tests/test_daic_train.py``, each holding what the port serves
against what the JAX package serves for the same checkpoint (1e-5), plus
the port's own contract: a fault of the card (a CUDA error, or its memory
exhausted) is a 500 isolated to its request, a CUDA error turns /healthz
to 503, any other predictor error is a 400 as in the JAX package, and the
micro-batcher's worker calls the predictor under inference mode.

Both servers run in this process on ephemeral ports, on the CPU (the
plain recurrences), at small widths."""

import base64
import contextlib
import http.client
import json
import socket
import ssl
import subprocess
import threading
import time

import jax
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import elmo as jelmo
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.serving import transport as jtransport
from icassp2022_depression_tpu.serving.predictors import (
    DaicPredictor as JDaicPredictor,
)
from icassp2022_depression_tpu.serving.predictors import Predictor as JPredictor
from icassp2022_depression_tpu.train import daic as jdaic
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import elmo as telmo
from icassp2022_depression_tpu_torch.serving import transport as ttransport
from icassp2022_depression_tpu_torch.serving.predictors import (
    DaicPredictor,
    Predictor,
)
from icassp2022_depression_tpu_torch.train import checkpoints as tcheckpoints
from icassp2022_depression_tpu_torch.train import daic as tdaic

ATOL = 1e-5
SMALL_FE = dict(n_fft=256, hop_length=64, n_mels=16, netvlad_clusters=4,
                netvlad_output_dim=32)
SMALL_NET = dict(embedding_size=32, hidden_dims=16)
ECFG = dict(vocab_size=64, embed_dim=8, hidden=4, layers=1, output_dim=8)
SR = 16000


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _audio_pair(seed, task="audio_clf"):
    """(JAX, port) predictors of one seeded small audio model."""
    preset = "AUDIO_CLF" if task == "audio_clf" else "AUDIO_REG"
    jcfg = jconfig.replace(getattr(jconfig, preset).model, **SMALL_NET)
    tcfg = tconfig.replace(getattr(tconfig, preset).model, **SMALL_NET)
    params = jaudio_net.init(jax.random.PRNGKey(seed), jcfg)
    jp = JPredictor(params, task, model_cfg=jcfg,
                    frontend_cfg=jconfig.FrontendConfig(**SMALL_FE))
    tp = Predictor(tcheckpoints.load_model(_tree(params), "audio", tcfg,
                                           "cpu"), task,
                   frontend_cfg=tconfig.FrontendConfig(**SMALL_FE),
                   device="cpu")
    return jp, tp


def _fuse_pair(seed):
    """(JAX, port) ``fuse_clf`` predictors: a small fusion over the small
    audio features and the seeded stand-in text encoder."""
    kw = dict(audio_embed_size=32, text_embed_size=8, audio_hidden_dims=16,
              text_hidden_dims=8)
    jcfg = jconfig.replace(jconfig.FUSE_CLF, **kw)
    tcfg = tconfig.replace(tconfig.FUSE_CLF, **kw)
    params = jfusion.init(jax.random.PRNGKey(seed), jcfg)
    jp = JPredictor(params, "fuse_clf", model_cfg=jcfg, elmo_weights=None,
                    elmo_cfg=jelmo.ElmoConfig(**ECFG),
                    frontend_cfg=jconfig.FrontendConfig(**SMALL_FE))
    tp = Predictor(tcheckpoints.load_model(_tree(params), "fusion", tcfg,
                                           "cpu"), "fuse_clf",
                   elmo_weights=None, elmo_cfg=telmo.ElmoConfig(**ECFG),
                   frontend_cfg=tconfig.FrontendConfig(**SMALL_FE),
                   device="cpu")
    return jp, tp


def _daic_pair(seed, multimodal=False):
    emb = 32 + (8 if multimodal else 0)
    jm = jconfig.replace(jdaic.DAIC_CLF.model, embedding_size=emb,
                         hidden_dims=16)
    tm = tconfig.replace(tdaic.DAIC_CLF.model, embedding_size=emb,
                         hidden_dims=16)
    params = jaudio_net.init(jax.random.PRNGKey(seed), jm)
    kw = {}
    if multimodal:
        kw = dict(multimodal=True, elmo_weights=None)
    jp = JDaicPredictor(params, "daic_clf",
                        tcfg=jconfig.replace(jdaic.DAIC_CLF, model=jm),
                        frontend_cfg=jconfig.FrontendConfig(**SMALL_FE),
                        elmo_cfg=jelmo.ElmoConfig(**ECFG) if multimodal
                        else None, **kw)
    tp = DaicPredictor(tcheckpoints.load_model(_tree(params), "audio", tm,
                                               "cpu"), "daic_clf",
                       tcfg=tconfig.replace(tdaic.DAIC_CLF, model=tm),
                       frontend_cfg=tconfig.FrontendConfig(**SMALL_FE),
                       elmo_cfg=telmo.ElmoConfig(**ECFG) if multimodal
                       else None, device="cpu", **kw)
    return jp, tp


@contextlib.contextmanager
def _serving(make, predictor, **kw):
    """A server on an ephemeral port in a thread; its port."""
    server = make(predictor, port=0, **kw)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
        assert not t.is_alive()


@contextlib.contextmanager
def _both(jp, tp, **kw):
    with _serving(jtransport.make_http_server, jp, **kw) as jport, \
            _serving(ttransport.make_http_server, tp, **kw) as tport:
        yield jport, tport


def _speaker(rng, seconds=0.3):
    wavs = [np.round(rng.standard_normal(int(SR * seconds)) * 2000)
            .astype(np.int16) for _ in range(3)]
    return wavs, [SR] * 3, ["我 今天 很 好", "还 可以", "有点 累"]


def _body(speakers, texts=False):
    return json.dumps({"speakers": [
        dict({"wav_b64": [base64.b64encode(w.tobytes()).decode()
                          for w in wavs], "sr": srs},
             **({"texts": t} if texts else {}))
        for wavs, srs, t in speakers]})


def _request(port, method, path, body=None, headers=None, timeout=120,
             context=None):
    conn = (http.client.HTTPSConnection("127.0.0.1", port, timeout=timeout,
                                        context=context) if context
            else http.client.HTTPConnection("127.0.0.1", port,
                                            timeout=timeout))
    try:
        conn.request(method, path, body, headers or {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def _post(port, body, path="/predict", headers=None):
    status, data, hdrs = _request(port, "POST", path, body, headers)
    return status, json.loads(data), hdrs


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, (bool, int)):
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=0, atol=ATOL)


def _req(speakers):
    return {"waves": [s[0] for s in speakers],
            "srs": [s[1] for s in speakers], "texts": None, "bases": None,
            "n": len(speakers)}


def test_http_front_end_to_end():
    """JAX ``test_serve.py:167``: fuse_clf on the single-threaded server,
    /predict, /healthz and a malformed body."""
    jp, tp = _fuse_pair(6)
    body = _body([_speaker(np.random.default_rng(6))], texts=True)
    with _both(jp, tp) as (jport, tport):
        js, jr, _ = _post(jport, body)
        ts, tr, _ = _post(tport, body)
        assert ts == js == 200
        _same(tr["results"], jr["results"])
        health = json.loads(_request(tport, "GET", "/healthz")[1])
        assert health["ok"] and health["task"] == "fuse_clf"
        assert health["cache"]["misses"] >= 1
        assert health == {**json.loads(_request(jport, "GET",
                                                "/healthz")[1]),
                          "latency": health["latency"]}
        for port in (jport, tport):
            status, err, _ = _post(port, "{bad json")
            assert status == 400 and "error" in err
        assert _request(tport, "GET", "/nope")[0] == 404


def test_micro_batching_http_front():
    """``test_serve.py:271``: a burst of 4 coalesces; every client gets
    its own slice, the JAX server's answer for it."""
    jp, tp = _audio_pair(8)
    bodies = {i: _body([_speaker(np.random.default_rng(i))])
              for i in (99, 0, 1, 2, 3)}
    with _serving(jtransport.make_http_server, jp) as jport, \
            _serving(ttransport.make_http_server, tp, batch_window_ms=500,
                     max_batch=16) as tport:
        want = {i: _post(jport, b)[1]["results"] for i, b in bodies.items()}
        _same(_post(tport, bodies[99])[1]["results"], want[99])
        out: dict = {}

        def one(i):
            out[i] = _post(tport, bodies[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(4):
            assert out[i][0] == 200
            _same(out[i][1]["results"], want[i])
        b = json.loads(_request(tport, "GET", "/healthz")[1])["batcher"]
        assert b["requests_served"] >= 5
        assert b["batches_run"] < b["requests_served"]


class _Slow:
    """A port predictor whose device batches take at least ``delay_s``, so
    that requests arrive faster than they drain whatever the host's
    load."""

    def __init__(self, inner, delay_s):
        self.inner, self.delay_s = inner, delay_s
        self.task = inner.task
        self.device = inner.device
        self.feature_cache = inner.feature_cache

    def predict_batch(self, *args):
        time.sleep(self.delay_s)
        return self.inner.predict_batch(*args)


def test_micro_batcher_sustained_overload_sheds_and_drains():
    """``test_serve.py:388``: bounded admission sheds, every admitted
    request completes with the JAX answer, the queue drains."""
    jp, tp = _audio_pair(12)
    spk = _speaker(np.random.default_rng(12))
    want = jp.predict_batch([spk[0]], [spk[1]])
    b = ttransport._MicroBatcher(_Slow(tp, 0.3), window_s=0.05,
                                 max_batch=2, max_queue=4)
    _same(b.submit(_req([spk])), want)
    out: dict = {}

    def client(i):
        try:
            out[i] = b.submit(_req([spk]))
        except ttransport.ServerOverloaded as exc:
            out[i] = exc

    threads = []
    for wave in range(4):           # 4 waves x 6 clients, faster than drain
        for j in range(6):
            t = threading.Thread(target=client, args=(wave * 6 + j,))
            t.start()
            threads.append(t)
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=120)
    served = [i for i, r in out.items() if isinstance(r, list)]
    shed = [i for i, r in out.items()
            if isinstance(r, ttransport.ServerOverloaded)]
    assert len(served) + len(shed) == 24
    assert shed and len(served) >= 4
    for i in served:
        _same(out[i], want)
    assert b.requests_shed == len(shed) and b._pending == 0
    _same(b.submit(_req([spk])), want)


def test_micro_batcher_held_overflow_completes():
    """``test_serve.py:433``: a request that would overflow the batch is
    held for the next round and completes."""
    jp, tp = _audio_pair(13)
    rng = np.random.default_rng(13)
    reqs = [[_speaker(rng) for _ in range(n)] for n in (2, 2, 1)]
    b = ttransport._MicroBatcher(tp, window_s=0.25, max_batch=3,
                                 max_queue=16)
    out: dict = {}

    def run(i):
        out[i] = b.submit(_req(reqs[i]))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i in range(3):
        _same(out[i], jp.predict_batch([s[0] for s in reqs[i]],
                                       [s[1] for s in reqs[i]]))
    assert b._pending == 0


def test_http_overload_returns_503():
    """``test_serve.py:472``: 503 + Retry-After under overload while a
    concurrent request succeeds with the JAX answer."""
    jp, tp = _audio_pair(14)
    spk = _speaker(np.random.default_rng(14))
    body = _body([spk])
    want = jp.predict_batch([spk[0]], [spk[1]])
    with _serving(ttransport.make_http_server, tp, batch_window_ms=300,
                  max_batch=1, max_queue=1) as port:
        _post(port, body)
        out: dict = {}

        def one(i):
            out[i] = _post(port, body)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        statuses = [out[i][0] for i in range(5)]
        assert 200 in statuses and 503 in statuses
        for status, payload, headers in out.values():
            if status == 200:
                _same(payload["results"], want)
            else:
                assert "overloaded" in payload["error"]
                assert headers["Retry-After"] == "1"
        health = json.loads(_request(port, "GET", "/healthz")[1])
        assert health["batcher"]["requests_shed"] >= 1
        assert health["batcher"]["max_queue"] == 1


def _stream(port, speakers):
    status, data, headers = _request(port, "POST", "/predict_stream",
                                     json.dumps({"speakers": speakers}),
                                     {"Content-Type": "application/json"},
                                     timeout=300)
    return status, [json.loads(ln) for ln in data.splitlines() if ln], \
        headers


def _stream_speakers(rng, n):
    out = []
    for _ in range(n):
        wavs, srs, _ = _speaker(rng)
        out.append({"wav_b64": [base64.b64encode(w.tobytes()).decode()
                                for w in wavs], "sr": srs})
    return out


@pytest.mark.parametrize("shape", ["within_queue", "larger_than_queue"])
def test_http_streaming_endpoint(shape):
    """``test_serve.py:528`` and ``:585``: chunked NDJSON, one line per
    speaker, through the micro-batcher; a stream larger than the queue
    drains its own speakers instead of shedding them.  Lines equal the
    JAX server's."""
    jp, tp = _audio_pair(15 if shape == "within_queue" else 17)
    n, kw = ((3, dict(batch_window_ms=50, max_batch=8))
             if shape == "within_queue"
             else (5, dict(batch_window_ms=30, max_batch=2, max_queue=2)))
    speakers = _stream_speakers(np.random.default_rng(15), n)
    with _both(jp, tp, **kw) as (jport, tport):
        ts, got, headers = _stream(tport, speakers)
        _, want, _ = _stream(jport, speakers)
    assert ts == 200 and headers["Content-Type"] == "application/x-ndjson"
    assert [ln["index"] for ln in got] == list(range(n))
    assert all("result" in ln for ln in got), got
    _same([ln["result"] for ln in got], [ln["result"] for ln in want])


def test_oversized_request_admitted_when_idle():
    """``test_serve.py:566``: more speakers than max_queue, idle queue:
    served whole."""
    jp, tp = _audio_pair(16)
    rng = np.random.default_rng(16)
    spks = [_speaker(rng) for _ in range(3)]
    b = ttransport._MicroBatcher(tp, window_s=0.05, max_batch=4,
                                 max_queue=2)
    _same(b.submit(_req(spks)), jp.predict_batch([s[0] for s in spks],
                                                 [s[1] for s in spks]))
    assert b.requests_shed == 0 and b._pending == 0


def test_micro_batcher_isolates_bad_request():
    """``test_serve.py:622``: a malformed request in a coalesced batch
    fails alone (ValueError); the valid one gets the JAX answer."""
    jp, tp = _audio_pair(11)
    spk = _speaker(np.random.default_rng(11))
    b = ttransport._MicroBatcher(tp, window_s=0.3, max_batch=8)
    bad = _req([spk])
    bad["waves"], bad["srs"] = [spk[0][:2]], [spk[1][:2]]
    out = {}

    def run(name, req):
        try:
            out[name] = b.submit(req)
        except Exception as exc:
            out[name] = exc

    ts = [threading.Thread(target=run, args=a)
          for a in (("good", _req([spk])), ("bad", bad))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert isinstance(out["bad"], ValueError)
    _same(out["good"], jp.predict_batch([spk[0]], [spk[1]]))


class _Faulty:
    """A port predictor whose ``predict_batch`` raises ``make_exc()`` for
    the speaker whose first sample is 7777, and records the thread state
    of every call."""

    def __init__(self, inner, make_exc):
        self.inner = inner
        self.make_exc = make_exc
        self.task = inner.task
        self.device = inner.device
        self.feature_cache = inner.feature_cache
        self.calls = []

    def predict_batch(self, waves, srs, texts=None, bases=None):
        self.calls.append((threading.current_thread().name,
                           torch.is_inference_mode_enabled()))
        if any(int(w[0][0]) == 7777 for w in waves):
            raise self.make_exc()
        return self.inner.predict_batch(waves, srs, texts, bases)


def _good_and_faulty(window_ms, make_exc):
    """A good and a faulty request sent together to a server around
    :class:`_Faulty`: (the answers by name, /healthz's status and body,
    the probe, the JAX predictor, the good speaker)."""
    jp, tp = _audio_pair(21)
    probe = _Faulty(tp, make_exc)
    good = _speaker(np.random.default_rng(21))
    bad = ([w.copy() for w in good[0]], good[1], good[2])
    bad[0][0][0] = 7777
    with _serving(ttransport.make_http_server, probe,
                  batch_window_ms=window_ms) as port:
        out = {}

        def one(name, spk):
            out[name] = _post(port, _body([spk]))

        ts = [threading.Thread(target=one, args=a)
              for a in (("good", good), ("bad", bad))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        status, data, _ = _request(port, "GET", "/healthz")
    return out, (status, json.loads(data)), probe, jp, good


@pytest.mark.parametrize("window_ms", [0.0, 300.0])
def test_device_fault_is_500_and_isolated(window_ms):
    """A CUDA error in the predictor is a 500, isolated to its request in a
    coalesced batch, and /healthz then answers 503 naming it; every call
    runs under inference mode, on the worker thread when
    micro-batching."""
    out, (hstatus, health), probe, jp, good = _good_and_faulty(
        window_ms, lambda: RuntimeError(
            "CUDA error: an illegal memory access was encountered"))
    assert out["bad"][0] == 500 and "CUDA error" in out["bad"][1]["error"]
    assert out["good"][0] == 200
    _same(out["good"][1]["results"], jp.predict_batch([good[0]], [good[1]]))
    assert hstatus == 503 and health["ok"] is False
    assert health["cuda_errors"] == 1
    assert "illegal memory access" in health["first_cuda_error"]
    assert probe.calls and all(inf for _, inf in probe.calls)
    if window_ms:
        assert {name for name, _ in probe.calls} == {"micro-batcher"}


@pytest.mark.parametrize("kind, want", [
    ("out of memory", 500),
    ("shape error", 400),
    ("value error", 400),
])
@pytest.mark.parametrize("window_ms", [0.0, 300.0])
def test_error_status_by_kind(window_ms, kind, want):
    """Only a fault of the card is a 500: running out of its memory (which
    leaves /healthz ok), not a ``RuntimeError`` a malformed input raises
    in torch, which is a 400 like every predictor error of the JAX
    server."""
    make_exc = {
        "out of memory": lambda: torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB"),
        "shape error": lambda: RuntimeError(
            "shape '[2, 3]' is invalid for input of size 5"),
        "value error": lambda: ValueError("bad waveform")}[kind]
    out, (hstatus, health), _, jp, good = _good_and_faulty(window_ms,
                                                           make_exc)
    assert out["bad"][0] == want and "error" in out["bad"][1]
    assert out["good"][0] == 200
    _same(out["good"][1]["results"], jp.predict_batch([good[0]], [good[1]]))
    assert hstatus == 200 and health["ok"] is True
    assert "cuda_errors" not in health


def test_empty_and_short_responses_as_jax():
    """An empty and a 10-sample response answer as the JAX server answers
    them (the same status, results within 1e-5)."""
    jp, tp = _audio_pair(23)
    good = _speaker(np.random.default_rng(23))
    for w in (np.zeros(0, np.int16), np.ones(10, np.int16)):
        spk = ([w] + list(good[0][1:]), good[1], good[2])
        with _serving(jtransport.make_http_server, jp) as jport, \
                _serving(ttransport.make_http_server, tp) as tport:
            js, jr, _ = _post(jport, _body([spk]))
            ts, tr, _ = _post(tport, _body([spk]))
        assert ts == js
        if js == 200:
            _same(tr["results"], jr["results"])


def test_latency_histogram_quantiles():
    """``test_serve.py:654``: the snapshot equals the JAX histogram's."""
    observations = (0.5, 1.5, 3.0, 8.0, 20.0, 40.0, 80.0, 200.0, 12000.0)
    th, jh = ttransport.LatencyHistogram(), jtransport.LatencyHistogram()
    assert th.snapshot() == jh.snapshot() == {"count": 0}
    for ms in observations:
        th.observe(ms / 1000.0)
        jh.observe(ms / 1000.0)
    s = th.snapshot()
    assert s == jh.snapshot()
    assert s["count"] == 9 and 10.0 < s["p50_ms"] <= 25.0
    assert s["p99_ms"] >= 10000.0 and s["buckets"]["inf"] == 1


def _bin_body(spks):
    header = json.dumps({"speakers": [
        {"n_samples": [len(w) for w in wavs], "sr": srs}
        for wavs, srs, _ in spks]}).encode()
    return (len(header).to_bytes(4, "little") + header
            + b"".join(w.tobytes() for wavs, _, _ in spks for w in wavs))


def test_healthz_latency_and_auth_and_binary():
    """``test_serve.py:673``: bearer auth (401, healthz open), /predict_bin
    equal to /predict and to the JAX server's, a truncated body 400, the
    latency histograms populated."""
    jp, tp = _audio_pair(18)
    spks = [_speaker(np.random.default_rng(18)),
            _speaker(np.random.default_rng(19), seconds=0.41)]
    body_b64, body_bin = _body(spks), _bin_body(spks)
    auth = {"Authorization": "Bearer s3cret"}
    kw = dict(batch_window_ms=20, max_batch=8, auth_token="s3cret")
    with _both(jp, tp, **kw) as (jport, tport):
        status, _, headers = _post(tport, body_b64)
        assert status == 401 and headers["WWW-Authenticate"] == "Bearer"
        assert _post(tport, body_b64,
                     headers={"Authorization": "Bearer wrong"})[0] == 401
        assert _request(tport, "GET", "/healthz")[0] == 200
        via_b64 = _post(tport, body_b64, headers=auth)[1]["results"]
        via_bin = _post(tport, body_bin, "/predict_bin", auth)[1]["results"]
        assert via_bin == via_b64
        _same(via_bin, _post(jport, body_bin, "/predict_bin",
                             auth)[1]["results"])
        assert _post(tport, body_bin[:-100], "/predict_bin",
                     auth)[0] == 400
        lat = json.loads(_request(tport, "GET", "/healthz")[1])["latency"]
    assert lat["request"]["count"] >= 2 and lat["device_batch"]["count"] >= 2
    assert lat["request"]["p50_ms"] > 0
    assert set(lat["request"]) >= {"count", "mean_ms", "p50_ms", "p90_ms",
                                   "p99_ms", "buckets"}


def test_tls_serving(tmp_path):
    """``test_serve.py:746``: HTTPS with a self-signed certificate."""
    cert, key = tmp_path / "crt.pem", tmp_path / "key.pem"
    try:
        gen = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=127.0.0.1"], capture_output=True, timeout=60)
    except FileNotFoundError:
        gen = None
    if gen is None or gen.returncode != 0:
        pytest.skip("openssl unavailable to mint a test certificate")
    jp, tp = _audio_pair(19)
    spk = _speaker(np.random.default_rng(19))
    ctx = ssl.create_default_context(cafile=str(cert))
    ctx.check_hostname = False
    with _serving(ttransport.make_http_server, tp, tls_cert=str(cert),
                  tls_key=str(key)) as port:
        status, data, _ = _request(port, "GET", "/healthz", context=ctx)
        assert status == 200 and json.loads(data)["ok"]
        status, data, _ = _request(port, "POST", "/predict", _body([spk]),
                                   context=ctx)
    assert status == 200
    _same(json.loads(data)["results"], jp.predict_batch([spk[0]], [spk[1]]))


def test_auth_hardening_eof_and_non_ascii():
    """``test_serve.py:781``: a client that promises a large body and
    disconnects, and a non-ASCII token: clean 401s, the server serves on
    (the JAX server answers the same)."""
    jp, tp = _audio_pair(20)
    with _both(jp, tp, batch_window_ms=20, auth_token="tok") as ports:
        for port in ports:
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 1000000\r\n\r\npartial")
            s.shutdown(socket.SHUT_WR)
            s.settimeout(30)
            assert b"401" in s.recv(1024)
            s.close()
            assert _request(port, "GET", "/healthz")[0] == 200
            assert _post(port, "{}", headers={
                "Authorization": "Bearer café"})[0] == 401


def test_predict_bin_rejects_negative_n_samples():
    """``test_serve.py:823``: a negative n_samples is a 400 with the JAX
    server's message."""
    jp, tp = _audio_pair(21)
    header = json.dumps({"speakers": [{
        "n_samples": [-1, 100, 100], "sr": [SR] * 3}]}).encode()
    body = len(header).to_bytes(4, "little") + header + b"\x00" * 600
    with _both(jp, tp) as (jport, tport):
        got = _post(tport, body, "/predict_bin")
        want = _post(jport, body, "/predict_bin")
    assert got[0] == want[0] == 400
    assert got[1] == want[1]
    assert "negative n_samples" in got[1]["error"]


def test_empty_speaker_batch_is_valid():
    """``test_serve.py:900``: zero speakers, zero results (also over
    HTTP)."""
    jp, tp = _audio_pair(23)
    assert tp.predict_batch([], []) == jp.predict_batch([], []) == []
    assert tp.audio_features([], []).shape == (0, 3, 32)
    with _both(jp, tp) as (jport, tport):
        body = json.dumps({"speakers": []})
        for port in (tport, jport):
            assert _post(port, body)[:2] == (200, {"results": []})


def _participants(rng, counts, texts=False, starts=None):
    out = []
    for i, c in enumerate(counts):
        p = {"responses_b64": [base64.b64encode(np.round(
            rng.standard_normal(4000 + 2000 * k) * 2000).astype(np.int16)
            .tobytes()).decode() for k in range(c)], "sr": SR}
        if texts:
            p["texts"] = [f"response {i} {k}" for k in range(c)]
        if starts is not None:
            p["start_ordinal"] = starts[i]
        out.append(p)
    return out


def test_daic_http_serving():
    """``test_daic_train.py:267``: DAIC /predict with ragged responses
    equals the JAX server's; /predict_stream is 404; healthz counts the
    response cache."""
    jp, tp = _daic_pair(3)
    body = json.dumps({"participants": _participants(
        np.random.default_rng(3), (2, 1), starts=[0, 4])})
    with _both(jp, tp) as (jport, tport):
        ts, tr, _ = _post(tport, body)
        js, jr, _ = _post(jport, body)
        assert ts == js == 200
        _same(tr["results"], jr["results"])
        assert _post(tport, body, "/predict_stream")[0] == 404
        h = json.loads(_request(tport, "GET", "/healthz")[1])
    assert h["ok"] and h["task"] == "daic_clf"
    assert h["latency"]["request"]["count"] >= 1
    assert h["cache"]["misses"] >= 1


def test_daic_micro_batching_coalesces():
    """``test_daic_train.py:321``: concurrent DAIC requests coalesce into
    fewer ragged device batches; each answer is the JAX server's."""
    jp, tp = _daic_pair(4)
    bodies = {i: json.dumps({"participants": _participants(
        np.random.default_rng(i), (1 + i % 3,))}) for i in (99, 0, 1, 2, 3)}
    with _serving(jtransport.make_http_server, jp) as jport, \
            _serving(ttransport.make_http_server, tp, batch_window_ms=700,
                     max_batch=16) as tport:
        want = {i: _post(jport, b)[1]["results"] for i, b in bodies.items()}
        _same(_post(tport, bodies[99])[1]["results"], want[99])
        out: dict = {}

        def one(i):
            out[i] = _post(tport, bodies[i])[1]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(4):
            _same(out[i]["results"], want[i])
        b = json.loads(_request(tport, "GET", "/healthz")[1])["batcher"]
    assert b["requests_served"] >= 5
    assert b["batches_run"] < b["requests_served"]


def test_daic_http_auth_gate():
    """``test_daic_train.py:449``: 401 without the token, healthz open,
    the JAX answer with it."""
    jp, tp = _daic_pair(6)
    body = json.dumps({"participants": _participants(
        np.random.default_rng(6), (1,))})
    auth = {"Authorization": "Bearer tok"}
    with _both(jp, tp, auth_token="tok") as (jport, tport):
        assert _post(tport, body)[0] == 401
        assert _request(tport, "GET", "/healthz")[0] == 200
        status, got, _ = _post(tport, body, headers=auth)
        assert status == 200
        _same(got["results"], _post(jport, body, headers=auth)[1]["results"])


def test_daic_multimodal_http_serving():
    """``test_daic_train.py:571``: participants carry per-response texts;
    without them a 400, as from the JAX server."""
    jp, tp = _daic_pair(5, multimodal=True)
    rng = np.random.default_rng(6)
    body = json.dumps({"participants": _participants(rng, (2,), texts=True)})
    missing = json.dumps({"participants": _participants(rng, (1,))})
    with _both(jp, tp) as (jport, tport):
        status, got, _ = _post(tport, body)
        assert status == 200
        _same(got["results"], _post(jport, body)[1]["results"])
        assert _post(tport, missing)[0] == _post(jport, missing)[0] == 400


def test_daic_multimodal_micro_batching():
    """``test_daic_train.py:627``: coalesced multimodal requests carry
    their texts through the merge: each result is the JAX unbatched
    one."""
    jp, tp = _daic_pair(7, multimodal=True)
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(3):
        n = int(rng.integers(1, 4))
        sigs = [np.round(rng.standard_normal(8000) * 2000).astype(np.int16)
                for _ in range(n)]
        reqs.append({"signals": [sigs], "srs": [SR], "starts": None,
                     "texts": [[f"response {i} {k}" for k in range(n)]],
                     "n": 1})
    want = [jp.predict_signals(r["signals"], r["srs"], None, r["texts"])
            for r in reqs]
    b = ttransport._DaicMicroBatcher(tp, window_s=0.3, max_batch=8,
                                     max_queue=8)
    got = [None] * 3

    def worker(i):
        got[i] = b.submit(reqs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for g, w in zip(got, want):
        _same(g, w)
