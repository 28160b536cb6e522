"""The port's serving contract against the JAX package's, over real
sockets, on the CPU.

A JAX pod and a port pod, each the ``vllm`` unit's ``tiny`` tier behind
its package's ``create_app`` and stdlib server on ``DEVICE=cpu``; the
port's service takes the JAX service's weights through its ``weights``
hook (the same flax init, ``params_from_jax``). What is held:

- ``/v1/completions``, ``/v1/chat/completions`` (with ``n=2`` and
  ``logprobs``) and ``/generate`` with ``logprobs`` give the JAX pod's
  greedy text, or part from it only at a bf16 tie (``tests/parity.py``,
  classified from both pods' ``/generate`` logprobs), and logprob values
  within ``LP_ATOL`` (6e-2, the logit tolerance of
  ``tests/test_torch_chunked.py``); ``/v1/models`` names the model;
- ``stream: true`` gives the JAX pod's sequence of SSE deltas, ending in
  ``[DONE]``;
- the port's ``/metrics`` parses as text format 0.0.4, and its families
  (names, types, label names, histogram buckets) include the JAX pod's
  request, engine histogram, gauge and counter families;
- ``/health/ready``; ``POST /profile/1`` then 409 while it runs; a 504 for
  an ``X-SHAI-Deadline-Ms`` expired on arrival (and one that expires in
  the engine), a 400 for a malformed one;
- a client that disconnects mid-stream cancels its request in the engine
  (the stream cannot finish first: no reachable EOS, throttled steps),
  and no block leaks;
- the server frames an unknown-length body chunked for HTTP/1.1 and
  close-delimited for HTTP/1.0, and routes ``{name:int}`` path params;
- the four ``SseTextAssembler`` cases of ``tests/test_serve_vllm.py``
  against the port's copy.
"""

import json
import socket
import sys
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import jax
import jax.numpy as jnp
from prometheus_client.parser import text_string_to_metric_families

from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.serve import metrics as jmetrics
from scalable_hw_agnostic_inference_tpu.serve.app import (
    create_app as jcreate_app,
)
from scalable_hw_agnostic_inference_tpu.serve.httpd import Server as JServer
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.asgi import (
    App,
    StreamingResponse,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.units.common import (
    SseTextAssembler,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
    VllmService,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402

LP_ATOL = 6e-2


def _http(url, payload=None, headers=None, raw=False, timeout=120.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return r.status, (body.decode() if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait_ready(base, timeout=300.0):
    t0 = time.monotonic()
    while _http(base + "/readiness")[0] != 200:
        assert time.monotonic() - t0 < timeout, f"{base} never became ready"
        time.sleep(0.1)


def _port_service(tmp, **over):
    kw = dict(app="vllm", device="cpu", model_id="tiny", batch_size=4,
              max_new_tokens=32, vllm_config=str(tmp / "absent.yaml"),
              artifact_root=str(tmp / "artifacts"))
    cfg = ServeConfig(**dict(kw, **over))
    cfg.validate()
    params = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(), dtype=jnp.float32).init(
        jax.random.PRNGKey(cfg.seed), jnp.zeros((1, 8), jnp.int32))
    return cfg, VllmService(
        cfg, weights=lambda mcfg, dev: tllama.params_from_jax(params, mcfg))


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pods")
    jcfg = JServeConfig(app="vllm", device="cpu", model_id="tiny",
                        batch_size=4, max_new_tokens=32,
                        vllm_config=str(tmp / "absent.yaml"))
    jpub = jmetrics.MetricsPublisher(jcfg.app, jcfg.nodepool, jcfg.pod_name,
                                     emit_json=False)
    jsrv = JServer(jcreate_app(jcfg, get_model("vllm")(jcfg), publisher=jpub),
                   host="127.0.0.1", port=0)
    cfg, service = _port_service(tmp)
    tsrv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    jh, jp = jsrv.start_background()
    th, tp = tsrv.start_background()
    ref, port = f"http://{jh}:{jp}", f"http://{th}:{tp}"
    try:
        _wait_ready(ref)
        _wait_ready(port)
        yield ref, port, service
    finally:
        tsrv.stop()
        jsrv.stop()


def _stream_of(base, prompt, n):
    """Both pods' greedy token stream and logprob entries for ``prompt``,
    through ``/generate``."""
    status, out = _http(base + "/generate", {
        "prompt": prompt, "max_new_tokens": n, "temperature": 0.0,
        "logprobs": 2})
    assert status == 200, out
    return types.SimpleNamespace(
        token_ids=[e["token"] for e in out["logprobs"]],
        logprobs=out["logprobs"])


def _same_or_tie(ref, port, prompt, n, got, want, label) -> bool:
    """True when the port's text is the JAX pod's; otherwise the two pods'
    token streams for ``prompt`` must part at a bf16 tie."""
    if got == want:
        return True
    assert_greedy_parity([_stream_of(port, prompt, n)],
                         [_stream_of(ref, prompt, n)], label=label)
    return False


def _drop_volatile(out):
    return {k: v for k, v in out.items()
            if k not in ("id", "created", "latency_s")}


def _chat_text(messages):
    """The prompt both units build for a chat without a template."""
    return "\n".join(f"{m['role']}: {m['content']}"
                     for m in messages) + "\nassistant:"


def _assert_lp_fields_close(got, want):
    if want is None:
        assert got is None
        return
    if "content" in want:   # chat
        for g, w in zip(got["content"], want["content"]):
            assert g["token"] == w["token"]
            assert abs(g["logprob"] - w["logprob"]) <= LP_ATOL
            assert len(g["top_logprobs"]) == len(w["top_logprobs"])
        return
    assert got["tokens"] == want["tokens"]
    for g, w in zip(got["token_logprobs"], want["token_logprobs"]):
        assert abs(g - w) <= LP_ATOL
    # the completions shape keys alternatives by their text: ids that
    # decode alike (bytes past the vocab's byte range, lone continuation
    # bytes) collapse, and which near-tied ids make the cut differs; the
    # entries themselves are held id by id in test_torch_logprobs.py
    for g, w in zip(got["top_logprobs"], want["top_logprobs"]):
        assert 1 <= len(g) <= 3 and 1 <= len(w) <= 3
        assert abs(max(g.values()) - max(w.values())) <= LP_ATOL


#: (route, prompts, extra body): completions and chat, with n=2 and with
#: logprobs; the chat "hi" parts at a bf16 tie on its first token
CASES = {
    "completion": ("/v1/completions", ["hello world", "once upon a time"],
                   {"max_tokens": 12}),
    "completion-n2": ("/v1/completions", ["abc", "the quick brown fox"],
                      {"max_tokens": 8, "n": 2}),
    "completion-logprobs": ("/v1/completions", ["lp", "stream me"],
                            {"max_tokens": 6, "logprobs": 3}),
    "chat": ("/v1/chat/completions", ["hi", "tell me a story"],
             {"max_tokens": 10}),
    "chat-logprobs": ("/v1/chat/completions",
                      ["what is paged attention?", "tell me a story"],
                      {"max_tokens": 6, "logprobs": True,
                       "top_logprobs": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_openai_routes_match_the_jax_pod(pods, case):
    ref, port, _ = pods
    route, prompts, extra = CASES[case]
    exact = 0
    for p in prompts:
        if route.endswith("chat/completions"):
            msgs = [{"role": "user", "content": p}]
            body = {"messages": msgs, "temperature": 0, **extra}
            text_prompt = _chat_text(msgs)
        else:
            body = {"prompt": p, "temperature": 0, **extra}
            text_prompt = p
        (js, jout), (ts, tout) = _http(ref + route, body), \
            _http(port + route, body)
        assert js == ts == 200, (jout, tout)
        jout, tout = _drop_volatile(jout), _drop_volatile(tout)
        assert tout["object"] == jout["object"]
        assert tout["usage"] == jout["usage"]
        assert len(tout["choices"]) == len(jout["choices"]) == \
            extra.get("n", 1)
        for tc, jc in zip(tout["choices"], jout["choices"]):
            assert tc["index"] == jc["index"]
            key = "message" if "message" in jc else "text"
            got = tc[key]["content"] if key == "message" else tc[key]
            want = jc[key]["content"] if key == "message" else jc[key]
            same = _same_or_tie(ref, port, text_prompt,
                                extra["max_tokens"], got, want,
                                f"{case} {p!r}")
            if same:
                exact += 1
                assert tc["finish_reason"] == jc["finish_reason"]
                _assert_lp_fields_close(tc["logprobs"], jc["logprobs"])
    assert exact, f"{case}: every prompt parted at a tie"


def test_generate_logprobs_match_the_jax_pod(pods):
    ref, port, _ = pods
    body = {"prompt": "the fox", "max_new_tokens": 8, "temperature": 0.0,
            "logprobs": 3}
    (js, jout), (ts, tout) = _http(ref + "/generate", body), \
        _http(port + "/generate", body)
    assert js == ts == 200
    for k in ("generated_text", "n_tokens", "n_prompt", "stop_reason"):
        assert tout[k] == jout[k]
    assert len(tout["logprobs"]) == tout["n_tokens"]
    for g, w in zip(tout["logprobs"], jout["logprobs"]):
        assert g["token"] == w["token"]
        assert abs(g["logprob"] - w["logprob"]) <= LP_ATOL
        for gv, wv in zip(g["top_logprobs"], w["top_logprobs"]):
            assert abs(gv - wv) <= LP_ATOL
    assert _http(port + "/generate", {"prompt": "x", "logprobs": 6})[0] \
        == 400
    status, models = _http(port + "/v1/models")
    assert status == 200 and models["data"][0]["id"] == "tiny"


def _sse(base, route, body):
    status, text = _http(base + route, dict(body, stream=True), raw=True)
    assert status == 200
    events = [e[len("data: "):] for e in text.split("\n\n") if e]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    deltas = []
    for c in chunks:
        ch = c["choices"][0]
        deltas.append((ch.get("text", ch.get("delta", {}).get("content")),
                       ch["finish_reason"]))
    return deltas


@pytest.mark.parametrize("route,body", [
    ("/v1/completions", {"prompt": "stream me", "max_tokens": 12,
                         "temperature": 0}),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "tell me a story"}], "max_tokens": 12,
        "temperature": 0}),
], ids=["completion", "chat"])
def test_sse_deltas_match_the_jax_pod(pods, route, body):
    ref, port, service = pods
    got, want = _sse(port, route, body), _sse(ref, route, body)
    assert got == want
    assert got[-1][1] in ("stop", "length")
    # the stream is the non-streamed text, delta by delta
    _, out = _http(port + route, body)
    ch = out["choices"][0]
    text = ch["message"]["content"] if "message" in ch else ch["text"]
    assert "".join(d or "" for d, _ in got) == text
    assert service._engine.cache.leaked_blocks == 0


#: the JAX pod's families the port must export: the request counter and
#: latency, and the engine's histogram, gauge and counter families
def _contract_families():
    names = {"shai_requests", "shai_request_latency_seconds"}
    for table in (jmetrics.ENGINE_HISTOGRAMS, jmetrics._ENGINE_GAUGES,
                  jmetrics._ENGINE_COUNTERS):
        names |= {name for name, _ in table.values()}
    return names


def _families(text):
    out = {}
    for fam in text_string_to_metric_families(text):
        labels = {k for s in fam.samples for k in s.labels if k != "le"}
        les = sorted({s.labels["le"] for s in fam.samples
                      if "le" in s.labels})
        out[fam.name] = (fam.type, labels, les)
    return out


def test_metrics_are_text_format_and_cover_the_jax_pod(pods):
    ref, port, _ = pods
    body = {"prompt": "metrics", "max_new_tokens": 4, "temperature": 0}
    assert _http(ref + "/generate", body)[0] == 200
    assert _http(port + "/generate", body)[0] == 200
    req = urllib.request.Request(port + "/metrics")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["content-type"].startswith(
            "text/plain; version=0.0.4")
        ptext = r.read().decode()
    _, jtext = _http(ref + "/metrics", raw=True)
    got, want = _families(ptext), _families(jtext)
    contract = _contract_families() & set(want)
    # the JAX pod exports every family of the contract but the spec gauge
    assert contract >= _contract_families() - {"shai_spec_acceptance_rate"}
    for name in contract:
        assert name in got, name
        assert got[name] == want[name], (name, got[name], want[name])
    assert got["shai_requests"][1] == {"app", "nodepool", "pod"}
    samples = {s.name: s.value for fam in
               text_string_to_metric_families(ptext) for s in fam.samples}
    assert samples["shai_engine_requests_finished_total"] >= 1
    assert samples["shai_engine_steps_total"] >= 1


def test_health_ready_profile_and_deadlines(pods):
    ref, port, service = pods
    assert _http(port + "/health/ready") == (200, {"status": "ready"})
    status, out = _http(port + "/profile/1", {})
    assert status == 200 and out["seconds"] == 1
    assert _http(port + "/profile/1", {})[0] == 409
    assert _http(port + "/profile")[1]["running"] is True
    assert _http(port + "/profile/0", {})[0] == 400
    assert _http(port + "/profile/x", {})[0] == 404
    body = {"prompt": "late", "max_new_tokens": 8, "temperature": 0}
    # expired on arrival: a 504 before any model work, as the JAX pod
    for base in (ref, port):
        status, out = _http(base + "/generate", body,
                            {"X-SHAI-Deadline-Ms": "0.000001"})
        assert status == 504 and "before processing" in out["detail"]
        assert _http(base + "/generate", body,
                     {"X-SHAI-Deadline-Ms": "abc"})[0] == 400
    finished = service._engine.obs.requests_finished
    # a budget of 1 ms expires in the engine, or on arrival
    status, out = _http(port + "/v1/completions", {
        "prompt": "late", "max_tokens": 8}, {"X-SHAI-Deadline-Ms": "1"})
    assert status == 504 and "deadline exceeded" in out["detail"]
    t0 = time.monotonic()
    while _http(port + "/profile")[1]["running"]:
        assert time.monotonic() - t0 < 30
        time.sleep(0.1)
    trace = Path(_http(port + "/profile")[1]["trace_dir"]) / "trace.json"
    assert trace.is_file()
    assert service._engine.obs.requests_finished >= finished
    assert service._engine.cache.leaked_blocks == 0


def test_stream_disconnect_cancels_the_request(tmp_path):
    """A client that goes away after the first SSE chunk: the disconnect
    watch closes the stream, whose ``finally`` cancels the request in the
    engine. The stream cannot finish first: the unit's EOS is unreachable
    and every engine step is throttled to 50 ms (64 tokens >= 3.2 s)."""
    cfg, service = _port_service(tmp_path, max_new_tokens=64)
    srv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = srv.start_background()
    try:
        _wait_ready(f"http://{host}:{port}")
        service.eos_id = -1
        eng, loop = service._engine, service.loop
        step = eng.step

        def slow_step():
            time.sleep(0.05)
            return step()

        eng.step = slow_step
        cancelled = []
        cancel = loop.cancel

        def spy(fut):
            cancelled.append(fut)
            cancel(fut)

        loop.cancel = spy
        # chat: its first chunk (the role preamble) goes out at once,
        # where a completion's may wait on held-back partial UTF-8
        body = json.dumps({"messages": [{"role": "user", "content": "go"}],
                           "max_tokens": 64, "temperature": 0,
                           "stream": True}).encode()
        with socket.create_connection((host, port), timeout=30) as s:
            s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nhost: x\r\n"
                      b"content-type: application/json\r\n"
                      + f"content-length: {len(body)}\r\n\r\n".encode()
                      + body)
            got = b""
            while b"data: " not in got:
                data = s.recv(4096)
                assert data, "the server closed before the first chunk"
                got += data
            assert b"transfer-encoding: chunked" in got.lower()
        t0 = time.monotonic()
        while not cancelled or eng.has_work:
            assert time.monotonic() - t0 < 30, "the request was not cancelled"
            time.sleep(0.05)
        fin = cancelled[0].result(timeout=30)
        assert fin.stop_reason == "cancelled"
        assert 0 < len(fin.token_ids) < 64
        assert eng.cache.leaked_blocks == 0
        assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1
    finally:
        srv.stop()


def _raw(host, port, request: bytes) -> bytes:
    with socket.create_connection((host, port), timeout=30) as s:
        s.sendall(request)
        out = b""
        while True:
            data = s.recv(65536)
            if not data:
                return out
            out += data


def test_unknown_length_bodies_are_chunked_or_close_delimited():
    app = App()

    @app.get("/stream/{n:int}")
    def stream(request, n):
        return StreamingResponse(f"part {i};" for i in range(n))

    srv = Server(app, host="127.0.0.1", port=0)
    host, port = srv.start_background()
    try:
        head, _, body = _raw(host, port, b"GET /stream/3 HTTP/1.1\r\n"
                             b"host: x\r\nconnection: close\r\n\r\n"
                             ).partition(b"\r\n\r\n")
        assert b"transfer-encoding: chunked" in head.lower()
        assert body == (b"7\r\npart 0;\r\n7\r\npart 1;\r\n7\r\npart 2;\r\n"
                        b"0\r\n\r\n")
        head, _, body = _raw(host, port, b"GET /stream/2 HTTP/1.0\r\n\r\n"
                             ).partition(b"\r\n\r\n")
        assert b"transfer-encoding" not in head.lower()
        assert b"connection: close" in head.lower()
        assert body == b"part 0;part 1;"
        status = _raw(host, port, b"GET /stream/two HTTP/1.1\r\nhost: x\r\n"
                      b"connection: close\r\n\r\n").split(b" ")[1]
        assert status == b"404"
    finally:
        srv.stop()


def _char_decode(ids):
    return "".join(chr(i) for i in ids)


def test_sse_assembler_stop_spanning_tokens():
    """A stop sequence split across token boundaries never leaks its
    prefix."""
    asm = SseTextAssembler(_char_decode, ["ab"])
    assert asm.push(ord("x")) == "x"
    assert asm.push(ord("a")) == ""   # held: could begin "ab"
    assert asm.push(ord("b")) == ""   # stop confirmed; "a" never leaked
    assert asm.stopped
    assert asm.finish() == ""
    # the held prefix releases when the next token disambiguates
    asm = SseTextAssembler(_char_decode, ["ab"])
    assert asm.push(ord("x")) == "x"
    assert asm.push(ord("a")) == ""
    assert asm.push(ord("c")) == "ac"
    assert not asm.stopped


def test_sse_assembler_utf8_holdback_flushes_at_end():
    asm = SseTextAssembler(lambda ids: "�" * len(ids), [])
    assert asm.push(1) == ""
    assert asm.push(2) == ""
    assert asm.finish() == "��"


def test_sse_assembler_compacts_on_newline():
    asm = SseTextAssembler(_char_decode, [])
    assert asm.push(ord("q")) == "q"
    assert asm.push(ord("\n")) == "\n"
    assert asm.held == []          # bounded re-decode window reset
    assert asm.push(ord("z")) == "z"


def test_sse_assembler_forced_compaction_preserves_seam_spaces():
    """Long unbroken generations force mid-line compaction; the streamed
    concatenation still equals the full decode (the one-token overlap
    keeps a sentencepiece-style leading space at the seam)."""
    words = {i: f" w{i}" for i in range(400)}

    def sp_decode(ids):
        return "".join(words[i] for i in ids).lstrip(" ")

    asm = SseTextAssembler(sp_decode, [])
    toks = list(range(400))
    streamed = "".join(asm.push(t) for t in toks) + asm.finish()
    assert streamed == sp_decode(toks)
    assert len(asm.held) <= asm.COMPACT_AT
