"""The pod's operating layer, port against the JAX package, over sockets.

A JAX pod and a port pod (the ``vllm`` unit's ``tiny`` tier behind each
package's ``create_app`` and stdlib server on ``DEVICE=cpu``; the port
reads the JAX service's flax weights, as ``tests/test_torch_openai.py``
does), both under ``MAX_INFLIGHT=3``, a tenant budget
(``SHAI_TENANT_BUDGETS=capped=1:1``), a watchdog leash of
``max(1 s, 2 x p99 step)``, an SLO
target and a perf projection. Faults are armed on each pod through its
own ``POST /debug/faults``. For every case the two pods must give equal
status codes, ``Retry-After`` presence and JSON keys:

- 429 with ``Retry-After`` over the in-flight cap and over a tenant
  budget, counted in ``/stats`` -> ``shed``;
- idempotent replay and join (one execution, byte-equal bodies);
- ``traceparent`` in and out, ``GET /trace/{id}``, ``/debug/flight``;
- ``/debug/faults`` gated by ``SHAI_FAULTS_ENDPOINT``;
- the step-stall liveness cycle (``/health`` 503, then 200);
- a deadline 504 under a step delay;
- ``/benchmark``, ``/load``, ``/serve``, ``/stats`` and
  ``/debug/conformance``;
- the ``/metrics`` families of the operating layer (``shai_service_*``,
  ``shai_tenant_*``, ``shai_hbm_*``, ``shai_slo_*``, ``shai_perf_*``,
  ``shai_idemp_*``, ``shai_shed``), as sets, each with its type and
  label names;
- a step crash failing its request and readiness;
- the drain, last: readiness ``draining``, 503 with ``Retry-After`` for
  new work, in-flight requests finishing, the engine loop stopped.

The reference's ``test_client_disconnect_mid_stream_cancels_engine``
fails on the JAX package (one of its baseline failures), so its
counterpart here runs on the port pod only.
"""

import asyncio
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
from prometheus_client.parser import text_string_to_metric_families

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine.loop import (
    EngineLoop as JEngineLoop,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.obs.trace import (
    well_formed_problems,
)
from scalable_hw_agnostic_inference_tpu.serve import metrics as jmetrics
from scalable_hw_agnostic_inference_tpu.serve.app import (
    create_app as jcreate_app,
)
from scalable_hw_agnostic_inference_tpu.serve.httpd import Server as JServer
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.loop import EngineLoop
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
    MetricsPublisher,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
    VllmService,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

POD_ENV = {"SHAI_TENANT_BUDGETS": "capped=1:1", "SHAI_WATCHDOG_MIN_S": "1",
           "SHAI_WATCHDOG_MULT": "2",
           "SHAI_SLO_TTFT_MS": "60000", "SHAI_PERF_PROJECTED_TOK_S": "1",
           "SHAI_FAULTS_ENDPOINT": "1"}
POD_KW = dict(app="vllm", device="cpu", model_id="tiny", batch_size=4,
              max_new_tokens=32, max_inflight=3, drain_budget_s=60.0)
#: the operating layer's /metrics families (prometheus_client's family
#: names: a counter's without ``_total``)
OPS_PREFIXES = ("shai_service_", "shai_tenant_", "shai_hbm_", "shai_slo_",
                "shai_perf_", "shai_idemp_", "shai_shed")
#: the port's HBM ledger reports two allocator pools the TPU ledger never
#: saw, beside its unattributed bytes
PORT_ONLY_FAMILIES = {"shai_hbm_graph_pool_bytes",
                      "shai_hbm_split_scratch_bytes"}


def _http(url, payload=None, headers=None, method=None, timeout=120.0):
    """``(status, lowercased headers, body)``; JSON bodies decoded."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, hdrs, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, e.headers, e.read()
    hdrs = {k.lower(): v for k, v in hdrs.items()}
    if hdrs.get("content-type", "").startswith("application/json"):
        body = json.loads(body or b"{}")
    else:
        body = body.decode()
    return status, hdrs, body


def _wait_ready(base, timeout=300.0):
    t0 = time.monotonic()
    while _http(base + "/readiness")[0] != 200:
        assert time.monotonic() - t0 < timeout, f"{base} never became ready"
        time.sleep(0.1)


def _faults(base, spec):
    status, _, body = _http(base + "/debug/faults", {"spec": spec})
    assert status == 200, body
    return body


def _gen(base, n=4, prompt="hello", headers=None):
    return _http(base + "/generate", {"prompt": prompt, "temperature": 0.0,
                                      "max_new_tokens": n}, headers=headers)


def _both(pods, fn):
    """``fn(base)`` on both pods at once (threads), results by side."""
    out = {}
    threads = [threading.Thread(target=lambda k=k, b=b: out.__setitem__(
        k, fn(b))) for k, b in (("jax", pods.ref), ("port", pods.port))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert set(out) == {"jax", "port"}, "a pod did not answer"
    return out["jax"], out["port"]


def _concurrent(fn, n):
    res = [None] * n
    threads = [threading.Thread(target=lambda i=i: res.__setitem__(i, fn(i)))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in res)
    return res


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ops")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in POD_ENV.items():
            mp.setenv(k, v)
        absent = str(tmp / "absent.yaml")
        jcfg = JServeConfig(vllm_config=absent, **POD_KW)
        jservice = get_model("vllm")(jcfg)
        jsrv = JServer(jcreate_app(jcfg, jservice, publisher=jmetrics
                                   .MetricsPublisher(jcfg.app, jcfg.nodepool,
                                                     jcfg.pod_name,
                                                     emit_json=False)),
                       host="127.0.0.1", port=0)
        cfg = ServeConfig(vllm_config=absent,
                          artifact_root=str(tmp / "artifacts"), **POD_KW)
        params = jllama.LlamaForCausalLM(
            jllama.LlamaConfig.tiny(), dtype=jnp.float32).init(
            jax.random.PRNGKey(cfg.seed), jnp.zeros((1, 8), jnp.int32))
        service = VllmService(cfg, weights=lambda mcfg, dev:
                              tllama.params_from_jax(params, mcfg))
        tsrv = Server(create_app(cfg, service, publisher=MetricsPublisher(
            cfg.app, cfg.nodepool, cfg.pod_name, emit_json=False)),
            host="127.0.0.1", port=0)
        jh, jp = jsrv.start_background()
        th, tp = tsrv.start_background()
        ns = type("Pods", (), {})()
        ns.ref, ns.port = f"http://{jh}:{jp}", f"http://{th}:{tp}"
        ns.jsrv, ns.tsrv, ns.jservice, ns.service = jsrv, tsrv, jservice, \
            service
        try:
            _wait_ready(ns.ref)
            _wait_ready(ns.port)
            yield ns
        finally:
            tsrv.stop()
            jsrv.stop()


@pytest.fixture
def clean_faults(pods):
    yield
    for base in (pods.ref, pods.port):
        if _http(base + "/readiness")[0] == 200:
            _faults(base, "")


def test_inflight_cap_sheds_429_with_retry_after(pods, clean_faults):
    def run(base):
        _faults(base, "engine.step=delay(0.05)")
        shed0 = _http(base + "/stats")[2].get("shed", {}).get("total", 0)
        res = _concurrent(lambda i: _gen(base, n=8, prompt=f"p{i}"), 8)
        stats = _http(base + "/stats")[2]
        return res, stats["shed"]["total"] - shed0, stats["shed"]

    (jres, jshed, jst), (tres, tshed, tst) = _both(pods, run)
    for res, shed in ((jres, jshed), (tres, tshed)):
        codes = [r[0] for r in res]
        assert set(codes) <= {200, 429} and 429 in codes and 200 in codes
        assert shed == codes.count(429)
        for status, hdrs, body in res:
            assert ("retry-after" in hdrs) == (status == 429)
            if status == 429:
                assert set(body) == {"detail"} and int(hdrs["retry-after"])
    assert set(jst) == set(tst) == {"total", "inflight"}
    assert {r[0] for r in jres} == {r[0] for r in tres}


def test_tenant_budget_sheds_429_with_budget_retry_after(pods):
    hdr = {"x-shai-tenant": "capped"}

    def run(base):
        first = _gen(base, headers=hdr)
        second = _gen(base, headers=hdr)
        other = _gen(base, headers={"x-shai-tenant": "free"})
        return first, second, other, _http(base + "/stats")[2]["qos"]

    jax_side, port_side = _both(pods, run)
    for first, second, other, qos in (jax_side, port_side):
        assert (first[0], second[0], other[0]) == (200, 429, 200)
        assert "retry-after" in second[1] and "retry-after" not in first[1]
        # the budget's refill time, not the static 1 s hint
        assert int(second[1]["retry-after"]) > 1
        assert qos["metered"] and qos["tenants"]["capped"]["shed"] == 1
        assert "budget_balance" in qos["tenants"]["capped"]
    assert set(jax_side[1][2]) == set(port_side[1][2]) == {"detail"}
    assert set(jax_side[3]) == set(port_side[3])
    assert set(jax_side[3]["tenants"]["capped"]) == \
        set(port_side[3]["tenants"]["capped"])


def test_idempotent_replay_and_join(pods, clean_faults):
    def run(base):
        key = {"x-shai-idempotency-key": "ops-key-1"}
        bad = _gen(base, headers={"x-shai-idempotency-key": "has spaces"})
        _faults(base, "engine.step=delay(0.02)")
        first = _gen(base, n=6, headers=key)
        second = _gen(base, n=6, headers=key)
        joined = _concurrent(lambda i: _gen(base, n=6, headers=key), 2)
        return bad, first, [second] + joined, _http(base + "/stats")[2]

    jax_side, port_side = _both(pods, run)
    for bad, first, replays, stats in (jax_side, port_side):
        assert bad[0] == 400
        assert first[0] == 200 and "idempotent_replay" not in first[2]
        for status, _, body in replays:
            assert status == 200 and body.pop("idempotent_replay") is True
            assert body == first[2]   # byte for byte the original
        idem = stats["idempotency"]
        assert idem["misses_total"] == 1.0
        assert idem["replayed_total"] + idem["joined_total"] == 3.0
    assert set(jax_side[1][2]) == set(port_side[1][2])
    assert set(jax_side[3]["idempotency"]) == set(port_side[3]["idempotency"])


def test_traceparent_in_and_out_and_trace_lookup(pods):
    tid = "5a" * 16

    def run(base):
        tp = f"00-{tid}-{'7b' * 8}-01"
        out = _gen(base, headers={"traceparent": tp})
        return (out, _http(base + f"/trace/{tid}"),
                _http(base + "/trace/" + "0f" * 16),
                _http(base + "/debug/flight?requests=4"))

    jax_side, port_side = _both(pods, run)
    names = []
    for out, trace, missing, flight in (jax_side, port_side):
        assert out[0] == 200
        assert out[1]["traceparent"].split("-")[1] == tid
        assert trace[0] == 200 and set(trace[2]) == {"trace_id", "traces"}
        [t] = trace[2]["traces"]
        assert t["trace_id"] == tid and not well_formed_problems(t)
        names.append(sorted(s["name"] for s in t["spans"]))
        assert missing[0] == 404
        assert flight[0] == 200
        assert tid in {r["trace_id"] for r in flight[2]["requests"]}
        assert flight[2]["engine_steps"]
    assert names[0] == names[1]
    assert {"model_infer", "queue", "prefill", "decode", "tokenize",
            "detokenize"} <= set(names[1])
    assert set(jax_side[3][2]) == set(port_side[3][2])
    assert set(jax_side[3][2]["engine_steps"][-1]) == \
        set(port_side[3][2]["engine_steps"][-1])


def test_debug_faults_gated_by_env(pods, monkeypatch, clean_faults):
    monkeypatch.delenv("SHAI_FAULTS_ENDPOINT", raising=False)
    spec = {"spec": "engine.step=delay(0.01)@0.5#3", "seed": 4}
    shut = _both(pods, lambda b: _http(b + "/debug/faults", spec))
    assert [s[0] for s in shut] == [403, 403]
    monkeypatch.setenv("SHAI_FAULTS_ENDPOINT", "1")
    armed = _both(pods, lambda b: _http(b + "/debug/faults", spec))
    assert [s[0] for s in armed] == [200, 200]
    assert armed[0][2] == armed[1][2]   # the same schedule, clause for clause
    got = _both(pods, lambda b: _http(b + "/debug/faults"))
    assert got[0][2] == got[1][2] and got[0][2]["active"]
    bad = _both(pods, lambda b: _http(b + "/debug/faults",
                                      {"spec": "x=frobnicate"}))
    assert [s[0] for s in bad] == [400, 400]


def test_step_stall_liveness_cycle(pods, clean_faults):
    def run(base):
        assert _http(base + "/health")[0] == 200
        _faults(base, "engine.step=stall(3)#1")
        box = {}
        t = threading.Thread(target=lambda: box.setdefault("r", _gen(base)))
        t.start()
        stuck = None
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10.0 and stuck is None:
            h = _http(base + "/health")
            if h[0] == 503:
                stuck = h
            time.sleep(0.05)
        t.join(timeout=60)
        return stuck, box.get("r"), _http(base + "/health")

    limits = [svc._watchdog.threshold_s(svc._engine.obs)
              for svc in (pods.jservice, pods.service)]
    for stuck, req, after in _both(pods, run):
        assert stuck is not None, f"liveness never failed; limits {limits}"
        assert stuck[2]["status"] == "stuck" and "stalled" in stuck[2]["error"]
        assert req[0] == 200
        assert after[0] == 200 and after[2] == {"status": "ok"}


def test_deadline_504_under_step_delay(pods, clean_faults):
    def run(base):
        _faults(base, "engine.step=delay(0.15)")
        return _gen(base, n=16, headers={"x-shai-deadline-ms": "600"})

    jax_side, port_side = _both(pods, run)
    assert jax_side[0] == port_side[0] == 504
    assert set(jax_side[2]) == set(port_side[2]) == {"detail"}


def test_benchmark_load_serve_and_stats(pods):
    def run(base):
        return (_http(base + "/benchmark", {"n_runs": 2}),
                _http(base + "/benchmark", {"n_runs": 0}),
                _http(base + "/load/1/infer/2"),
                _http(base + "/load/0/infer/2"),
                _http(base + "/serve"),
                _http(base + "/stats"),
                _http(base + "/debug/conformance"))

    jax_side, port_side = _both(pods, run)
    for bench, bad, load, bad_load, ui, stats, conf in (jax_side, port_side):
        assert (bench[0], bad[0], load[0], bad_load[0], ui[0]) == \
            (200, 400, 200, 400, 200)
        assert bench[2]["report"]["n_runs"] == 2
        assert len(load[2]["rounds"]) == 1
        assert ui[1]["content-type"].startswith("text/html")
        assert "/generate" in ui[2]
        assert stats[0] == 200 and not stats[2]["draining"]
        assert conf[2]["verdict"]["ok"] is True
    assert set(jax_side[0][2]) == set(port_side[0][2]) == {"app", "report"}
    assert set(jax_side[0][2]["report"]) == set(port_side[0][2]["report"])
    assert set(jax_side[2][2]) == set(port_side[2][2])
    assert set(jax_side[2][2]["rounds"][0]) == \
        set(port_side[2][2]["rounds"][0])
    ops = {"inflight", "lane_pending", "draining", "engine", "slo", "hbm",
           "perf", "qos", "service"}
    assert ops <= set(jax_side[5][2]) and ops <= set(port_side[5][2])
    jconf, tconf = jax_side[6][2], port_side[6][2]
    assert set(jconf) == set(tconf)
    assert jconf["verdict"].keys() == tconf["verdict"].keys()
    assert set(jconf["slo"]) == set(tconf["slo"])
    assert set(jconf["perf"]) == set(tconf["perf"])
    assert set(tconf["hbm"]) - set(jconf["hbm"]) == {
        f[len("shai_hbm_"):] for f in PORT_ONLY_FAMILIES}
    assert set(jconf["hbm"]) <= set(tconf["hbm"])


def test_metrics_operating_families_match(pods):
    def run(base):
        assert _gen(base, headers={"x-shai-tenant": "acme"})[0] == 200
        status, hdrs, text = _http(base + "/metrics")
        assert status == 200
        # name -> (type, the label names its samples carry)
        return {f.name: (f.type, frozenset(k for smp in f.samples
                                           for k in smp.labels))
                for f in text_string_to_metric_families(text)
                if f.name.startswith(OPS_PREFIXES)
                # the flush reasons a run met are data, not contract; a
                # *_created family is prometheus_client's creation stamp
                and not f.name.startswith("shai_service_pipeline_flush_")
                and not f.name.endswith("_created")}

    jfam, tfam = _both(pods, run)
    assert set(tfam) - set(jfam) == PORT_ONLY_FAMILIES
    assert {k: tfam[k] for k in jfam} == jfam
    assert tfam["shai_shed"][1] == {"app", "nodepool", "reason", "tenant"}
    for fam in ("shai_shed", "shai_tenant_requests", "shai_tenant_ttft_seconds",
                "shai_tenant_tokens", "shai_tenant_budget_balance",
                "shai_idemp_replayed", "shai_slo_breach",
                "shai_perf_conformance", "shai_hbm_leak_suspect",
                "shai_service_executables"):
        assert fam in tfam, fam


def test_stream_holds_its_inflight_slot_port_only(pods, clean_faults):
    """The reference's ``test_client_disconnect_mid_stream_cancels_engine``
    (``tests/test_chaos.py``) fails on the JAX package, a baseline
    failure, so this counterpart drives the port pod only: a live SSE
    stream counts in flight until the client goes away mid-stream, the
    engine request is cancelled, and the slot is released."""
    app, service = pods.tsrv.app, pods.service
    _faults(pods.port, "engine.step=delay(0.05)")
    # the stream cannot finish first: EOS unreachable, 30 steps >= 1.5 s;
    # chat's first chunk (the role preamble) goes out at once
    eos, service.eos_id = service.eos_id, -1
    body = json.dumps({"messages": [{"role": "user", "content": "go"}],
                       "stream": True, "max_tokens": 30,
                       "temperature": 0.0}).encode()
    scope = {"type": "http", "method": "POST",
             "path": "/v1/chat/completions", "query_string": b"",
             "headers": [(b"content-type", b"application/json"),
                         (b"content-length", str(len(body)).encode())]}
    chunks, inflight_seen = [], []

    async def drive():
        disconnect = asyncio.Event()
        sent = {"v": False}

        async def receive():
            if not sent["v"]:
                sent["v"] = True
                return {"type": "http.request", "body": body,
                        "more_body": False}
            await disconnect.wait()
            return {"type": "http.disconnect"}

        async def send(message):
            if message["type"] == "http.response.body" and \
                    message.get("body"):
                chunks.append(message["body"])
                inflight_seen.append(app.state["status"]["inflight"])
                if len(chunks) >= 2:
                    disconnect.set()

        await asyncio.wait_for(app(scope, receive, send), timeout=60.0)

    try:
        asyncio.run(drive())
    finally:
        service.eos_id = eos
    assert 2 <= len(chunks) < 30
    assert not any(b"[DONE]" in c for c in chunks)
    assert inflight_seen and max(inflight_seen) >= 1
    t0 = time.monotonic()
    while (app.state["status"]["inflight"] or service._engine.has_work) \
            and time.monotonic() - t0 < 10.0:
        time.sleep(0.05)
    assert app.state["status"]["inflight"] == 0
    assert not service._engine.has_work
    assert service._engine.cache.leaked_blocks == 0


def _revive(pod_service, loop_cls):
    """Test harness only: a crashed loop is permanent by design; give the
    same engine a fresh loop so the remaining cases can run."""
    pod_service.loop = loop_cls(pod_service._engine).start()


def test_step_crash_fails_requests_and_readiness(pods, clean_faults):
    def run(base):
        _faults(base, "engine.step=error#1")
        crashed = _gen(base)
        return (crashed, _http(base + "/readiness"), _gen(base),
                _http(base + "/health"))

    jax_side, port_side = _both(pods, run)
    for crashed, ready, after, health in (jax_side, port_side):
        assert crashed[0] == 500
        assert ready[0] == 503 and ready[2]["status"] == "unhealthy"
        assert after[0] == 503
        assert health[0] == 200   # liveness: the pod restarts on readiness
    assert set(jax_side[1][2]) == set(port_side[1][2])
    _revive(pods.jservice, JEngineLoop)
    _revive(pods.service, EngineLoop)
    for base in (pods.ref, pods.port):
        _wait_ready(base, timeout=30)


def test_drain_sequence_last(pods):
    """Last: the drain stops each pod's engine loop."""
    def run(base, app, service):
        _faults(base, "engine.step=delay(0.03)")
        res = {}
        threads = [threading.Thread(target=lambda i=i: res.__setitem__(
            i, _gen(base, n=12, prompt=f"d{i}"))) for i in range(2)]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        while app.state["status"]["inflight"] < 2:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        assert app.state["begin_drain"]() is True
        assert app.state["begin_drain"]() is False   # one drain per process
        ready = _http(base + "/readiness")
        shed = _gen(base)
        for t in threads:
            t.join(timeout=120)
        t0 = time.monotonic()
        while service.loop.alive and time.monotonic() - t0 < 30:
            time.sleep(0.05)
        return ready, shed, [res[i] for i in range(2)], service

    jax_side, port_side = _both(pods, lambda b: run(
        b, *((pods.jsrv.app, pods.jservice) if b == pods.ref
             else (pods.tsrv.app, pods.service))))
    for ready, shed, done, service in (jax_side, port_side):
        assert ready[0] == 503 and ready[2] == {"status": "draining"}
        assert shed[0] == 503 and "retry-after" in shed[1]
        assert [d[0] for d in done] == [200, 200]
        assert not service.loop.alive
        assert service._engine.cache.leaked_blocks == 0
    assert set(jax_side[1][2]) == set(port_side[1][2]) == {"detail"}
    # the port's loop left no replay in flight behind it
    assert pods.service._engine._pipe is None
    # the drain records its outcome just after the service's drain stops
    # the loop: wait for the record, not only for the loop
    status, t0 = pods.tsrv.app.state["status"], time.monotonic()
    while "drained" not in status and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    assert status["drained"]["clean"] is True
    # migration is not armed on these pods: the drain's migrate phase
    # stayed inert (nothing shipped, every request finished in place)
    assert not pods.service.wants_migration()
    assert pods.tsrv.app.state["status"]["drained"]["migrated"] == 0
    mig = pods.service._engine.obs.migrate.snapshot()
    assert mig["shipped"] == mig["fallbacks"] == 0


def test_serve_config_reads_the_resilience_env_like_the_reference(
        monkeypatch):
    env = {"MAX_INFLIGHT": "7", "ADMIT_MAX_QUEUE": "3.5",
           "ADMIT_MAX_KV": "0.75", "DRAIN_BUDGET_S": "12.5",
           "METRICS_PORT": "9333", "NUM_OF_RUNS_INF": "5"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DEVICE", "cpu")
    j, t = JServeConfig.from_env(), ServeConfig.from_env()
    for f in ("max_inflight", "admit_max_queue", "admit_max_kv",
              "drain_budget_s", "metrics_port", "num_of_runs_inf"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t)["max_inflight"] == 7
    monkeypatch.setenv("MAX_INFLIGHT", "-1")
    with pytest.raises(ValueError, match="MAX_INFLIGHT"):
        ServeConfig.from_env()


def test_profile_trace_holds_the_engine_ranges_port_only(tmp_path):
    """``POST /profile/{s}`` profiles every thread: the trace holds the
    engine loop's ``engine.prefill``/``engine.decode`` ranges and the lane
    thread's request spans (``tokenize``), entered only while the session
    runs. Port only: the JAX pod's trace is an XLA profile."""
    cfg = ServeConfig(vllm_config=str(tmp_path / "absent.yaml"),
                      artifact_root=str(tmp_path / "artifacts"),
                      **dict(POD_KW, max_inflight=0))
    service = VllmService(cfg)
    srv = Server(create_app(cfg, service, publisher=MetricsPublisher(
        cfg.app, cfg.nodepool, cfg.pod_name, emit_json=False)),
        host="127.0.0.1", port=0)
    host, port = srv.start_background()
    base = f"http://{host}:{port}"
    try:
        _wait_ready(base)
        status, _, out = _http(base + "/profile/1", {})
        assert status == 200
        assert _gen(base)[0] == 200
        t0 = time.monotonic()
        while _http(base + "/profile")[2]["running"]:
            assert time.monotonic() - t0 < 30
            time.sleep(0.1)
        with open(f"{out['trace_dir']}/trace.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"engine.prefill", "engine.decode", "tokenize"} <= names
    finally:
        srv.stop()
        service.close()


def test_metrics_exporter_serves_the_page_on_its_own_port():
    """``MetricsPublisher.start_exporter`` (``METRICS_PORT``) serves the
    same exposition from a stdlib server, and the JSON-line push path
    writes one line per served request and per shed."""
    import io

    push = io.StringIO()
    pub = MetricsPublisher("vllm", "pool", "pod-0", stream=push)
    pub.publish(0.25)
    pub.count_shed("inflight", "acme")
    port = pub.start_exporter(0)
    try:
        status, hdrs, text = _http(f"http://127.0.0.1:{port}/metrics")
        assert status == 200 and hdrs["content-type"].startswith(
            "text/plain; version=0.0.4")
        assert text == pub.render()
        fams = {f.name for f in text_string_to_metric_families(text)}
        assert {"shai_requests", "shai_shed"} <= fams
        assert _http(f"http://127.0.0.1:{port}/nope")[0] == 404
    finally:
        pub.stop_exporter()
    lines = [json.loads(ln) for ln in push.getvalue().splitlines()]
    assert [ln["data"] for ln in lines] == [
        {"vllm-counter": 1, "pool": 1, "vllm-latency": 0.25},
        {"vllm-shed-inflight": 1}]
    assert {ln["ns"] for ln in lines} == {"hw-agnostic-infer"}
