"""The port's serving surface on the CPU: the ``vllm`` unit behind
``create_app`` and the stdlib server, ``DEVICE=cpu``, the ``tiny`` tier.

Port only: the JAX package's server runs the same routes, but nothing here
compares the two. What is held: ``/health`` answers at once, ``/readiness``
is 503 until the model is loaded and warm and 200 after, concurrent
``POST /generate`` requests all succeed through one engine, bad requests
are 400s, and stopping the server stops the engine loop.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
    VllmService,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig


def _http(url, payload=None, timeout=60.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class _GatedService(VllmService):
    """Holds ``load`` until the test opens the gate, so the not-ready
    window can be probed."""

    gate = threading.Event()

    def load(self):
        assert self.gate.wait(timeout=60)
        super().load()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    cfg = ServeConfig(app="vllm", device="cpu", model_id="tiny",
                      batch_size=4, max_new_tokens=32,
                      vllm_config=str(tmp_path_factory.mktemp("cfg")
                                      / "absent.yaml"))
    cfg.validate()
    service = _GatedService(cfg)
    srv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = srv.start_background()
    yield f"http://{host}:{port}", service
    srv.stop()


def test_health_then_readiness_gate(server):
    base, service = server
    assert _http(base + "/health") == (200, {"status": "ok"})
    status, body = _http(base + "/readiness")
    assert status == 503 and body["status"] == "loading"
    assert _http(base + "/generate", {"prompt": "hi"})[0] == 503
    service.gate.set()
    deadline = time.monotonic() + 120
    while _http(base + "/readiness")[0] != 200:
        assert time.monotonic() < deadline, "never became ready"
        time.sleep(0.1)
    assert _http(base + "/readiness") == (200, {"status": "ready"})


def test_concurrent_generate(server):
    base, service = server
    service.gate.set()
    while _http(base + "/readiness")[0] != 200:
        time.sleep(0.1)
    results = [None] * 6

    def one(i):
        results[i] = _http(base + "/generate", {
            "prompt": "hello " * (i + 1), "temperature": 0.0,
            "max_new_tokens": 6 + i})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, (status, body) in enumerate(results):
        assert status == 200, body
        assert body["n_tokens"] <= 6 + i
        assert body["stop_reason"] in ("eos", "length")
        assert isinstance(body["generated_text"], str)
        assert body["n_prompt"] == 1 + 6 * (i + 1)   # BOS + bytes
    status, stats = _http(base + "/stats")
    assert status == 200 and stats["served"] >= 6
    assert stats["blocks_total"] == service.ecfg.total_blocks
    assert service._engine.cache.leaked_blocks == 0
    status, root = _http(base + "/")
    assert root["device"] == "cpu" and "/generate" in root["endpoints"]


@pytest.mark.parametrize("payload,why", [
    ({}, "missing 'prompt'"),
    ({"prompt": "x", "max_new_tokens": 0}, "max_new_tokens"),
    ({"prompt": "x", "max_new_tokens": 10_000}, "exceeds"),
    ({"prompt": "x", "temperature": "hot"}, "bad sampling parameter"),
    ({"prompt": "x", "logprobs": 9}, "logprobs"),
])
def test_bad_requests_are_400(server, payload, why):
    base, service = server
    service.gate.set()
    while _http(base + "/readiness")[0] != 200:
        time.sleep(0.1)
    status, body = _http(base + "/generate", payload)
    assert status == 400 and why in json.dumps(body)


def test_server_stop_stops_the_engine_loop(tmp_path):
    cfg = ServeConfig(app="vllm", device="cpu", model_id="tiny",
                      vllm_config=str(tmp_path / "absent.yaml"),
                      warmup=False)
    service = VllmService(cfg)
    srv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = srv.start_background()
    base = f"http://{host}:{port}"
    deadline = time.monotonic() + 120
    while _http(base + "/readiness")[0] != 200:
        assert time.monotonic() < deadline
        time.sleep(0.1)
    assert service.loop.alive
    srv.stop()
    assert not service.loop.alive


@pytest.mark.parametrize("model_id", ["", "tiny"])
def test_tiny_tier_is_refused_on_cuda_with_a_clear_error(tmp_path,
                                                         monkeypatch,
                                                         model_id):
    """The tiny tier's head_dim (16) is not one the CUDA kernels take, so
    on ``DEVICE=cuda`` (the default, also with ``MODEL_ID`` unset) ``load``
    refuses it by name instead of failing later in a kernel. The device
    is resolved as the card here, so the check runs without one."""
    import torch

    from scalable_hw_agnostic_inference_tpu_torch.serve.units import vllm

    monkeypatch.setattr(vllm, "unit_device",
                        lambda cfg: torch.device("cuda"))
    cfg = ServeConfig(app="vllm", device="cuda", model_id=model_id,
                      vllm_config=str(tmp_path / "absent.yaml"))
    with pytest.raises(ValueError, match="head_dim 16.*geometry tier"):
        VllmService(cfg).load()
