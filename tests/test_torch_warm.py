"""Warmup of the closed executable set, and the pipeline's ``/stats`` keys,
on the CPU.

``warm_executables`` builds every prefill bucket x batch size, every
continuation key and every decode key before readiness; the port's count
must be the JAX engine's for the same ``EngineConfig`` (bucketed and
ragged), and after it a ``generate`` run builds nothing in either package
(0 recompiles). The ``tiny`` unit warms before its loop starts and its
``/stats`` carries the reference's ``executables``, ``pipeline_flushes``
(with one ``pipeline_flush_<reason>`` key per reason) and
``step_gap_mean_ms``.
"""

import dataclasses
import json
import time
import urllib.request

import pytest

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
    VllmService,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

# max_model_len 64 past the largest bucket 32: one static continuation
# (start 32), or the one ragged entry; two context buckets when bucketed
ENGINE_KW = dict(max_model_len=64, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32),
                 token_generation_buckets=(32,), max_new_tokens=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("ragged", [False, True], ids=["bucketed", "ragged"])
def test_warm_count_matches_jax_and_nothing_builds_after(tiny, monkeypatch,
                                                         ragged):
    """The same closed set in both packages, and a generate run over
    every prefill bucket, a chunked prompt and a changing decode batch
    after warmup builds nothing in either."""
    jcfg, params, tcfg, model = tiny
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "1" if ragged else "0")
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1")
    teng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                     device="cpu")
    jeng = JEngine(jcfg, params, jconfig.EngineConfig(**ENGINE_KW))
    n = teng.warm_executables()
    assert n == jeng.warm_executables()
    # prefill (16, 32) x K (1, 2); decode: 1 or 2 context buckets x batch
    # buckets (1, 2, 3); one continuation
    assert n == 4 + (1 if ragged else 2) * 3 + 1
    assert teng.n_executables == n == teng.obs.warmed_executables
    assert all(g.replays == 1 for g in teng._decode_fns.values())
    prompts = [[1, 5, 9], list(range(3, 23)), list(range(3, 43)), [2, 7]]
    teng.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=6))
    jeng.generate(prompts, JParams(temperature=0.0, max_new_tokens=6))
    assert teng.obs.recompiles == 0 and jeng.obs.recompiles == 0
    assert teng.n_executables == n
    assert teng.cache.leaked_blocks == 0
    # a build after warmup counts: a key outside the closed set
    teng._prefill_for(16, 4)
    assert teng.obs.recompiles == 1


def _http(url, payload=None, timeout=60.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_unit_warms_before_ready_and_stats_carry_pipeline_keys(tmp_path):
    cfg = ServeConfig(app="vllm", device="cpu", model_id="tiny",
                      batch_size=4, max_new_tokens=16,
                      vllm_config=str(tmp_path / "absent.yaml"))
    cfg.validate()
    service = VllmService(cfg)
    srv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = srv.start_background()
    base = f"http://{host}:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _http(base + "/readiness")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "never became ready"
            time.sleep(0.1)
        eng = service._engine
        # the closed set was built before the loop served anything
        assert eng._warmed and eng.obs.warmed_executables == \
            eng.n_executables > 0
        for text in ("hello", "a longer prompt for the second request"):
            status, body = _http(base + "/generate", {
                "prompt": text, "temperature": 0.0, "max_new_tokens": 6})
            assert status == 200 and body["n_tokens"] == 6
        status, stats = _http(base + "/stats")
        assert status == 200
        assert stats["executables"] == eng.obs.warmed_executables
        assert stats["pipeline_flushes"] >= 1
        reasons = {k for k in stats if k.startswith("pipeline_flush_")}
        assert reasons and sum(stats[k] for k in reasons) == \
            stats["pipeline_flushes"]
        assert stats["step_gap_mean_ms"] >= 0.0
        assert eng.obs.recompiles == 0
    finally:
        srv.stop()
        service.close()
