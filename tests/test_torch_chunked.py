"""Chunked prefill, ragged decode and int8 KV pools in the port's runner
and engine, against the JAX package's, on the CPU.

Both sides read the same weights (a flax init carried over with
``params_from_jax``; the tiny config, 2 layers, head dim 16). The JAX side
runs as its tests run it: lock-step (``SHAI_ASYNC_DECODE=0``), its Pallas
pool kernels in interpret mode (``SHAI_PAGED_DECODE=1``, ``paged=True``),
its ragged continuation through the gather path it takes off the TPU. The
port takes the kernels' plain versions. Tolerances, as in
``tests/test_torch_runner.py`` (bf16 activations from the embedding on):

- logits (fp32, |logit| < 5): ``atol`` 6e-2, one or two bf16 ulps of the
  activations carried through the last norm and the unembedding;
- bf16 pool contents: ``atol`` 5e-2, two bf16 ulps at |k| < 5;
- int8 pool contents: scales within 2e-2 relative and the first layer's
  codes within 1 LSB, because the bf16 projections they quantize may
  round one or two ulps apart (a relative 2^-7), which moves an amax and
  a code by that much; a deeper layer's input also carries the int8
  attention's rounding, so its dequantized values are held to the bf16
  pool's bound plus one quantization step (a code may be 2 LSB apart);
- greedy tokens: ``tests/parity.py``'s ``assert_greedy_parity`` (equal,
  or diverging only at a bf16 tie of the reference's top-2 logits).
"""

import dataclasses
import json
import logging
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine import runner as jrunner
from scalable_hw_agnostic_inference_tpu.engine.cache import (
    PagedKVCache as JCache,
)
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine import runner as trunner
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import PagedKVCache
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402

BS = 16            # block size
BPS = 8            # blocks per sequence: max_model_len 128
N_BLOCKS = 24
LOGIT_ATOL = 6e-2
POOL_ATOL = 5e-2
SCALE_RTOL = 2e-2

SETTINGS = [(False, False), (True, False), (False, True), (True, True)]
SETTING_IDS = ["bucketed-bf16", "ragged-bf16", "bucketed-int8",
               "ragged-int8"]


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


# -- the runner ---------------------------------------------------------------

def _pools(cfg, quant):
    shape = (N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    dt = jnp.int8 if quant else jnp.bfloat16
    jkv = []
    for _ in range(cfg.n_layers):
        lay = {"k": jnp.zeros(shape, dt), "v": jnp.zeros(shape, dt)}
        if quant:
            lay["ks"] = jnp.zeros((N_BLOCKS, cfg.n_kv_heads), jnp.float32)
            lay["vs"] = jnp.zeros((N_BLOCKS, cfg.n_kv_heads), jnp.float32)
        jkv.append(lay)
    tkv = PagedKVCache(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, N_BLOCKS,
                       BS, BPS, device=torch.device("cpu"), quant=quant).kv
    return jkv, tkv


def _assert_pools_close(jkv, tkv):
    for li, (jl, tl) in enumerate(zip(jkv, tkv)):
        assert set(jl) == set(tl)
        for name in jl:
            got = tl[name].float().numpy()
            want = np.asarray(jl[name].astype(jnp.float32))
            if name in ("ks", "vs"):
                np.testing.assert_allclose(got, want, rtol=SCALE_RTOL,
                                           atol=0)
            elif tl[name].dtype == torch.int8:
                if li == 0:
                    np.testing.assert_allclose(got, want, atol=1, rtol=0)
                # values: the bf16 pool's bound plus one quantization step
                sc = np.asarray(jl[name + "s"])[:, None, :, None]
                err = np.abs(got - want) * sc
                assert (err <= POOL_ATOL + sc).all(), (li, name, err.max())
            else:
                np.testing.assert_allclose(got, want, atol=POOL_ATOL, rtol=0)


def _assert_logits_close(got, want):
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] >= 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decisive],
                                  want.argmax(-1)[decisive])


def _tables(rows):
    t = np.zeros((len(rows), BPS), np.int32)
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def _prefill_both(tiny, quant, jkv, tkv, ids, n_text, tables):
    jcfg, params, tcfg, model = tiny
    bucket, K = ids.shape[1], ids.shape[0]
    jfn = jrunner.make_prefill(jcfg, BS, BPS, bucket, n_seqs=K,
                               kv_quant=quant)
    jkv, jlog = jfn(params, jkv, jnp.asarray(ids), jnp.asarray(n_text),
                    jnp.asarray(tables))
    tfn = trunner.make_prefill(tcfg, BS, BPS, bucket, n_seqs=K,
                               kv_quant=quant)
    with torch.inference_mode():
        tkv, tlog = tfn(model, tkv, torch.from_numpy(ids),
                        torch.from_numpy(n_text), torch.from_numpy(tables))
    return jkv, np.asarray(jlog), tkv, tlog.numpy()


@pytest.mark.parametrize("ragged,quant", SETTINGS, ids=SETTING_IDS)
def test_prefill_cont_matches_jax(tiny, ragged, quant):
    """A 52-token prompt in 32-token chunks: the first chunk through the
    bucketed prefill, the second (20 live tokens, 12 of padding) through
    the continuation at start 32, static ladder or ragged. Each variant
    keeps the reference's order of scatter and attention."""
    jcfg, params, tcfg, model = tiny
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, jcfg.vocab_size, 52).astype(np.int32)
    tables = _tables([[3, 7, 12, 4]])
    jkv, tkv = _pools(jcfg, quant)
    jkv, _, tkv, _ = _prefill_both(tiny, quant, jkv, tkv, prompt[None, :32],
                                   np.array([32], np.int32), tables)
    ids = np.zeros((1, 32), np.int32)
    ids[0, :20] = prompt[32:]
    n = np.array([20], np.int32)
    jfn = jrunner.make_prefill_cont(jcfg, BS, BPS, 32, 0 if ragged else 2,
                                    kv_quant=quant, ragged=ragged)
    tfn = trunner.make_prefill_cont(tcfg, BS, BPS, 32, 0 if ragged else 2,
                                    kv_quant=quant, ragged=ragged)
    jargs = [jnp.asarray(ids), jnp.asarray(n), jnp.asarray(tables)]
    targs = [torch.from_numpy(ids), torch.from_numpy(n),
             torch.from_numpy(tables)]
    if ragged:
        jargs.append(jnp.asarray([32], jnp.int32))
        targs.append(torch.tensor([32], dtype=torch.int32))
    jkv, jlog = jfn(params, jkv, *jargs)
    with torch.inference_mode():
        tkv, tlog = tfn(model, tkv, *targs)
    _assert_logits_close(tlog.numpy(), np.asarray(jlog))
    _assert_pools_close(jkv, tkv)


@pytest.mark.parametrize("ragged,quant", SETTINGS[1:], ids=SETTING_IDS[1:])
def test_token_forward_matches_jax(tiny, ragged, quant):
    """Four decode steps over a batch with a padding row: ragged through
    B3 over the full window, bucketed int8 through B2's delegation to B3
    over a 4-block context bucket, int8 writes requantizing their block."""
    jcfg, params, tcfg, model = tiny
    rng = np.random.default_rng(6)
    ids = rng.integers(3, jcfg.vocab_size, (2, 32)).astype(np.int32)
    n_text = np.array([7, 30], np.int32)
    ids[0, 7:] = 0
    ids[1, 30:] = 0
    tables = _tables([[5, 2], [17, 11]])
    jkv, tkv = _pools(jcfg, quant)
    jkv, jlog, tkv, _ = _prefill_both(tiny, quant, jkv, tkv, ids, n_text,
                                      tables)
    dec_tables = _tables([[5, 2], [17, 11, 8], []])   # row 1 grows a block
    B, m_ctx = 3, BPS if ragged else 4
    jfwd = jrunner._make_token_forward(jcfg, BS, m_ctx, B, 1, None,
                                       paged=True, ragged=ragged,
                                       kv_quant=quant)
    tfwd = trunner._make_token_forward(tcfg, BS, m_ctx, B, 1, ragged=ragged,
                                       kv_quant=quant)
    tok = np.zeros((B,), np.int32)
    tok[:2] = jlog.argmax(-1)
    pos = np.array([7, 30, 0], np.int32)
    for _ in range(4):
        jkv, jl = jfwd(params, jkv, jnp.asarray(tok)[:, None],
                       jnp.asarray(pos)[:, None], jnp.asarray(dec_tables))
        with torch.inference_mode():
            tkv, tl = tfwd(model, tkv, torch.from_numpy(tok)[:, None],
                           torch.from_numpy(pos)[:, None],
                           torch.from_numpy(dec_tables))
        jl, tl = np.asarray(jl)[:2, 0], tl.numpy()[:2, 0]
        _assert_logits_close(tl, jl)
        tok[:2] = jl.argmax(-1)
        pos[:2] += 1
    # the padding row writes into the null block 0: garbage on both sides
    for lay in jkv:
        for name in lay:
            lay[name] = lay[name].at[0].set(0)
    for lay in tkv:
        for t in lay.values():
            t[0] = 0
    _assert_pools_close(jkv, tkv)


def test_runner_refuses_what_the_reference_asserts(tiny):
    _, _, tcfg, _ = tiny
    with pytest.raises(ValueError, match="full window"):
        trunner.make_decode(tcfg, BS, BPS, 2, ctx_blocks=4, ragged=True)
    with pytest.raises(ValueError, match="static continuation"):
        trunner.make_prefill_cont(tcfg, BS, BPS, 32, 0)
    with pytest.raises(ValueError, match="static continuation"):
        trunner.make_prefill_cont(tcfg, BS, BPS, 64, 6)
    trunner.make_prefill_cont(tcfg, BS, BPS, 64, 0, ragged=True)


def test_int8_pool_bytes_rule():
    """int8 blocks take half the bf16 bytes and the f32 scale rows ride
    beside them, priced once over every tensor, as the reference does."""
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=16, total_blocks=24,
              block_size=BS, blocks_per_seq=BPS)
    f = PagedKVCache(**kw, device=torch.device("cpu"))
    q = PagedKVCache(**kw, device=torch.device("cpu"), quant=True)
    assert q.pool_bytes < 0.6 * f.pool_bytes
    scale_bytes = 2 * 2 * 24 * 2 * 4
    assert q.pool_bytes == f.pool_bytes // 2 + scale_bytes
    assert q.pool_bytes == JCache(**kw, quant=True).pool_bytes
    assert f.pool_bytes == JCache(**kw).pool_bytes
    lay = q.kv[0]
    assert lay["k"].dtype == lay["v"].dtype == torch.int8
    assert lay["ks"].shape == lay["vs"].shape == (24, 2)
    assert lay["ks"].dtype == torch.float32


# -- the engine ---------------------------------------------------------------

ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=16,
                 context_encoding_buckets=(16, 32, 64),
                 token_generation_buckets=(32, 64), max_new_tokens=16)


def _both(tiny, monkeypatch, prompts, new_tokens, ragged=False, quant=False,
          **over):
    """Run the same greedy requests through both engines."""
    jcfg, params, tcfg, model = tiny
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "0")
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "1" if ragged else "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8" if quant else "")
    kw = dict(ENGINE_KW, **over)
    jeng = JEngine(jcfg, params, jconfig.EngineConfig(**kw))
    want = jeng.generate(prompts, JParams(temperature=0.0, logprobs=2,
                                          max_new_tokens=new_tokens))
    teng = LLMEngine(tcfg, model, tconfig.EngineConfig(**kw), device="cpu")
    got = teng.generate(prompts, SamplingParams(temperature=0.0,
                                                max_new_tokens=new_tokens))
    return teng, got, jeng, want


def _assert_pool_whole(eng):
    assert eng.cache.leaked_blocks == 0
    assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1


@pytest.mark.parametrize("ragged,quant", SETTINGS, ids=SETTING_IDS)
def test_engine_chunked_greedy_matches_jax(tiny, monkeypatch, ragged, quant):
    """A 100-token prompt chunks (64 + 36) while two short ones are
    admitted and decode beside it, under each setting of the two
    switches."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, n).tolist() for n in (100, 5, 40)]
    teng, got, jeng, want = _both(tiny, monkeypatch, prompts, 8,
                                  ragged=ragged, quant=quant)
    assert (teng._ragged, teng._kv_quant) == (ragged, quant)
    assert len(teng._ctx_buckets) == (1 if ragged else 3)
    assert teng.cache.kv[0]["k"].dtype == (torch.int8 if quant
                                           else torch.bfloat16)
    assert [f.n_prompt for f in got] == [100, 5, 40]
    assert [len(f.token_ids) for f in got] == [8, 8, 8]
    assert [f.stop_reason for f in got] == [f.stop_reason for f in want]
    assert_greedy_parity(got, want, label=f"ragged={ragged} quant={quant}")
    # the continuation ran: one function per start, or one per bucket
    conts = [k for k in teng._prefill if k[0] in ("cont", "rcont")]
    assert conts == [("rcont", 64) if ragged else ("cont", 4, 64)]
    _assert_pool_whole(teng)
    assert jeng.cache.leaked_blocks == 0


def test_engine_chunking_slot_stays_out_of_decode(tiny, monkeypatch):
    """While a prompt chunks, its slot neither grows nor decodes, short
    prompts are admitted beside it, and a second long prompt waits."""
    _, _, tcfg, model = tiny
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "1")
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(
        **dict(ENGINE_KW, context_encoding_buckets=(16, 32))), device="cpu")
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    long1 = eng.add_request(list(range(3, 3 + 90)), sp)   # 32 + 32 + 26
    eng.step()
    assert eng.n_chunking == 1 and eng.n_waiting == 0
    seq = eng.cache.seq(long1)
    assert seq.n_tokens == 90 and len(seq.blocks) == 6  # the whole run
    short = eng.add_request([1, 2, 3], sp)
    eng.step()       # chunk 2 of long1; the short prompt is admitted
    assert eng.n_chunking == 1 and eng.cache.seq(long1).n_tokens == 90
    assert eng.cache.seq(short).n_tokens == 4     # prompt + one decode
    long2 = eng.add_request(list(range(7, 7 + 70)), sp)
    eng.step()       # the final chunk of long1; long2 waits for it
    assert eng.n_chunking == 0 and eng.n_waiting == 1
    assert eng.cache.seq(long1).n_tokens == 91    # joined the decode batch
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    assert sorted(done) == sorted([long1, long2, short])
    assert all(len(f.token_ids) == 4 for f in done.values())
    _assert_pool_whole(eng)


def test_preemption_resume_past_the_bucket_chunks_whole(tiny, monkeypatch,
                                                        caplog):
    """Slice-1 fault: a preempted sequence whose prompt + generated tokens
    outgrew the largest bucket resumed cut to that bucket's tail. The
    reference chunks it whole (up to the chunk cap), and so does the port:
    the resume is admitted at its full length, and the tokens match."""
    jcfg, params, tcfg, model = tiny
    prompts = [list(range(3, 3 + 28)), list(range(40, 40 + 26))]
    admitted = []
    orig_admit = PagedKVCache.admit

    def admit(self, seq_id, n_tokens):
        admitted.append((seq_id, n_tokens))
        return orig_admit(self, seq_id, n_tokens)

    monkeypatch.setattr(PagedKVCache, "admit", admit)
    # 9 usable blocks of 8 tokens: both prompts fit (4 blocks each), and
    # the later one is preempted once both have grown past 32 tokens
    with caplog.at_level(logging.WARNING):
        teng, got, jeng, want = _both(
            tiny, monkeypatch, prompts, 24, block_size=8,
            context_encoding_buckets=(16, 32), token_generation_buckets=(),
            num_blocks=10, max_new_tokens=24)
    assert any("preempting seq" in r.getMessage() for r in caplog.records
               if "tpu_torch" in r.name)
    resumed = [n for sid, n in admitted if sid == 1][1:]
    assert resumed and all(n > 32 for n in resumed), admitted
    assert [f.stop_reason for f in got] == ["length"] * 2
    assert all(len(f.token_ids) == 24 for f in got)
    assert_greedy_parity(got, want, label="preemption resume")
    _assert_pool_whole(teng)


def test_prompt_past_the_chunk_cap_keeps_its_tail(tiny, monkeypatch):
    """Slice-1 fault: a prompt longer than the largest bucket was refused.
    The reference keeps its last ``_chunk_cap`` tokens (whole chunks, one
    position left to generate: min(127, 2 * 64) here) and chunks them."""
    prompt = np.random.default_rng(3).integers(3, 500, 200).tolist()
    teng, got, jeng, want = _both(tiny, monkeypatch, [prompt], 1)
    assert teng.max_prompt_len == jeng.max_prompt_len == 127
    assert got[0].n_prompt == want[0].n_prompt == 127
    assert got[0].stop_reason == "length" and len(got[0].token_ids) == 1
    assert_greedy_parity(got, want, label="chunk cap")
    rid = teng.add_request(prompt)
    assert teng.waiting[-1].req_id == rid
    assert teng.waiting[-1].prompt_ids == prompt[-127:]


def test_kv_quant_unknown_value_warns_and_stays_off(tiny, monkeypatch,
                                                    caplog):
    _, _, tcfg, model = tiny
    monkeypatch.setenv("SHAI_KV_QUANT", "fp4")
    with caplog.at_level(logging.WARNING):
        eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                        device="cpu")
    assert not eng._kv_quant and eng.cache.kv[0]["k"].dtype == torch.bfloat16
    assert any("not recognized" in r.getMessage() for r in caplog.records)


# -- the serving unit ---------------------------------------------------------

def test_unit_serves_chunked_prompts_with_both_switches(tmp_path,
                                                        monkeypatch):
    """The ``vllm`` unit on the CPU with ``SHAI_RAGGED_ATTENTION=1
    SHAI_KV_QUANT=int8``: the tiny tier's largest bucket is 128, so a
    200-byte prompt chunks, beside a short one, and ``/stats`` reports the
    chunking count."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
        VllmService,
    )
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "1")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8")
    cfg = ServeConfig(app="vllm", device="cpu", model_id="tiny",
                      batch_size=4, max_new_tokens=8, warmup=False,
                      vllm_config=str(tmp_path / "absent.yaml"))
    service = VllmService(cfg)
    srv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = srv.start_background()
    base = f"http://{host}:{port}"

    def http(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data, headers={
            "content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if http("/readiness")[0] == 200:
                    break
            except urllib.error.HTTPError:   # 503 until loaded
                assert time.monotonic() < deadline, "never became ready"
                time.sleep(0.1)
        results = [None, None]

        def one(i, prompt):
            results[i] = http("/generate", {"prompt": prompt,
                                            "temperature": 0.0,
                                            "max_new_tokens": 6})

        threads = [threading.Thread(target=one, args=(0, "x" * 200)),
                   threading.Thread(target=one, args=(1, "hello"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [r[0] for r in results] == [200, 200]
        assert [r[1]["n_prompt"] for r in results] == [201, 6]
        assert service._engine.max_prompt_len == 255
        assert service._engine._ragged and service._engine._kv_quant
        status, stats = http("/stats")
        assert stats["seqs_chunking"] == 0
        assert service._engine.cache.leaked_blocks == 0
    finally:
        srv.stop()
