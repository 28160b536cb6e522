"""The port's live migration (``kvnet/migrate.py``, the engine's
``snapshot_sequence``/``migrate_out``, the loop's ``migrate_all``, the
unit's ship and resume, the drain's migrate phase) against the JAX
package's, on the CPU.

Port of ``tests/test_migrate.py`` (its engine, wire and drain cases; the
fleet router's stay with the control plane). What is held:

- the ``KVMG`` envelope: the same manifest and entries (bf16 words, f32,
  the int8 four-tuple) encode to the same bytes in both packages, each
  package decodes the other's, and both refuse every cut of the header
  and manifest, a flipped manifest byte, a bad magic or version, a
  non-object manifest and a cut frame stream;
- the inbox (both packages): FIFO-bounded, each entry popped once;
- the engine: a request cut mid-decode (bf16 and int8 KV, async and
  lock-step), mid-chunk and while queued resumes on a second port engine
  from the restored run with the tokens of the unmigrated port engine,
  exactly, and of the unmigrated JAX engine (``tests/parity.py``); the
  manifest equals the JAX engine's cut at the same step; the int8 blocks
  and scales cross byte-exact; logprob entries survive, the stream is
  exactly once, QoS and the deadline's remainder cross, a pending token
  that ends the request finishes it as ``eos``/``length``; a
  ``migrate.restore`` fault recomputes with the same tokens; a JAX
  engine's cut resumes on a port engine and a port engine's on a JAX
  engine; pools exact everywhere;
- the loop: ``migrate_all`` finishes every live request on the loop
  thread and resolves its future with the manifest;
- the ship through a stand-in peer: the envelope posted and the ack
  parsed, the ``migrate.ship`` fault, refusals, a 429 routed around to
  the next peer; the peer env and the fleet lookup;
- the drain: the migrate phase runs when armed and not otherwise, before
  ``service.drain`` and the handoff hold;
- over sockets: a port pod drains and ships to a JAX pod (a stream and a
  request with logprobs), and a JAX pod drains and ships to a port pod;
  each resume replays once (a second replay is 404) and equals the
  receiving pod's unmigrated output, or parts at a bf16 tie.
"""

import dataclasses
import http.server
import json
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from prometheus_client.parser import text_string_to_metric_families

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.kvnet import migrate as jmig
from scalable_hw_agnostic_inference_tpu.kvnet.client import (
    publish_run as jpublish_run,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.resilience import (
    faults as jfaults,
)
from scalable_hw_agnostic_inference_tpu.serve.app import (
    create_app as jcreate_app,
)
from scalable_hw_agnostic_inference_tpu.serve.httpd import Server as JServer
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.loop import EngineLoop
from scalable_hw_agnostic_inference_tpu_torch.kvnet import frames
from scalable_hw_agnostic_inference_tpu_torch.kvnet import migrate as migmod
from scalable_hw_agnostic_inference_tpu_torch.kvnet.client import (
    ConnectError,
    KvNetStats,
    publish_run,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.obs.steploop import (
    StepTelemetry,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import (
    faults as rz_faults,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.app import (
    ModelService,
    create_app,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
    Exposition,
    engine_families,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402
from test_torch_openai import _http, _port_service, _wait_ready  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_logprobs import LP_ATOL  # noqa: E402

BF16 = jnp.bfloat16.dtype   # ml_dtypes' bfloat16, the JAX side's
#: the reference's engine shapes (tests/test_migrate.py)
ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=24,
                 enable_prefix_caching=True)


@pytest.fixture(autouse=True)
def _clean_faults():
    rz_faults.reset()
    jfaults.reset()
    yield
    rz_faults.reset()
    jfaults.reset()


# -- the envelope ------------------------------------------------------------

def _entries(seed, kind, n=3):
    """The same logical entries for both packages, ``(port, jax)``: bf16
    blocks are one set of 16-bit words, seen as ``frames.BF16`` by the port
    and as ml_dtypes' bfloat16 by JAX."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    L, bs, hk, dh = 2, 8, 2, 4
    for _ in range(n):
        h = int(rng.integers(-2**62, 2**62))
        shp = (L, bs, hk, dh)
        if kind == "bf16":
            words = [rng.integers(-2**15, 2**15, shp).astype(np.int16)
                     for _ in range(2)]
            port.append((h, *(w.view(frames.BF16) for w in words)))
            ref.append((h, *(w.view(BF16) for w in words)))
        elif kind == "f32":
            arrs = [rng.standard_normal(shp).astype(np.float32)
                    for _ in range(2)]
            port.append((h, *arrs))
            ref.append((h, *arrs))
        else:
            arrs = [rng.integers(-127, 128, shp).astype(np.int8)
                    for _ in range(2)]
            arrs += [rng.random((L, hk)).astype(np.float32)
                     for _ in range(2)]
            port.append((h, *arrs))
            ref.append((h, *arrs))
    return port, ref


def _manifest(seed):
    rng = np.random.default_rng(seed)
    ids = [int(x) for x in rng.integers(2, 500, 20)]
    return {"v": 1, "prompt_ids": ids, "generated": ids[-3:],
            "n_prompt": 17,
            "params": {"temperature": 0.0, "top_k": 0, "top_p": 1.0,
                       "max_new_tokens": 9, "eos_id": 257, "logprobs": 0},
            "priority": 2, "tenant": "acme", "deadline_ms": 1234.5,
            "rng_step": 7, "hashes": [int(rng.integers(-2**62, 2**62))
                                      for _ in range(3)],
            "idem_key": "k-1"}


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "manifest-only"])
def test_envelope_same_bytes_both_packages(kind):
    for seed in range(3):
        man = _manifest(seed)
        port, ref = ((), ()) if kind == "manifest-only" else \
            _entries(seed, kind)
        blob = migmod.encode_migration(man, port)
        assert blob == jmig.encode_migration(man, ref)
        for dec, want in ((jmig.decode_migration, ref),
                          (migmod.decode_migration, port)):
            got_man, got = dec(blob)
            assert got_man == man and len(got) == len(want)
            for g, w in zip(got, want):
                assert g[0] == w[0] and len(g) == len(w)
                for a, b in zip(g[1:], w[1:]):
                    assert a.shape == b.shape
                    assert frames.wire_name(a.dtype) == \
                        frames.wire_name(b.dtype)
                    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mod", [migmod, jmig], ids=["port", "jax"])
def test_envelope_roundtrip_and_strictness(mod):
    """The reference's ``test_envelope_roundtrip_and_strictness`` on each
    package, over one blob the other package wrote."""
    rng = np.random.default_rng(0)
    man = {"v": 1, "prompt_ids": [1, 2, 3], "generated": [7],
           "hashes": [11, 22], "params": {"max_new_tokens": 4}}
    entries = [(11, rng.standard_normal((2, 8, 2, 4)).astype(np.float32),
                rng.standard_normal((2, 8, 2, 4)).astype(np.float32))]
    other = jmig if mod is migmod else migmod
    blob = other.encode_migration(man, entries)
    man2, ent2 = mod.decode_migration(blob)
    assert man2 == man and ent2[0][0] == 11
    for a, b in zip(entries[0][1:], ent2[0][1:]):
        assert b.tobytes() == a.tobytes()
    m3, e3 = mod.decode_migration(other.encode_migration(man, ()))
    assert m3 == man and e3 == []
    for cut in range(1, min(len(blob), 40)):
        with pytest.raises(mod.MigrateError):
            mod.decode_migration(blob[:cut])
    bad = bytearray(blob)
    bad[mod._HEAD.size + 2] ^= 0xFF
    with pytest.raises(mod.MigrateError, match="CRC"):
        mod.decode_migration(bytes(bad))
    with pytest.raises(mod.MigrateError, match="magic"):
        mod.decode_migration(b"XXXX" + blob[4:])
    with pytest.raises(mod.MigrateError, match="version"):
        mod.decode_migration(blob[:4] + b"\x09" + blob[5:])
    body = json.dumps([1, 2]).encode()
    hdr = mod._HEAD.pack(mod.MAGIC, mod.VERSION, len(body),
                         zlib.crc32(body))
    with pytest.raises(mod.MigrateError, match="object"):
        mod.decode_migration(hdr + body)
    with pytest.raises(mod.MigrateError, match="frames"):
        mod.decode_migration(blob[:-3])
    with pytest.raises(mod.MigrateError):
        mod.encode_migration({"x": "y" * mod.MAX_MANIFEST_BYTES})


@pytest.mark.parametrize("mod", [migmod, jmig], ids=["port", "jax"])
def test_inbox_exactly_once_and_bounded(mod):
    inbox = mod.MigrationInbox(capacity=3)
    rids = [inbox.put({"i": i}) for i in range(5)]
    assert len(inbox) == 3
    assert inbox.pop(rids[0]) is None and inbox.pop(rids[1]) is None
    assert inbox.pop(rids[4]) == {"i": 4}
    assert inbox.pop(rids[4]) is None
    assert len(inbox) == 2
    # the storm guard: at the concurrent cap, or one short of evicting
    assert inbox.begin_accept(1) and not inbox.begin_accept(1)
    assert inbox.saturated(1)
    inbox.end_accept()
    assert not inbox.saturated(2) and inbox.begin_accept(2)
    assert not inbox.begin_accept(2)   # 2 banked + 1 accepting = capacity
    inbox.end_accept()


def test_migrate_families_export_on_every_engine():
    tele = StepTelemetry(total_blocks=8)
    tele.migrate = migmod.MigrateStats()
    tele.migrate.count("shipped")
    tele.migrate.count("resumed", 2)
    out = Exposition()
    engine_families(out, tele, "t")
    fams = {f.name: f for f in text_string_to_metric_families(out.text())}
    for fam in migmod.METRIC_FAMILIES:
        assert fams[fam[:-len("_total")]].type == "counter", fam
        assert fams[fam[:-len("_total")]].samples[0].name == fam
    assert fams["shai_migrate_resumed"].samples[0].value == 2.0
    bare = Exposition()
    engine_families(bare, StepTelemetry(total_blocks=8), "t")
    assert "shai_migrate" not in bare.text()
    assert migmod.METRIC_FAMILIES == jmig.METRIC_FAMILIES


# -- engines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


def _env(monkeypatch, tier=True, quant=False, async_decode=True):
    monkeypatch.setenv("SHAI_KVTIER", "1" if tier else "0")
    monkeypatch.setenv("SHAI_KVTIER_ASYNC", "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8" if quant else "")
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "0")
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_decode else "0")
    monkeypatch.delenv("SHAI_ROLE", raising=False)
    monkeypatch.delenv("SHAI_KVFABRIC", raising=False)
    monkeypatch.delenv("SHAI_KVFABRIC_PEERS", raising=False)


def _port(tiny, monkeypatch, tier=True, quant=False, async_decode=True,
          **over):
    _, _, tcfg, model = tiny
    _env(monkeypatch, tier, quant, async_decode)
    return LLMEngine(tcfg, model, tconfig.EngineConfig(
        **dict(ENGINE_KW, **over)), device="cpu")


def _jax(tiny, monkeypatch, tier=True, quant=False, async_decode=True):
    jcfg, params, _, _ = tiny
    _env(monkeypatch, tier, quant, async_decode)
    return JEngine(jcfg, params, jconfig.EngineConfig(**ENGINE_KW))


def _prompt(seed, length=40):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(2, 500, length)]


def _params(eng, n, lp=0):
    P = JParams if isinstance(eng, JEngine) else SamplingParams
    return P(temperature=0.0, max_new_tokens=n, logprobs=lp)


def _drain(eng):
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    eng.finish_pending()
    return done


def _run(eng, prompt, n, lp=0):
    rid = eng.add_request(list(prompt), _params(eng, n, lp))
    return _drain(eng)[rid]


_ORACLES = {}


def _oracle(tiny, monkeypatch, pkg, prompt, n, quant=False):
    """The unmigrated run (tier off, async), each computed once per
    module: ``pkg`` is "port" or "jax"; logprobs 2 for the parity rule."""
    key = (pkg, tuple(prompt), n, quant)
    if key not in _ORACLES:
        make = _port if pkg == "port" else _jax
        _ORACLES[key] = _run(make(tiny, monkeypatch, tier=False,
                                  quant=quant), prompt, n, lp=2)
    return _ORACLES[key]


def _resume_on(eng, man, stream=None):
    """Re-admit a decoded manifest (the unit's ``_resume_migrated``)."""
    pr = man["params"]
    P = JParams if isinstance(eng, JEngine) else SamplingParams
    sp = P(temperature=pr["temperature"], top_k=pr["top_k"],
           top_p=pr["top_p"], max_new_tokens=pr["max_new_tokens"],
           eos_id=pr["eos_id"], logprobs=pr.get("logprobs", 0))
    return eng.add_request(
        man["prompt_ids"], sp, already_generated=man["generated"],
        already_lp=man.get("lps"), orig_n_prompt=man["n_prompt"],
        on_token=stream)


def _wire(src, man, dst_mod=migmod):
    """The wire: the source tier's run -> the source package's envelope ->
    the destination package's decode."""
    src_mod = jmig if isinstance(src, JEngine) else migmod
    entries = (src.cache.tier.get_run(man["hashes"])
               if src.cache.tier is not None and man["hashes"] else [])
    return dst_mod.decode_migration(src_mod.encode_migration(man, entries))


def _assert_pool_exact(eng):
    cache = eng.cache
    assert cache.active == []
    used = (cache.total_blocks - 1) - cache.allocator.n_free
    assert used == len(cache._block2hash) and cache.leaked_blocks == 0
    if cache.tier is not None:
        snap = cache.tier.snapshot()
        assert snap["used_bytes"] == snap["entries"] * snap["block_nbytes"]


def _publish(eng, man, entries):
    pub = jpublish_run if isinstance(eng, JEngine) else publish_run
    return pub(eng.cache.tier, [int(h) for h in man["hashes"]], entries)


#: (quant, async) of each differential
MODES = {"async": (False, True), "lockstep": (False, False),
         "int8-async": (True, True), "int8-lockstep": (True, False)}


@pytest.mark.parametrize("mode", list(MODES))
def test_migrate_mid_decode_equals_unmigrated(tiny, monkeypatch, mode):
    quant, ad = MODES[mode]
    prompt = _prompt(5)
    A = _port(tiny, monkeypatch, quant=quant, async_decode=ad)
    B = _port(tiny, monkeypatch, quant=quant, async_decode=ad)
    rid = A.add_request(list(prompt), _params(A, 16, lp=2))
    for _ in range(7):
        A.step()
    fin = A.migrate_out(rid)
    assert fin.stop_reason == "migrated" and fin.migration["hashes"]
    man = fin.migration
    assert len(man["prompt_ids"]) > len(prompt)
    assert man["prompt_ids"][len(prompt):] == man["generated"] == \
        fin.token_ids
    if ad:
        assert A.obs.flush_reasons().get("migrate") == 1
    A.finish_pending()
    _assert_pool_exact(A)
    man2, entries = _wire(A, man)
    assert man2 == man
    if quant:
        # int8 blocks and their scales cross byte-exact, all four arrays
        for (h, *src), got in zip(A.cache.tier.get_run(man["hashes"]),
                                  entries):
            assert got[0] == h and len(got) == 5
            for a, b in zip(src, got[1:]):
                assert a.tobytes() == b.tobytes()
    assert _publish(B, man2, entries) == len(man["hashes"])
    rid2 = _resume_on(B, man2)
    got = _drain(B)[rid2]
    want = _oracle(tiny, monkeypatch, "port", prompt, 16, quant)
    assert got.token_ids == want.token_ids
    assert got.stop_reason in ("length", "eos")
    assert B.cache.tier.snapshot()["restored"] > 0
    # logprob entries: one per output token, those before the cut carried
    assert [e["token"] for e in got.logprobs] == want.token_ids
    assert_greedy_parity([got], [_oracle(tiny, monkeypatch, "jax", prompt,
                                         16, quant)], label=mode)
    _assert_pool_exact(B)


def test_manifest_equals_the_jax_engines(tiny, monkeypatch):
    """The same request cut at the same step on both packages' engines
    gives the same manifest (the run's hashes, the tokens, the budget)."""
    prompt = _prompt(8)
    mans = []
    for make in (_port, _jax):
        eng = make(tiny, monkeypatch, async_decode=False)
        rid = eng.add_request(list(prompt), _params(eng, 12),
                              priority=2, tenant="acme")
        for _ in range(5):
            eng.step()
        mans.append(eng.migrate_out(rid).migration)
        eng.finish_pending()
        _assert_pool_exact(eng)
    port, ref = mans
    for k in ("prompt_ids", "generated", "hashes", "params", "n_prompt",
              "priority", "tenant", "rng_step", "v"):
        assert port[k] == ref[k], k
    assert set(port) == set(ref)


def test_migrate_mid_chunk_and_queued_resume(tiny, monkeypatch):
    """A cut while the prompt chunks banks the chunks encoded so far; a
    cut while queued is a prompt replay with no run. Both resume with the
    unmigrated tokens."""
    prompt = _prompt(11, 80)     # chunks: 32 + 32 + 16
    want = _oracle(tiny, monkeypatch, "port", prompt, 8)
    A = _port(tiny, monkeypatch)
    rid = A.add_request(list(prompt), _params(A, 8))
    A.step()                     # the first chunk
    assert A.n_chunking == 1
    fin = A.migrate_out(rid)
    man = fin.migration
    assert fin.stop_reason == "migrated" and fin.token_ids == []
    assert man["prompt_ids"] == prompt and man["generated"] == []
    assert len(man["hashes"]) == 32 // 8
    assert man["hashes"] == A.cache.prefix_hashes(prompt)[:4]
    rid_q = A.add_request(list(prompt), _params(A, 8))   # never stepped
    fin_q = A.migrate_out(rid_q)
    assert fin_q.stop_reason == "migrated"
    assert fin_q.migration["hashes"] == [] and not A.has_work
    A.finish_pending()
    _assert_pool_exact(A)
    for m in (man, fin_q.migration):
        B = _port(tiny, monkeypatch)
        m2, entries = _wire(A, m)
        if entries:
            assert _publish(B, m2, entries) == 4
        rid2 = _resume_on(B, m2)
        assert _drain(B)[rid2].token_ids == want.token_ids
        _assert_pool_exact(B)
    assert_greedy_parity([want], [_oracle(tiny, monkeypatch, "jax", prompt,
                                          8)], label="mid-chunk")


def test_migrate_restore_fault_recomputes(tiny, monkeypatch):
    prompt = _prompt(5)
    A = _port(tiny, monkeypatch, async_decode=False)
    B = _port(tiny, monkeypatch, async_decode=False)
    rid = A.add_request(list(prompt), _params(A, 16))
    for _ in range(7):
        A.step()
    man, entries = _wire(A, A.migrate_out(rid).migration)
    stats = migmod.MigrateStats()
    rz_faults.configure("migrate.restore=error", 0)
    try:
        assert migmod.restore_entries(B.cache.tier, man, entries,
                                      stats) == 0
    finally:
        rz_faults.reset()
    assert stats.snapshot()["fallbacks"] == 1
    rid2 = _resume_on(B, man)
    assert _drain(B)[rid2].token_ids == \
        _oracle(tiny, monkeypatch, "port", prompt, 16).token_ids
    assert B.cache.tier.snapshot()["restored"] == 0
    # without the fault the same call publishes the run
    B2 = _port(tiny, monkeypatch, async_decode=False)
    assert migmod.restore_entries(B2.cache.tier, man, entries, stats) == \
        len(man["hashes"])


@pytest.mark.parametrize("ad", [True, False], ids=["async", "lockstep"])
def test_migrate_out_finishes_when_pending_completes(tiny, monkeypatch, ad):
    eng = _port(tiny, monkeypatch, async_decode=ad)
    rid = eng.add_request(_prompt(6), _params(eng, 3))
    streamed = []
    eng.waiting[0].on_token = streamed.append
    for _ in range(3):
        eng.step()
    fin = eng.migrate_out(rid)
    assert fin is not None and fin.stop_reason in ("length", "eos")
    assert fin.migration is None and len(fin.token_ids) <= 3
    assert streamed == fin.token_ids
    eng.finish_pending()
    _assert_pool_exact(eng)


def test_migrate_preserves_qos_deadline_and_logprobs(tiny, monkeypatch):
    prompt = _prompt(10)
    A = _port(tiny, monkeypatch, async_decode=False)
    rid = A.add_request(list(prompt), _params(A, 8, lp=1), priority=2,
                        tenant="acme", deadline_at=time.monotonic() + 30.0,
                        idem_key="idem-7")
    for _ in range(4):
        A.step()
    fin = A.migrate_out(rid)
    man = fin.migration
    assert man["tenant"] == "acme" and man["priority"] == 2
    assert 0.0 < man["deadline_ms"] <= 30_000.0
    assert man["params"]["max_new_tokens"] == 8 - len(man["generated"])
    assert man["idem_key"] == "idem-7"
    assert len(man["lps"]) == len(man["generated"]) == len(fin.logprobs)
    B = _port(tiny, monkeypatch, async_decode=False)
    man2, entries = _wire(A, man)
    _publish(B, man2, entries)
    rid2 = _resume_on(B, man2)
    got = _drain(B)[rid2]
    want = _run(_port(tiny, monkeypatch, tier=False, async_decode=False),
                prompt, 8, lp=1)
    assert got.token_ids == want.token_ids
    assert [e["token"] for e in got.logprobs] == want.token_ids
    # the entries before the cut crossed in the manifest, as computed; the
    # resumed ones come from a continuation over the restored run, within
    # the logprob tolerance of tests/test_torch_logprobs.py
    n_cut = len(man["lps"])
    assert got.logprobs[:n_cut] == want.logprobs[:n_cut]
    for g, w in zip(got.logprobs[n_cut:], want.logprobs[n_cut:]):
        assert g["top_ids"] == w["top_ids"]
        assert abs(g["logprob"] - w["logprob"]) <= LP_ATOL


@pytest.mark.parametrize("ad", [True, False], ids=["async", "lockstep"])
def test_migrate_streams_exactly_once(tiny, monkeypatch, ad):
    prompt = _prompt(11)
    want = _oracle(tiny, monkeypatch, "port", prompt, 12)
    streamed = []
    A = _port(tiny, monkeypatch, async_decode=ad)
    rid = A.add_request(list(prompt), _params(A, 12),
                        on_token=streamed.append)
    for _ in range(5):
        A.step()
    fin = A.migrate_out(rid)
    n_sent = len(streamed)
    assert streamed == fin.token_ids == want.token_ids[:n_sent]
    B = _port(tiny, monkeypatch, async_decode=ad)
    man2, entries = _wire(A, fin.migration)
    _publish(B, man2, entries)
    rid2 = _resume_on(B, man2, stream=streamed.append)
    assert _drain(B)[rid2].token_ids == want.token_ids
    assert streamed == want.token_ids


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_migrate_across_packages(tiny, monkeypatch, direction):
    """A cut on one package's engine, through its envelope, restored and
    resumed on the other's: the receiving package's unmigrated tokens (or
    parting at a bf16 tie)."""
    prompt = _prompt(7)
    if direction == "jax-to-port":
        A, B, dst = (_jax(tiny, monkeypatch), _port(tiny, monkeypatch),
                     migmod)
    else:
        A, B, dst = (_port(tiny, monkeypatch), _jax(tiny, monkeypatch),
                     jmig)
    rid = A.add_request(list(prompt), _params(A, 12, lp=2))
    for _ in range(6):
        A.step()
    fin = A.migrate_out(rid)
    A.finish_pending()
    man, entries = _wire(A, fin.migration, dst)
    assert _publish(B, man, entries) == len(man["hashes"]) > 0
    rid2 = _resume_on(B, man)
    got = _drain(B)[rid2]
    assert B.cache.tier.snapshot()["restored"] > 0
    want = _oracle(tiny, monkeypatch,
                   "port" if direction == "jax-to-port" else "jax",
                   prompt, 12)
    assert_greedy_parity([got], [want], label=direction)
    assert A.cache.leaked_blocks == B.cache.leaked_blocks == 0


def test_loop_migrate_all_on_the_loop_thread(tiny, monkeypatch):
    """``migrate_all`` refuses new work and finishes every live request
    (queued and running) as ``migrated`` on the loop thread."""
    eng = _port(tiny, monkeypatch, max_num_seqs=2)
    loop = EngineLoop(eng).start()
    rz_faults.configure("engine.step=delay(0.02)", 0)
    try:
        futs = [loop.submit(_prompt(20 + i), _params(eng, 24))
                for i in range(3)]
        t0 = time.monotonic()
        while eng.n_running < 2:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        time.sleep(0.1)
        assert loop.migrate_all(timeout=10.0) == 3
        fins = [f.result(timeout=10) for f in futs]
        with pytest.raises(RuntimeError, match="draining"):
            loop.submit([1, 2, 3])
    finally:
        rz_faults.reset()
        loop.stop()
    assert [f.stop_reason for f in fins] == ["migrated"] * 3
    assert sum(bool(f.migration["hashes"]) for f in fins) == 2
    assert fins[2].migration["hashes"] == []          # it was queued
    assert eng.cache.leaked_blocks == 0 and not eng.has_work


# -- the ship ----------------------------------------------------------------

def _ship_client(handler, **kw):
    """A client whose POSTs go to ``handler(url, body, headers)`` ->
    ``(status, headers, body)`` (or a raised ``ConnectError``)."""
    seen = []

    def post(url, body, headers, deadline):
        seen.append((url, body, headers))
        return handler(url, body, headers)

    c = migmod.MigrateClient(None, KvNetStats(), post_transport=post,
                             connect_retries=1, **kw)
    return c, seen


def _ack(**over):
    return 200, {}, json.dumps(dict({"accepted": True, "resume": "r1",
                                     "restored": 2}, **over)).encode()


def test_ship_posts_envelope_and_parses_ack():
    c, seen = _ship_client(lambda *a: _ack())
    man = {"prompt_ids": [1, 2], "hashes": []}
    assert c.ship("http://peer", man, ()) == {"accepted": True,
                                              "resume": "r1", "restored": 2}
    url, body, headers = seen[0]
    assert url == "http://peer" + migmod.MIGRATE_ROUTE
    assert headers["content-type"] == "application/x-shai-migrate"
    assert jmig.decode_migration(body) == (man, [])
    assert c.mstats.snapshot()["shipped"] == 1


def test_ship_fault_and_refusals_degrade():
    c, seen = _ship_client(lambda *a: _ack())
    rz_faults.configure("migrate.ship=error", 0)
    try:
        assert c.ship("http://peer", {"prompt_ids": [1]}, ()) is None
    finally:
        rz_faults.reset()
    snap = c.mstats.snapshot()
    assert snap["failed"] == 1 and snap["shipped"] == 0 and not seen
    for status, body in ((503, b"{}"), (200, b'{"accepted": false}'),
                         (200, b"not json")):
        c, _ = _ship_client(lambda *a, s=status, b=body: (s, {}, b))
        assert c.ship("http://peer", {"p": 1}, ()) is None
        assert c.mstats.snapshot()["failed"] == 1
    c, seen = _ship_client(lambda *a: _ack())
    assert c.ship("file:///etc/passwd", {"p": 1}, ()) is None
    assert c.mstats.snapshot()["fallbacks"] == 1 and not seen

    def refused(*a):
        raise ConnectError("refused")

    c, seen = _ship_client(refused)
    assert c.ship("http://gone", {"p": 1}, ()) is None
    assert len(seen) == 2      # one connect retry
    assert c.breaker_of("http://gone")._consecutive_failures == 2


def test_ship_any_routes_around_a_busy_peer():
    def handler(url, body, headers):
        if url.startswith("http://busy"):
            return 429, {"retry-after": "7"}, b"{}"
        return _ack(resume="r9")

    c, seen = _ship_client(handler)
    assert c.ship_any(["http://busy", "http://free"], {"p": 1}) == (
        "http://free", {"accepted": True, "resume": "r9", "restored": 2})
    snap = c.mstats.snapshot()
    assert snap["busy"] == 1 and snap["shipped"] == 1
    # every peer busy: the budget runs out, no ship
    c, _ = _ship_client(lambda *a: (429, {"retry-after": "0.1"}, b""))
    t0 = time.monotonic()
    assert c.ship_any(["http://busy"], {"p": 1}, budget_s=0.3) is None
    assert time.monotonic() - t0 < 2.0
    assert c.mstats.snapshot()["busy"] >= 2


class _Fleet(http.server.ThreadingHTTPServer):
    """A stand-in fleet controller answering ``GET /fleet``."""

    def __init__(self, snap):
        fleet = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(fleet.snap).encode()
                self.send_response(200 if self.path == "/fleet" else 404)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.snap = snap
        super().__init__(("127.0.0.1", 0), H)
        threading.Thread(target=self.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server_address[1]}"


def test_migrate_env_and_fleet_peers(monkeypatch):
    for k in ("SHAI_MIGRATE", "SHAI_MIGRATE_PEER_URL",
              "SHAI_MIGRATE_FLEET_URL"):
        monkeypatch.delenv(k, raising=False)
    for mod in (migmod, jmig):
        assert not mod.migration_enabled()
        assert mod.resolve_migrate_peer() == ""
    monkeypatch.setenv("SHAI_MIGRATE_PEER_URL", "http://peer:8000")
    for mod in (migmod, jmig):
        assert mod.migration_enabled()
        assert mod.resolve_migrate_peers() == ["http://peer:8000"]
    monkeypatch.delenv("SHAI_MIGRATE_PEER_URL")
    monkeypatch.setenv("SHAI_MIGRATE", "1")
    for budget, reserve, want in ((8.0, "99", 4.0), (30.0, "nonsense", 5.0),
                                  (30.0, "2", 2.0)):
        monkeypatch.setenv("SHAI_MIGRATE_RESERVE_S", reserve)
        assert migmod.migrate_reserve_s(budget) == \
            jmig.migrate_reserve_s(budget) == want
    for v, want in (("", 4), ("9", 9), ("0", 1), ("x", 4)):
        monkeypatch.setenv("SHAI_MIGRATE_MAX_INBOUND", v)
        assert migmod.migrate_max_inbound() == \
            jmig.migrate_max_inbound() == want
    fleet = _Fleet({
        "roles": {"decode": {"serving": ["d1", "d2"]},
                  "both": {"serving": ["m1"]},
                  "prefill": {"serving": ["pf"]}},
        "overloaded": ["d1"],
        "urls": {"d1": "http://d1", "d2": "http://d2", "m1": "http://m1",
                 "pf": "http://pf"}})
    try:
        monkeypatch.delenv("SHAI_MIGRATE")
        monkeypatch.setenv("SHAI_MIGRATE_FLEET_URL", fleet.url)
        assert migmod.migration_enabled()
        assert migmod.resolve_migrate_peer() == "http://d2"
        assert migmod.resolve_migrate_peer(own_url="http://d2") == \
            "http://m1"
        assert migmod.resolve_migrate_peers() == ["http://d2", "http://m1"]
        monkeypatch.setenv("SHAI_MIGRATE_FLEET_URL", fleet.url + "/nope")
        assert migmod.resolve_migrate_peers() == []
    finally:
        fleet.shutdown()
        fleet.server_close()


# -- the drain ---------------------------------------------------------------

class _Stub(ModelService):
    """A service recording the drain's calls, in order."""

    def __init__(self, wants=False, migrated=0, handoff=False):
        super().__init__(ServeConfig(app="stub", model_id="tiny",
                                     device="cpu"))
        self.calls = []
        self._wants, self._migrated, self._handoff = wants, migrated, handoff

    def load(self):
        pass

    def infer(self, payload):
        return {}

    def wants_migration(self):
        return self._wants

    def migrate_inflight(self):
        self.calls.append(("migrate", time.monotonic()))
        return self._migrated

    def drain(self, budget_s):
        self.calls.append(("drain", time.monotonic()))

    def pending_handoff(self):
        self.calls.append(("hold", time.monotonic()))
        return self._handoff


def _drain_stub(service, budget_s, inflight=0, monkeypatch=None):
    app = create_app(ServeConfig(app="stub", model_id="tiny", device="cpu",
                                 drain_budget_s=budget_s), service)
    app.state["status"]["inflight"] = inflight
    done = threading.Event()
    t0 = time.monotonic()
    assert app.state["begin_drain"](on_done=done.set)
    return app, done, t0


def test_drain_migrate_phase_when_armed(monkeypatch):
    """Armed, with work in flight past the budget less the reserve: the
    migrate phase runs after the reserve's wait and before the service
    drain and the hold."""
    monkeypatch.setenv("SHAI_MIGRATE_RESERVE_S", "5")   # capped to 0.6
    svc = _Stub(wants=True, migrated=2)
    app, done, t0 = _drain_stub(svc, 1.2, inflight=1)
    for _ in range(100):
        if svc.calls:
            break
        time.sleep(0.02)
    assert svc.calls and svc.calls[0][0] == "migrate"
    # at the budget less the reserve (0.6 s), before the budget ends
    assert 0.45 <= svc.calls[0][1] - t0 < 1.2
    app.state["status"]["inflight"] = 0
    assert done.wait(10)
    assert [c[0] for c in svc.calls] == ["migrate", "drain", "hold"]
    assert app.state["status"]["drained"]["migrated"] == 2
    assert app.state["status"]["drained"]["clean"] is True


def test_drain_migrate_phase_inert_when_not_armed_or_idle(monkeypatch):
    monkeypatch.setenv("SHAI_MIGRATE_RESERVE_S", "5")
    svc = _Stub(wants=False)
    app, done, t0 = _drain_stub(svc, 0.6, inflight=1)
    assert done.wait(10)
    assert [c[0] for c in svc.calls] == ["drain", "hold"]
    assert app.state["status"]["drained"] == {
        "clean": False, "migrated": 0,
        "seconds": app.state["status"]["drained"]["seconds"]}
    # armed, but nothing in flight: the phase never fires, and the drain
    # exits at once
    svc2 = _Stub(wants=True, migrated=5)
    app2, done2, t0 = _drain_stub(svc2, 5.0)
    assert done2.wait(10) and time.monotonic() - t0 < 2.0
    assert [c[0] for c in svc2.calls] == ["drain", "hold"]
    assert app2.state["status"]["drained"]["migrated"] == 0


# -- pods over sockets -------------------------------------------------------

POD_CONFIG = {"model": "tiny", "max_model_len": 256, "block_size": 16,
              "context_encoding_buckets": [32, 64, 128],
              "max_new_tokens": 48, "enable_prefix_caching": True}
PROMPT = ("tell me a long and winding story about a bicycle that learned "
          "to serve large language models quickly")


def _wait_inflight(app, n):
    t0 = time.monotonic()
    while app.state["status"]["inflight"] < n:
        assert time.monotonic() - t0 < 60
        time.sleep(0.01)


def _sse(base, prompt):
    """A streamed greedy completion: its text chunks and its last event."""
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps({
        "prompt": prompt, "temperature": 0.0, "max_tokens": 40,
        "stream": True}).encode(),
        headers={"content-type": "application/json"})
    texts, events = [], []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[6:])
            events.append(ev)
            texts += [c.get("text") or "" for c in ev.get("choices", [])]
    return "".join(texts), events


def _lp_fin(out):
    F = dataclasses.make_dataclass("F", ["token_ids", "logprobs"])
    return F([e["token"] for e in out["logprobs"]], out["logprobs"])


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Three pods in one process on loopback: a port pod A that drains and
    ships to a JAX pod J, which then drains and ships to a port pod B.
    Each pod has the tier (async copy-out) and a 2 s drain budget (the
    migrate phase fires after 1 s). Returns what each leg saw."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SHAI_KVTIER", "1")
    mp.setenv("SHAI_KVTIER_ASYNC", "1")
    mp.setenv("SHAI_MIGRATE_RESERVE_S", "99")       # capped at budget / 2
    for k in ("SHAI_ROLE", "SHAI_MIGRATE_PEER_URL", "SHAI_KVNET_PEER_URL",
              "SHAI_KVFABRIC", "SHAI_KVFABRIC_PEERS", "SHAI_MIGRATE"):
        mp.delenv(k, raising=False)
    tmp = tmp_path_factory.mktemp("fleet")
    conf = tmp / "vllm.yaml"
    conf.write_text(json.dumps(POD_CONFIG))
    servers, apps, services, bases = [], {}, {}, {}
    try:
        for name in ("A", "J", "B"):
            if name == "J":
                cfg = JServeConfig(app="vllm", device="cpu", model_id="tiny",
                                   batch_size=4, max_new_tokens=48,
                                   drain_budget_s=2.0, vllm_config=str(conf))
                svc = get_model("vllm")(cfg)
                app = jcreate_app(cfg, svc)
                srv = JServer(app, host="127.0.0.1", port=0)
            else:
                cfg, svc = _port_service(tmp, vllm_config=str(conf),
                                         max_new_tokens=48,
                                         drain_budget_s=2.0)
                app = create_app(cfg, svc)
                srv = Server(app, host="127.0.0.1", port=0)
            h, p = srv.start_background()
            servers.append(srv)
            apps[name], services[name] = app, svc
            bases[name] = f"http://{h}:{p}"
        for b in bases.values():
            _wait_ready(b)
        out = {"bases": bases, "services": services, "apps": apps}
        # leg 1: port A drains mid-decode, ships a stream and a request to J
        mp.setenv("SHAI_MIGRATE_PEER_URL", bases["J"])
        res = {}
        prompt2 = PROMPT + " and then some"
        rz_faults.configure("engine.step=delay(0.06)", 0)
        threads = [
            threading.Thread(target=lambda: res.__setitem__(
                "sse", _sse(bases["A"], PROMPT))),
            threading.Thread(target=lambda: res.__setitem__(
                "gen", _http(bases["A"] + "/generate", {
                    "prompt": prompt2, "temperature": 0.0,
                    "max_new_tokens": 40, "logprobs": 2})))]
        for t in threads:
            t.start()
        _wait_inflight(apps["A"], 2)
        time.sleep(0.3)
        assert apps["A"].state["begin_drain"]()
        for t in threads:
            t.join(60)
        rz_faults.reset()
        a = out["A"] = dict(res, prompts=(PROMPT, prompt2))
        # the stream's manifest as J banked it, and the port's unmigrated
        # run of its prompt (on B, the same weights as A)
        handle = a["sse"][1][-1]["migrated"]["resume"]
        a["sse_manifest"] = dict(services["J"]._migrate_inbox._entries[
            handle])
        a["port_sse"] = _http(bases["B"] + "/generate", {
            "prompt": PROMPT, "temperature": 0.0, "max_new_tokens": 40,
            "logprobs": 2})
        # the replays on J, then J's own unmigrated runs
        a["resume_sse"] = _http(bases["J"] + "/generate", {
            "resume": handle})
        a["resume_gen"] = _http(bases["J"] + "/generate", {
            "resume": a["gen"][1].get("resume")})
        a["replay_again"] = _http(bases["J"] + "/generate", {
            "resume": a["gen"][1].get("resume")})
        a["want_gen"] = _http(bases["J"] + "/generate", {
            "prompt": prompt2, "temperature": 0.0, "max_new_tokens": 40,
            "logprobs": 2})
        # leg 2: JAX J drains mid-decode and ships to port B
        mp.setenv("SHAI_MIGRATE_PEER_URL", bases["B"])
        prompt3 = "the jax pod hands this one over: " + PROMPT
        jfaults.configure("engine.step=delay(0.06)", 0)
        res = {}
        t = threading.Thread(target=lambda: res.__setitem__(
            "gen", _http(bases["J"] + "/generate", {
                "prompt": prompt3, "temperature": 0.0,
                "max_new_tokens": 40, "logprobs": 2})))
        t.start()
        _wait_inflight(apps["J"], 1)
        time.sleep(0.3)
        assert apps["J"].state["begin_drain"]()
        t.join(60)
        jfaults.reset()
        j = dict(res, prompt=prompt3)
        j["resume"] = _http(bases["B"] + "/generate", {
            "resume": j["gen"][1].get("resume")})
        j["want"] = _http(bases["B"] + "/generate", {
            "prompt": prompt3, "temperature": 0.0, "max_new_tokens": 40,
            "logprobs": 2})
        out["J"] = j
        out["stats"] = {n: _http(b + "/stats")[1] for n, b in bases.items()}
        out["metrics"] = {n: _http(b + "/metrics", raw=True)[1]
                          for n, b in bases.items() if n != "J"}
        yield out
    finally:
        rz_faults.reset()
        jfaults.reset()
        for srv in servers:
            srv.stop()
        for svc in services.values():
            if hasattr(svc, "close"):
                svc.close()
        mp.undo()


def test_port_pod_drains_and_ships_to_a_jax_pod(fleet):
    a = fleet["A"]
    # the stream ends with the in-band migrated record naming J
    text, events = a["sse"]
    rec = events[-1]["migrated"]
    assert rec["peer"] == fleet["bases"]["J"] and rec["resume"]
    assert rec["n_sent"] >= 1
    status, gen = a["gen"]
    assert status == 200 and gen["migrated"] is True and gen["resume"]
    assert gen["stop_reason"] == "migrated" and gen["n_sent"] >= 1
    assert gen["restored"] > 0      # the run crossed with the envelope
    # the request with logprobs: J's resume against J's unmigrated run
    status, out = a["resume_gen"]
    assert status == 200 and out["resumed"] is True, out
    status, want = a["want_gen"]
    assert status == 200 and out["n_tokens"] == want["n_tokens"] == 40
    if out["generated_text"] != want["generated_text"]:
        assert_greedy_parity([_lp_fin(out)], [_lp_fin(want)],
                             label="port->jax")
    # the stream (no logprobs on a stream): the tokens A sent before the
    # cut are the port's unmigrated tokens, what the client received is
    # a prefix of J's complete output, and J completed the budget
    man = a["sse_manifest"]
    status, port_want = a["port_sse"]
    assert status == 200
    got = man["generated"]
    assert got == [e["token"] for e in port_want["logprobs"]][:len(got)]
    assert len(got) == rec["n_sent"] and man["hashes"]
    status, out = a["resume_sse"]
    assert status == 200 and out["resumed"] is True, out
    assert out["n_tokens"] == 40
    assert out["generated_text"].startswith(text)
    assert a["replay_again"][0] == 404
    st = fleet["stats"]
    assert st["A"]["migrate"]["shipped"] == 2
    assert st["A"]["migrate"]["fallbacks"] == 0
    assert st["J"]["migrate"]["received"] == 2
    assert st["J"]["migrate"]["resumed"] == 2
    eng = fleet["services"]["A"]._engine
    assert eng.cache.leaked_blocks == 0 and not eng.has_work
    assert fleet["apps"]["A"].state["status"]["drained"]["migrated"] == 2
    assert eng.obs.flush_reasons().get("migrate", 0) >= 1
    for fam in migmod.METRIC_FAMILIES:
        assert fam in fleet["metrics"]["A"], fam


def test_jax_pod_drains_and_ships_to_a_port_pod(fleet):
    j = fleet["J"]
    status, gen = j["gen"]
    assert status == 200 and gen["migrated"] is True, gen
    assert gen["peer"] == fleet["bases"]["B"] and gen["restored"] > 0
    status, out = j["resume"]
    assert status == 200 and out["resumed"] is True, out
    status, want = j["want"]
    if out["generated_text"] != want["generated_text"]:
        assert_greedy_parity([_lp_fin(out)], [_lp_fin(want)],
                             label="jax->port")
    assert out["n_tokens"] == 40
    st = fleet["stats"]["B"]
    assert st["migrate"]["received"] == 1 and st["migrate"]["resumed"] == 1
    assert st["kvtier"]["restored"] > 0
    eng = fleet["services"]["B"]._engine
    assert eng.cache.leaked_blocks == 0 and eng.obs.recompiles == 0
    # a draining pod refuses envelopes; a live one 400s a corrupt one
    blob = migmod.encode_migration({"prompt_ids": [1, 2, 3],
                                    "hashes": []}, ())
    for name, body, code in (("A", blob, 503), ("B", blob[:-1], 400),
                             ("B", b"", 400)):
        req = urllib.request.Request(
            fleet["bases"][name] + "/kv/migrate", data=body,
            headers={"content-type": "application/x-shai-migrate"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == code, (name, code)
