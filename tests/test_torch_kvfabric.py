"""The port's fleet KV fabric (``kvnet/directory.py``, the engine's
peer-probe rung, ``POST /kv/pull``, ``POST /kv/protect``, the
``kvfabric`` telemetry) against the JAX package's, on the CPU.

Port of ``tests/test_kvfabric.py`` (its pod-side cases; the fleet
controller's stay with the control plane). The directory changes where KV
bytes are looked for, never what is generated. What is held:

- the env gate and ``KvDirectory`` (ranking, retirement, affinity, hits,
  sole holders, the TTL prune) case for case on both packages;
- the host tier's advertisement against a walk over the stored chains
  through store, touch and eviction, its bound, and ``protect`` deferring
  eviction until capacity wins (both packages' tiers);
- ``FabricProbe`` through a stand-in holder: a pull counted as a remote
  hit, a stale holder told apart from an unreachable one, the static-peer
  directory refreshed from ``/kv/digests``; the counters equal the JAX
  probe's on the same scenario;
- the engine: a fabric-armed port engine whose probe pulls from a holder
  engine's tier (a port prefill engine, bf16 and int8 KV, async and
  lock-step; a JAX prefill engine) gives the fabric-off tokens (and the
  JAX engine's, or parting at a bf16 tie); fabric off builds no probe and
  a holder hint changes nothing (tokens, counters, executables, the
  tier's and the engine's snapshots); a deadline with less headroom than
  the recompute it saves skips the probe; an injected ``kvfabric.probe``
  fault recomputes with the same tokens, opens the holder's breaker, and
  the rung recovers once the breaker lets a probe through; pools exact;
- over sockets: a prefill pod holds a run, and a pod armed with
  ``SHAI_KVFABRIC_PEERS`` naming it serves the prompt warm from it, with
  the tokens of a fabric-off engine; a holder without the run is a
  counted stale miss; the probe fault still answers 200; ``/kv/pull``,
  ``/kv/protect``, the ``/stats`` sections and the ``shai_kvfabric_*``
  families.
"""

import dataclasses
import json
import sys
import time
import urllib.parse
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
from scalable_hw_agnostic_inference_tpu.kvnet import directory as jdir
from scalable_hw_agnostic_inference_tpu.kvnet import frames as jframes
from scalable_hw_agnostic_inference_tpu.kvnet.client import (
    KvNetClient as JKvNetClient,
    KvNetStats as JKvNetStats,
)
from scalable_hw_agnostic_inference_tpu.kvtier.pool import (
    HostKVTier as JTier,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.kvnet import directory as tdir
from scalable_hw_agnostic_inference_tpu_torch.kvnet import frames
from scalable_hw_agnostic_inference_tpu_torch.kvnet.client import (
    ConnectError,
    KvNetClient,
    KvNetStats,
)
from scalable_hw_agnostic_inference_tpu_torch.kvtier.affinity import (
    prompt_affinity,
)
from scalable_hw_agnostic_inference_tpu_torch.kvtier.pool import HostKVTier
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.obs.steploop import (
    StepTelemetry,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import (
    faults as rz_faults,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
    Exposition,
    engine_families,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402
from test_torch_openai import _http, _port_service, _wait_ready  # noqa: E402

#: the reference's engine shapes (tests/test_kvfabric.py)
ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16,
                 enable_prefix_caching=True)


@pytest.fixture(autouse=True)
def _clean_faults():
    rz_faults.reset()
    yield
    rz_faults.reset()


# -- the env gate and the directory ------------------------------------------

@pytest.mark.parametrize("mod", [tdir, jdir], ids=["port", "jax"])
def test_fabric_enabled_gate_and_peers(monkeypatch, mod):
    monkeypatch.delenv("SHAI_KVFABRIC", raising=False)
    monkeypatch.delenv("SHAI_KVFABRIC_PEERS", raising=False)
    assert not mod.fabric_enabled()
    monkeypatch.setenv("SHAI_KVFABRIC", "1")
    assert mod.fabric_enabled()
    monkeypatch.setenv("SHAI_KVFABRIC", "0")
    assert not mod.fabric_enabled()
    monkeypatch.setenv("SHAI_KVFABRIC_PEERS", "http://a:8000, http://b:8000/")
    assert mod.fabric_enabled()
    assert mod.resolve_fabric_peers() == ["http://a:8000", "http://b:8000"]


@pytest.mark.parametrize("mod", [tdir, jdir], ids=["port", "jax"])
def test_directory_holders_ranking_and_retirement(mod):
    d = mod.KvDirectory(ttl_s=60)
    d.update_holder("http://a", [{"head": 1, "n": 4, "seq": 9}])
    d.update_holder("http://b/", [{"head": 1, "n": 6, "seq": 2},
                                  {"head": 2, "n": 1, "seq": 3}])
    assert d.holders_of(1) == ["http://b", "http://a"]
    assert d.holders_of(2) == ["http://b"]
    assert d.holders_of(None) == [] and d.holders_of(999) == []
    assert d.size() == 2
    d.update_holder("http://b", [{"head": 2, "n": 1, "seq": 4}])
    assert d.holders_of(1) == ["http://a"]
    d.update_holder("http://a", [])
    assert d.holders_of(1) == [] and d.size() == 1
    d.update_holder("http://c", [{"n": 3}, "bogus", {"head": "x"},
                                 {"head": 7, "n": 2, "seq": 1}])
    assert d.holders_of(7) == ["http://c"]
    # ties on run length: the most recently seen holder first
    d.update_holder("http://e", [{"head": 9, "n": 2}], now=1.0)
    d.update_holder("http://f", [{"head": 9, "n": 2}], now=2.0)
    assert d.holders_of(9) == ["http://f", "http://e"]


@pytest.mark.parametrize("mod", [tdir, jdir], ids=["port", "jax"])
def test_directory_affinity_hits_sole_holders_and_prune(mod):
    d = mod.KvDirectory(ttl_s=60)
    d.note_affinity("aff1", 11)
    assert d.head_of("aff1") == 11 and d.head_of("nope") is None
    d.update_holder("http://a", [{"head": 11, "n": 4, "seq": 1}])
    d.update_holder("http://b", [{"head": 11, "n": 4, "seq": 1},
                                 {"head": 12, "n": 2, "seq": 2}])
    assert d.sole_holders() == {12: "http://b"}
    assert [d.note_hit(11), d.note_hit(11), d.note_hit(12)] == [1, 2, 1]
    assert d.hot_heads(2) == [(11, 2)]
    assert d.hot_heads(1) == [(11, 2), (12, 1)]
    for i in range(mod.MAX_AFF_HEADS + 5):
        d.note_affinity(f"x{i}", i)
    assert d.head_of("aff1") is None and d.head_of("x5") == 5
    p = mod.KvDirectory(ttl_s=10.0)
    p.update_holder("http://a", [{"head": 1, "n": 2, "seq": 1}], now=100.0)
    p.update_holder("http://b", [{"head": 1, "n": 2, "seq": 1}], now=105.0)
    assert p.prune(now=112.0) == 1 and p.holders_of(1) == ["http://b"]
    assert p.prune(now=130.0) == 1 and p.size() == 0
    assert p.snapshot() == {"directory_size": 0.0, "holders": 0.0,
                            "sole_holders": 0.0, "routing_hits": 0.0}
    assert d.snapshot() == {"directory_size": 2.0, "holders": 2.0,
                            "sole_holders": 1.0, "routing_hits": 3.0}


# -- the tier's advertisement and protect ------------------------------------

def _tier(Tier, capacity_blocks=8, quant=False):
    t = Tier(n_layers=2, block_size=4, n_kv_heads=2, head_dim=4,
             dtype=np.int8 if quant else np.float32, capacity_bytes=0,
             async_copy=False, quant=quant)
    t.capacity_bytes = capacity_blocks * t.block_nbytes
    return t


def _blockdata(tier, n, seed=0):
    rng = np.random.default_rng(seed)
    shape = (tier.n_layers, n, tier.block_size, tier.n_kv_heads,
             tier.head_dim)
    if tier.quant:
        sc = (tier.n_layers, n, tier.n_kv_heads)
        return ((rng.standard_normal(shape) * 20).astype(np.int8),
                (rng.standard_normal(shape) * 20).astype(np.int8),
                rng.standard_normal(sc).astype(np.float32),
                rng.standard_normal(sc).astype(np.float32))
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _adv_oracle(t, chains):
    out = {}
    for hashes in chains:
        n = 0
        for h in hashes:
            if not t.has(h):
                break
            n += 1
        if n:
            out[hashes[0]] = n
    return out


def _adv_map(t):
    return {a["head"]: a["n"] for a in t.advertisement()}


@pytest.mark.parametrize("Tier", [HostKVTier, JTier], ids=["port", "jax"])
def test_advertisement_matches_walk_oracle_through_lifecycle(Tier):
    t = _tier(Tier, 8)
    a, b = [1, 2, 3, 4, 5], [10, 11, 12]
    t.store_batch(a, *_blockdata(t, 5), 5)
    t.store_batch(b, *_blockdata(t, 3, seed=1), 3)
    assert _adv_map(t) == _adv_oracle(t, [a, b]) == {1: 5, 10: 3}
    assert [x["head"] for x in t.advertisement()] == [10, 1]
    assert t.run_hashes(1) == a and t.run_hashes(10) == b
    assert t.run_hashes(999) == []
    t2 = _tier(Tier, 16)
    t2.store_batch(a, *_blockdata(t2, 5), 5)
    t2.store_batch([4, 5, 6, 7], *_blockdata(t2, 4, seed=2), 4)
    assert _adv_map(t2) == {1: 7}
    assert t2.run_hashes(1) == [1, 2, 3, 4, 5, 6, 7]
    t.get_run([1, 2])
    t.get_run(b)
    t.store_batch([20], *_blockdata(t, 1, seed=3), 1)   # evicts 3
    assert not t.has(3) and t.has(4) and t.has(5)
    assert _adv_map(t) == _adv_oracle(t, [a, b, [20]]) == \
        {1: 2, 10: 3, 20: 1}
    t3 = _tier(Tier, 4)
    t3.store_batch([1, 2], *_blockdata(t3, 2), 2)
    t3.store_batch([10, 11], *_blockdata(t3, 2, seed=1), 2)
    t3.store_batch([20], *_blockdata(t3, 1, seed=2), 1)  # evicts head 1
    assert not t3.has(1)
    assert _adv_map(t3) == _adv_oracle(t3, [[1, 2], [10, 11], [20]])
    assert 1 not in _adv_map(t3)


@pytest.mark.parametrize("Tier", [HostKVTier, JTier], ids=["port", "jax"])
def test_advertisement_bound_and_protect(Tier):
    t = _tier(Tier, 80)
    for i in range(70):
        t.store_batch([1000 + i], *_blockdata(t, 1, seed=i), 1)
    assert len(t.advertisement()) == 64
    assert len(t.advertisement(limit=5)) == 5
    assert t.advertisement()[0]["head"] == 1069
    t = _tier(Tier, 4)
    t.store_batch([1, 2], *_blockdata(t, 2), 2)
    t.store_batch([10, 11], *_blockdata(t, 2, seed=1), 2)
    assert t.protect([1], ttl_s=30.0) == 1
    t.store_batch([20, 21], *_blockdata(t, 2, seed=2), 2)
    assert t.has(1) and t.has(2) and not t.has(10) and not t.has(11)
    assert t.protect([1, 20], ttl_s=30.0) == 2
    t.store_batch([30], *_blockdata(t, 1, seed=3), 1)   # capacity wins
    assert t.snapshot()["entries"] == 4
    t2 = _tier(Tier, 2)
    t2.store_batch([1, 2], *_blockdata(t2, 2), 2)
    t2.protect([1], ttl_s=0.0)
    time.sleep(0.01)
    t2.store_batch([3], *_blockdata(t2, 1, seed=1), 1)
    assert not t2.has(1)
    assert t2.protect([], ttl_s=1.0) == 0


# -- the probe ---------------------------------------------------------------

def _holder(src_tier, dead=()):
    """A stand-in holder serving ``src_tier`` (``/kv/blocks`` and
    ``/kv/digests``); a URL under ``dead`` refuses to connect."""
    def transport(url, headers, max_bytes, deadline):
        parts = urllib.parse.urlsplit(url)
        if any(url.startswith(d) for d in dead):
            raise ConnectError("refused")
        q = urllib.parse.parse_qs(parts.query)
        if parts.path == "/kv/blocks":
            hashes = [int(h) for h in q["hashes"][0].split(",")]
            return 200, frames.encode_frames(src_tier.get_run(hashes))
        if parts.path == "/kv/digests":
            if "head" in q:
                head = int(q["head"][0])
                return 200, json.dumps({"head": head, "hashes":
                                        src_tier.run_hashes(head)}).encode()
            return 200, json.dumps(
                {"adverts": src_tier.advertisement()}).encode()
        return 404, b""
    return transport


def _jholder(src_tier, dead=()):
    """The same holder for the JAX client (an ``httpx.MockTransport``)."""
    httpx = pytest.importorskip("httpx")

    def handler(request):
        if any(str(request.url).startswith(d) for d in dead):
            raise httpx.ConnectError("refused")
        if request.url.path == "/kv/blocks":
            hashes = [int(h) for h in
                      request.url.params["hashes"].split(",")]
            return httpx.Response(
                200, content=jframes.encode_frames(src_tier.get_run(hashes)))
        if request.url.path == "/kv/digests":
            head = request.url.params.get("head")
            if head is not None:
                return httpx.Response(200, json={
                    "head": int(head),
                    "hashes": src_tier.run_hashes(int(head))})
            return httpx.Response(200, json={
                "adverts": src_tier.advertisement()})
        return httpx.Response(404)
    return httpx.MockTransport(handler)


def _probes(src_blocks, evict=False, dead=(), peers=()):
    """One scenario on both packages: ``(port probe, jax probe, dst
    tiers)`` with the holder's tier built alike on each side."""
    out = []
    for Tier, Client, Stats, mod, holder in (
            (HostKVTier, KvNetClient, KvNetStats, tdir, _holder),
            (JTier, JKvNetClient, JKvNetStats, jdir, _jholder)):
        src, dst = _tier(Tier, 4 if evict else 8), _tier(Tier, 8)
        src.store_batch(src_blocks, *_blockdata(src, len(src_blocks)),
                        len(src_blocks))
        if evict:
            src.store_batch([50, 51, 52, 53], *_blockdata(src, 4, seed=1), 4)
        client = Client(dst, Stats(), transport=holder(src, dead),
                        connect_retries=0)
        out.append((mod.FabricProbe(dst, peers=list(peers), client=client,
                                    ttl_s=30.0), dst))
    return out


def test_probe_pulls_run_and_counts_remote_hit():
    for fab, dst in _probes([1, 2, 3]):
        assert fab.probe([1, 2, 3], ["http://holder"], budget_s=5.0) == 3
        assert dst.has(1) and dst.has(2) and dst.has(3)
        assert fab.probe([], ["http://holder"], 5.0) == 0
        assert fab.probe([1], [], 5.0) == 0
        assert fab.probe([1], ["http://holder"], 0.0) == 0
        assert fab.stats.snapshot() == {
            "probes": 1.0, "remote_hits": 1.0, "remote_misses": 0.0,
            "replications": 0.0, "stale_holders": 0.0,
            "directory_size": 0.0}


def test_probe_stale_holder_vs_unreachable_holder():
    snaps = []
    for fab, dst in _probes([1, 2], evict=True, dead=("http://gone",)):
        assert fab.probe([1, 2], ["http://holder"], budget_s=5.0) == 0
        assert fab.probe([1, 2], ["http://gone"], budget_s=5.0) == 0
        # three holders at most, one shared budget
        assert fab.probe([1, 2], ["http://gone"] * 5, budget_s=5.0) == 0
        snaps.append((fab.stats.snapshot(), fab.client.stats.snapshot()))
    (port, pnet), (ref, jnet) = snaps
    assert port == ref
    assert port["remote_misses"] == 3 and port["stale_holders"] == 1
    # three holders at most per probe, and the third connect failure opens
    # the dead holder's breaker: the last attempt never reaches the
    # transport (a fallback, not an error)
    assert pnet == jnet and pnet["errors"] == 3 and pnet["fallbacks"] == 4


def test_probe_static_peers_directory_refresh():
    for fab, dst in _probes([1, 2, 3], peers=["http://holder"]):
        assert fab.holders_for(1) == ["http://holder"]
        assert fab.stats.snapshot()["directory_size"] == 1
        assert fab.probe([1, 2, 3], fab.holders_for(1), budget_s=5.0) == 3
        assert fab.holders_for(999) == []
    fab, _ = _probes([1])[0]
    assert fab.holders_for(1) == []           # no peers, no directory


def test_kvfabric_families_export_where_armed():
    tele = StepTelemetry(total_blocks=8)
    tele.kvfabric = tdir.KvFabricStats()
    tele.kvfabric.count("probes")
    tele.kvfabric.count("remote_hits")
    tele.kvfabric.count("stale_holders", 2)
    tele.kvfabric.set_directory_size(5)
    out = Exposition()
    engine_families(out, tele, "t")
    fams = {f.name: f for f in text_string_to_metric_families(out.text())}
    for fam in tdir.METRIC_FAMILIES:
        assert fams[fam[:-len("_total")]].type == "counter", fam
    assert fams["shai_kvfabric_stale_holders"].samples[0].value == 2.0
    assert fams["shai_kvfabric_directory_size"].samples[0].value == 5.0
    bare = Exposition()
    engine_families(bare, StepTelemetry(total_blocks=8), "t")
    assert "shai_kvfabric" not in bare.text()
    assert tdir.METRIC_FAMILIES == jdir.METRIC_FAMILIES


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


def _env(monkeypatch, tier=True, quant=False, async_decode=True,
         fabric=False):
    monkeypatch.setenv("SHAI_KVTIER", "1" if tier else "0")
    monkeypatch.setenv("SHAI_KVTIER_ASYNC", "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8" if quant else "")
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "0")
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_decode else "0")
    monkeypatch.setenv("SHAI_KVFABRIC", "1" if fabric else "0")
    monkeypatch.delenv("SHAI_KVFABRIC_PEERS", raising=False)
    monkeypatch.delenv("SHAI_ROLE", raising=False)


def _port(tiny, monkeypatch, role="both", tier=True, quant=False,
          async_decode=True, fabric=False):
    _, _, tcfg, model = tiny
    _env(monkeypatch, tier, quant, async_decode, fabric)
    return LLMEngine(tcfg, model, tconfig.EngineConfig(
        **dict(ENGINE_KW, role=role)), device="cpu")


def _jax(tiny, monkeypatch, role="both", tier=True, quant=False):
    jcfg, params, _, _ = tiny
    _env(monkeypatch, tier, quant)
    return JEngine(jcfg, params, jconfig.EngineConfig(
        **dict(ENGINE_KW, role=role)))


def _prompt(seed, length=40):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(2, 500, length)]


def _run(eng, prompt, n, lp=0, **kw):
    P = JParams if isinstance(eng, JEngine) else SamplingParams
    rid = eng.add_request(list(prompt), P(temperature=0.0, max_new_tokens=n,
                                          logprobs=lp), **kw)
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    eng.finish_pending()
    return done[rid]


def _assert_pool_exact(eng):
    cache = eng.cache
    assert cache.active == []
    used = (cache.total_blocks - 1) - cache.allocator.n_free
    assert used == len(cache._block2hash) and cache.leaked_blocks == 0
    if cache.tier is not None:
        snap = cache.tier.snapshot()
        assert snap["used_bytes"] == snap["entries"] * snap["block_nbytes"]


def _arm(eng, src_tier, dead=()):
    """Attach a probe whose client reaches ``src_tier`` through the
    stand-in holder (the engine's own kvnet stats, as construction
    wires)."""
    client = KvNetClient(eng.cache.tier, eng.obs.kvnet,
                         transport=_holder(src_tier, dead),
                         connect_retries=0)
    fab = tdir.FabricProbe(eng.cache.tier, peers=[], client=client)
    eng._kvfabric = fab
    eng.obs.kvfabric = fab.stats
    return fab


_JAX_ORACLES = {}


def _jax_oracle(tiny, monkeypatch, prompt, n=8):
    """The JAX engine's greedy run (tier off, logprobs 2), once per
    prompt in this module."""
    key = (tuple(prompt), n)
    if key not in _JAX_ORACLES:
        _JAX_ORACLES[key] = _run(_jax(tiny, monkeypatch, tier=False), prompt,
                                 n, lp=2)
    return _JAX_ORACLES[key]


#: (holder package, quant, async)
FABRIC_MODES = {"async": ("port", False, True),
                "lockstep": ("port", False, False),
                "int8": ("port", True, True),
                "jax-holder": ("jax", False, True)}


@pytest.mark.parametrize("mode", list(FABRIC_MODES))
def test_fabric_probe_equals_fabric_off(tiny, monkeypatch, mode):
    pkg, quant, ad = FABRIC_MODES[mode]
    prompt = _prompt(5)
    make = _port if pkg == "port" else _jax
    holder = make(tiny, monkeypatch, role="prefill", quant=quant)
    _run(holder, prompt, 1)
    hashes = holder.cache.prefix_hashes(prompt)
    assert holder.cache.tier.n_entries == len(hashes) == 5
    plain = _port(tiny, monkeypatch, tier=False, quant=quant,
                  async_decode=ad)
    fabric = _port(tiny, monkeypatch, quant=quant, async_decode=ad)
    fab = _arm(fabric, holder.cache.tier)
    got = _run(fabric, prompt, 8, kv_holders=["http://holder"])
    want = _run(plain, prompt, 8, lp=2)
    assert got.token_ids == want.token_ids
    snap = fab.stats.snapshot()
    assert snap["probes"] == 1 and snap["remote_hits"] == 1
    assert fabric.cache.tier.snapshot()["restored"] > 0
    assert fabric.obs.kvnet.snapshot()["errors"] == 0
    timing = got.timing
    assert timing["fabric_blocks"] == 5.0 and timing["fabric_probe_s"] >= 0
    if not quant:
        assert_greedy_parity([got], [_jax_oracle(tiny, monkeypatch, prompt)],
                             label=mode)
    _assert_pool_exact(fabric)
    _assert_pool_exact(holder)


def test_fabric_off_is_a_strict_noop(tiny, monkeypatch):
    """Fabric off (the default): no probe, no kvfabric telemetry, and a
    holder hint on the request changes nothing the engine counts."""
    prompt = _prompt(9)
    runs = []
    for hint in (None, ["http://nowhere"]):
        eng = _port(tiny, monkeypatch)
        assert eng._kvfabric is None and eng.obs.kvfabric is None
        fin = _run(eng, prompt, 8, kv_holders=hint)
        snap = eng.obs.snapshot()
        runs.append((fin.token_ids, fin.stop_reason,
                     {k: v for k, v in snap.items()
                      if not isinstance(v, float) or k.endswith("_total")
                      or k in ("steps", "pipeline_flushes")},
                     eng.obs.flush_reasons(), eng.n_executables,
                     eng.cache.tier.snapshot(), eng.obs.kvnet.snapshot(),
                     "fabric_probe_s" in fin.timing))
        _assert_pool_exact(eng)
    assert runs[0] == runs[1]
    assert runs[0][-1] is False
    assert runs[0][0] == _run(_port(tiny, monkeypatch, tier=False), prompt,
                              8).token_ids


def test_fabric_armed_by_env_builds_the_probe(tiny, monkeypatch):
    eng = _port(tiny, monkeypatch, fabric=True)
    assert eng._kvfabric is not None
    assert eng.obs.kvfabric is eng._kvfabric.stats
    assert eng._kvfabric.client.stats is eng.obs.kvnet
    monkeypatch.setenv("SHAI_KVFABRIC", "0")
    monkeypatch.setenv("SHAI_KVFABRIC_PEERS", "http://a:1,http://b:2/")
    _, _, tcfg, model = tiny
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                    device="cpu")
    assert eng._kvfabric.peers == ["http://a:1", "http://b:2"]
    # no tier: nothing to publish into, so no probe even when armed
    assert _port(tiny, monkeypatch, tier=False,
                 fabric=True)._kvfabric is None


def test_fabric_probe_priced_out_by_deadline(tiny, monkeypatch):
    class _Rate:
        projected_per_s = 0.001          # the savings: blocks x bs / rate

        @staticmethod
        def record_step(**kw):
            return False

    prompt = _prompt(12)
    holder = _port(tiny, monkeypatch, role="prefill")
    _run(holder, prompt, 1)
    fabric = _port(tiny, monkeypatch)
    fab = _arm(fabric, holder.cache.tier)
    fabric.obs.sentinel = _Rate()
    fin = _run(fabric, prompt, 4, deadline_at=time.monotonic() + 30.0,
               kv_holders=["http://holder"])
    assert fin.stop_reason in ("length", "eos")
    assert fab.stats.snapshot()["probes"] == 0
    assert fabric.cache.tier.snapshot()["restored"] == 0
    _assert_pool_exact(fabric)


def test_probe_fault_recomputes_opens_the_breaker_and_recovers(
        tiny, monkeypatch):
    prompts = [_prompt(20 + i) for i in range(4)]
    holder = _port(tiny, monkeypatch, role="prefill")
    plain = _port(tiny, monkeypatch, tier=False)
    fabric = _port(tiny, monkeypatch)
    for p in prompts:
        _run(holder, p, 1)
    fab = _arm(fabric, holder.cache.tier)
    rz_faults.configure("kvfabric.probe=error", 0)
    try:
        for p in prompts:
            assert _run(fabric, p, 6, kv_holders=["http://holder"]
                        ).token_ids == _run(plain, p, 6).token_ids
    finally:
        rz_faults.reset()
    snap = fab.stats.snapshot()
    assert snap["probes"] == 4 and snap["remote_hits"] == 0
    assert snap["remote_misses"] == 4 and snap["stale_holders"] == 0
    assert fab.client.stats.snapshot()["errors"] >= 4
    br = fab.client.breaker_of("http://holder")
    assert br.state != "closed"
    assert fabric.cache.tier.snapshot()["restored"] == 0
    _assert_pool_exact(fabric)
    # the fault lifted and the open interval over: the half-open probe
    # lands and the rung recovers on its own
    time.sleep(min(br.retry_after_s + 0.05, 10.0))
    p = _prompt(99)
    _run(holder, p, 1)
    assert _run(fabric, p, 6, kv_holders=["http://holder"]).token_ids == \
        _run(plain, p, 6).token_ids
    assert fab.stats.snapshot()["remote_hits"] == 1
    assert br.state == "closed"


# -- pods over sockets -------------------------------------------------------

POD_CONFIG = {"model": "tiny", "max_model_len": 256, "block_size": 16,
              "context_encoding_buckets": [32, 64, 128],
              "max_new_tokens": 16, "enable_prefix_caching": True}


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """A prefill pod (the holder) and a pod whose fabric names it
    (``SHAI_KVFABRIC_PEERS``), one process, loopback (the holder could be
    either package's: the engine cases above pull from a JAX tier too)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SHAI_KVTIER", "1")
    mp.setenv("SHAI_KVTIER_ASYNC", "1")
    for k in ("SHAI_ROLE", "SHAI_KVFABRIC", "SHAI_KVFABRIC_PEERS",
              "SHAI_MIGRATE_PEER_URL"):
        mp.delenv(k, raising=False)
    tmp = tmp_path_factory.mktemp("fabric")
    servers, services = [], []
    try:
        hconf = tmp / "holder.yaml"
        hconf.write_text(json.dumps({**POD_CONFIG, "role": "prefill"}))
        cfg, hservice = _port_service(tmp, vllm_config=str(hconf),
                                      max_new_tokens=16)
        services.append(hservice)
        hsrv = Server(create_app(cfg, hservice), host="127.0.0.1", port=0)
        h, p = hsrv.start_background()
        servers.append(hsrv)
        holder = f"http://{h}:{p}"
        _wait_ready(holder)
        mp.setenv("SHAI_KVFABRIC_PEERS", holder)
        # the pod-local directory refreshes from the holder's /kv/digests
        # at most every 0.5 s (15 s by default): the holder banks each
        # case's run after the port pod's warmup refreshed it
        mp.setenv("SHAI_KVFABRIC_TTL_S", "0.5")
        conf = tmp / "port.yaml"
        conf.write_text(json.dumps(POD_CONFIG))
        cfg, service = _port_service(tmp, vllm_config=str(conf),
                                     max_new_tokens=16)
        services.append(service)
        srv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
        h, p = srv.start_background()
        servers.append(srv)
        port = f"http://{h}:{p}"
        _wait_ready(port)
        yield holder, port, service
    finally:
        for s in servers:
            s.stop()
        for svc in services:
            svc.close()
        mp.undo()


def _plain_tokens(service, prompt, n, monkeypatch):
    """The fabric-off oracle: a tier-less engine on the pod's own model
    and engine config."""
    eng = service._engine
    _env(monkeypatch, tier=False)
    ref = LLMEngine(eng.cfg, eng.model, eng.ecfg, device="cpu")
    return _run(ref, service._encode(prompt), n, lp=2)


def test_pod_warms_from_a_holder_pod_over_sockets(pods, monkeypatch):
    holder, port, service = pods
    prompt = "a prefix computed once, warm everywhere: " + \
        "the quick brown fox jumps over the lazy dog " * 2
    status, handoff = _http(holder + "/generate", {"prompt": prompt,
                                                   "temperature": 0.0})
    assert status == 200 and handoff["kv_ready"] is True
    before = _http(port + "/stats")[1]["kvfabric"]
    time.sleep(0.6)      # past the directory's TTL
    status, out = _http(port + "/generate", {
        "prompt": prompt, "temperature": 0.0, "max_new_tokens": 12,
        "logprobs": 2})
    assert status == 200, out
    status, st = _http(port + "/stats")
    assert st["kvfabric"]["probes"] == before["probes"] + 1
    assert st["kvfabric"]["remote_hits"] == before["remote_hits"] + 1
    assert st["kvfabric"]["directory_size"] >= 2
    assert st["kvtier"]["restored"] >= handoff["hashes_len"]
    want = _plain_tokens(service, prompt, 12, monkeypatch)
    got = [e["token"] for e in out["logprobs"]]
    if got != want.token_ids:
        F = dataclasses.make_dataclass("F", ["token_ids", "logprobs"])
        assert_greedy_parity([F(got, out["logprobs"])], [want],
                             label="holder pod -> fabric pod")
    # the served prompt's affinity digest maps to its chain head
    heads = st["kvtier"]["aff_heads"]
    ids = service._encode(prompt)
    assert heads[prompt_affinity(prompt)] == \
        service._engine.cache.prefix_hashes(ids)[0]
    status, text = _http(port + "/metrics", raw=True)
    fams = {f.name for f in text_string_to_metric_families(text)}
    assert {f[:-len("_total")] for f in tdir.METRIC_FAMILIES} <= fams
    assert service._engine.cache.leaked_blocks == 0


def test_port_pod_stale_holder_fault_pull_and_protect(pods, monkeypatch):
    holder, port, service = pods
    prompt = "nobody holds this one yet: " + "lorem ipsum dolor sit " * 4
    # a holder slice naming a pod without the run: a stale miss, the same
    # tokens as recomputing
    status, out = _http(port + "/generate", {
        "prompt": prompt, "temperature": 0.0, "max_new_tokens": 8,
        "logprobs": 2, "kv_holders": [holder]})
    assert status == 200
    st = _http(port + "/stats")[1]["kvfabric"]
    assert st["stale_holders"] >= 1 and st["remote_misses"] >= 1
    want = _plain_tokens(service, prompt, 8, monkeypatch)
    assert [e["token"] for e in out["logprobs"]] == want.token_ids
    # an injected probe fault: recompute, still 200
    prompt2 = "the probe faults on this one: " + "sed do eiusmod " * 4
    assert _http(holder + "/generate", {"prompt": prompt2,
                                        "temperature": 0.0})[0] == 200
    before = _http(port + "/stats")[1]["kvfabric"]
    rz_faults.configure("kvfabric.probe=error", 0)
    try:
        status, out = _http(port + "/generate", {
            "prompt": prompt2, "temperature": 0.0, "max_new_tokens": 8,
            "logprobs": 2, "kv_holders": [holder]})
    finally:
        rz_faults.reset()
    assert status == 200
    after = _http(port + "/stats")[1]["kvfabric"]
    assert after["remote_misses"] == before["remote_misses"] + 1
    assert after["remote_hits"] == before["remote_hits"]
    assert [e["token"] for e in out["logprobs"]] == \
        _plain_tokens(service, prompt2, 8, monkeypatch).token_ids
    # /kv/pull: replicate the holder's newest run; /kv/protect on both
    adv = _http(holder + "/kv/digests")[1]["adverts"][0]
    status, pulled = _http(port + "/kv/pull", {"source": holder,
                                               "head": adv["head"]})
    assert status == 200 and pulled["fetched"] == adv["n"]
    assert _http(port + "/stats")[1]["kvfabric"]["replications"] == 1
    assert _http(port + "/kv/pull", {"source": holder})[0] == 400
    assert _http(holder + "/kv/pull", {"source": port, "head": 1})[0] == 404
    for base in (holder, port):
        status, prot = _http(base + "/kv/protect", {"heads": [adv["head"]],
                                                    "ttl_s": 5})
        assert status == 200 and prot == {"protected": 1}
        assert _http(base + "/kv/protect", {"heads": ["x"]})[0] == 400
    assert service._engine.cache.leaked_blocks == 0
