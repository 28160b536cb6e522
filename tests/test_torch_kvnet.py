"""The port's network KV transport (``kvnet/``) against the JAX package's,
on the CPU.

Port of ``tests/test_kvnet.py`` (its pod-side cases; the fleet router's
stay with the fleet control plane). The wire changes where KV bytes come
from, never what is generated. What is held:

- frames (``kvnet/frames.py``): a stream the port encodes is byte for
  byte the stream the JAX package encodes for the same entries (bf16
  blocks, f32 blocks, the int8 four-tuple with its f32 scale rows), each
  package decodes the other's byte-exact, a bf16 frame decodes into the
  port's 16-bit words under the wire name ``bfloat16`` in an interpreter
  where ``ml_dtypes`` cannot be imported, every proper cut of a stream is
  refused (a cut at a frame boundary is a shorter run) and flipped bits
  are caught;
- the client (``kvnet/client.py``) against a stand-in peer and a real
  localhost server: the leading run published byte-exact (the int8
  four-tuple too), connect failures counted into the breaker, a retry
  that recovers resetting it, dtype drift refused by WIRE name (int16
  words are not bf16 ones), corrupt, confused and mis-shaped frames and
  non-200 answers degraded, the budget and the peer allowlist, fetched
  blocks resident on an async tier without a worker, a response over the
  size cap cut off while it streams, the transport probe leaving the
  admission hit rate alone, the ``kvnet.fetch`` fault site;
- roles: ``SHAI_ROLE`` wins and a bad value is tolerated, the engine takes
  the roles, the chain hashes are stable across interpreter hash seeds;
- the handoff: a prefill engine banks the prompt's run, the run crosses
  the codec into a decode engine's tier, and the decode engine's greedy
  tokens equal a monolithic engine's (async and lock-step; an int8 pool
  byte-exact on both tiers); a JAX prefill engine's run decoded by a port
  engine and a port prefill engine's by a JAX engine give the monolithic
  port run's tokens, or part at a bf16 tie (``tests/parity.py``); a
  failed fetch recomputes; pools exact on every engine;
- over sockets: a JAX pod (``role: prefill``) and a port pod (``role:
  decode``), and the reverse: the handoff's ``kv_ready``, ``hashes_len``
  and ``digest``, the decode pod pulling over ``GET /kv/blocks``, greedy
  text equal to a monolithic port pod's (or parting at a bf16 tie), the
  ``shai_kvnet_*`` families and the ``/stats`` sections; a prefill pod's
  OpenAI route answers 400.
"""

import dataclasses
import http.server
import json
import os
import subprocess
import sys
import threading
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
from scalable_hw_agnostic_inference_tpu.kvnet import frames as jframes
from scalable_hw_agnostic_inference_tpu.kvtier.pool import (
    HostKVTier as JTier,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.serve.app import (
    create_app as jcreate_app,
)
from scalable_hw_agnostic_inference_tpu.serve.httpd import Server as JServer
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import PagedKVCache
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.kvnet import frames, resolve_role
from scalable_hw_agnostic_inference_tpu_torch.kvnet.client import (
    MAX_PEER_BREAKERS,
    ConnectError,
    KvNetClient,
    KvNetStats,
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
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
BF16 = jnp.bfloat16.dtype   # ml_dtypes' bfloat16, the JAX side's
# the oracle's engine shapes (tests/test_kvnet.py)
ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16,
                 enable_prefix_caching=True)


# -- frames ------------------------------------------------------------------------

def _entries(seed, kind, n=3):
    """The same logical entries for both packages: ``(port, jax)`` lists
    of ``(hash, *arrays)``. bf16 blocks are one set of 16-bit words, seen
    as ``frames.BF16`` by the port and as ml_dtypes' bfloat16 by JAX."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for _ in range(n):
        h = int(rng.integers(-2**62, 2**62))
        L, bs, hk, dh = (int(rng.integers(1, 4)) for _ in range(4))
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
        else:   # the int8 four-tuple
            arrs = [rng.integers(-127, 128, shp).astype(np.int8)
                    for _ in range(2)]
            arrs += [rng.random((L, hk)).astype(np.float32)
                     for _ in range(2)]
            port.append((h, *arrs))
            ref.append((h, *arrs))
    return port, ref


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_frames_byte_identical_between_packages(kind):
    for seed in range(4):
        port, ref = _entries(seed, kind)
        stream = frames.encode_frames(port)
        assert stream == jframes.encode_frames(ref)
        for got, want in ((jframes.decode_frames(stream), ref),
                          (frames.decode_frames(stream), port)):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g[0] == w[0] and len(g) == len(w)
                for a, b in zip(g[1:], w[1:]):
                    assert a.shape == b.shape
                    assert frames.wire_name(a.dtype) == \
                        frames.wire_name(b.dtype)
                    assert a.tobytes() == b.tobytes()


def test_bf16_frame_decodes_without_ml_dtypes(tmp_path):
    port, ref = _entries(5, "bf16", n=2)
    path = tmp_path / "frames.bin"
    path.write_bytes(jframes.encode_frames(ref))
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"   # every import of it fails
        "sys.path.insert(0, {repo!r})\n"
        "from scalable_hw_agnostic_inference_tpu_torch.kvnet import frames\n"
        "try:\n"
        "    import ml_dtypes\n"
        "    raise SystemExit('ml_dtypes importable')\n"
        "except ImportError:\n"
        "    pass\n"
        "out = frames.decode_frames(open({path!r}, 'rb').read())\n"
        "print(repr([(e[0], [(frames.wire_name(a.dtype), a.shape,\n"
        "              a.tobytes().hex()) for a in e[1:]]) for e in out]))\n"
    ).format(repo=str(REPO), path=str(path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    got = eval(r.stdout.strip())
    assert got == [(e[0], [("bfloat16", a.shape, a.tobytes().hex())
                           for a in e[1:]]) for e in ref]


def test_frame_truncation_rejected_at_every_cut():
    port, _ = _entries(3, "f32", n=2)
    frame1 = frames.encode_frames(port[:1])
    data = frame1 + frames.encode_frames(port[1:])
    assert frames.decode_frames(b"") == []
    for cut in range(1, len(data)):
        if cut == len(frame1):
            out = frames.decode_frames(data[:cut])
            assert len(out) == 1 and out[0][0] == port[0][0]
            continue
        with pytest.raises(frames.FrameError):
            frames.decode_frames(data[:cut])


def test_frame_corruption_rejected():
    rng = np.random.default_rng(4)
    port, _ = _entries(4, "int8", n=1)
    data = bytearray(frames.encode_frames(port))
    for pos in rng.integers(0, len(data), 24):
        mutated = bytearray(data)
        mutated[pos] ^= 0x41
        with pytest.raises(frames.FrameError):
            frames.decode_frames(bytes(mutated))
    with pytest.raises(frames.FrameError):
        frames.decode_frames(b"garbage that is not a frame stream")


# -- the host pool's recency, roles, hashes ----------------------------------------

def _tier(capacity_blocks=4, quant=False, async_copy=False, dtype=None):
    t = HostKVTier(n_layers=2, block_size=4, n_kv_heads=2, head_dim=4,
                   dtype=dtype or (np.int8 if quant else np.float32),
                   capacity_bytes=0, async_copy=async_copy, quant=quant)
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
    return (rng.standard_normal(shape).astype(tier.dtype),
            rng.standard_normal(shape).astype(tier.dtype))


def test_get_run_refreshes_recency_like_probe():
    for touch in ("get_run", "probe_run"):
        t = _tier(4)
        t.store_batch([1, 2, 3, 4], *_blockdata(t, 4), 4)
        getattr(t, touch)([1, 2])
        t.store_batch([5, 6], *_blockdata(t, 2, seed=1), 2)
        assert t.has(1) and t.has(2) and not t.has(3) and not t.has(4)


def test_resolve_role_env_wins_and_is_lenient(monkeypatch):
    monkeypatch.delenv("SHAI_ROLE", raising=False)
    assert resolve_role("prefill") == "prefill"
    assert resolve_role() == "both"
    monkeypatch.setenv("SHAI_ROLE", "decode")
    assert resolve_role("prefill") == "decode"
    monkeypatch.setenv("SHAI_ROLE", "prefil")
    assert resolve_role("prefill") == "prefill"
    assert resolve_role("bogus") == "both"
    tconfig.EngineConfig(role="prefill")
    with pytest.raises(ValueError):
        tconfig.EngineConfig(role="prefetch")


def test_chain_hashes_stable_across_interpreter_hash_seeds():
    tokens = list(range(100, 164))
    local = PagedKVCache._chain_hashes(tokens, 16)
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "from scalable_hw_agnostic_inference_tpu_torch.engine.cache "
            "import PagedKVCache\n"
            "print(PagedKVCache._chain_hashes(list(range(100, 164)), 16))\n"
            ).format(root=str(REPO))
    for seed in ("0", "12345"):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120,
                           env={**os.environ, "PYTHONHASHSEED": seed})
        assert r.returncode == 0, r.stderr
        assert eval(r.stdout.strip()) == local


# -- the client --------------------------------------------------------------------

def _client(src_tier, dst_tier, stats=None, handler=None, connect_retries=0,
            **kw):
    """A client whose transport is a stand-in peer serving ``src_tier``'s
    leading runs (``handler(url)`` replaces it: ``(status, body)`` or a
    raised ``ConnectError``)."""
    def serve(url):
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(url).query)
        hashes = [int(h) for h in q["hashes"][0].split(",")]
        return 200, frames.encode_frames(src_tier.get_run(hashes))

    def transport(url, headers, max_bytes, deadline):
        return (handler or serve)(url)

    return KvNetClient(dst_tier, stats or KvNetStats(), transport=transport,
                       connect_retries=connect_retries, **kw)


def _assert_bytes_equal(src, dst, hashes):
    for (h, *want), (h2, *got) in zip(src.get_run(hashes),
                                      dst.get_run(hashes)):
        assert h == h2 and len(got) == len(want)
        for a, b in zip(want, got):
            assert a.tobytes() == b.tobytes()


def test_client_fetch_publishes_leading_run():
    src, dst = _tier(8), _tier(8)
    src.store_batch([1, 2, 3], *_blockdata(src, 3), 3)
    c = _client(src, dst)
    assert c.fetch_run("http://peer", [1, 2, 3, 4]) == 3
    assert dst.has(1) and dst.has(3) and not dst.has(4)
    snap = c.stats.snapshot()
    assert snap["fetched"] == 3 and snap["bytes"] > 0
    assert snap["errors"] == 0 and snap["fallbacks"] == 0
    _assert_bytes_equal(src, dst, [1, 2, 3])
    assert c.fetch_run("http://peer", [1, 2, 3]) == 3   # resident: no GET
    assert c.stats.snapshot()["fetched"] == 3


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_client_fetch_quant_and_bf16_byte_exact(dtype):
    quant = dtype == "int8"
    src, dst = (_tier(8, quant=quant, dtype=dtype) for _ in range(2))
    if quant:
        data = _blockdata(src, 2)
    else:
        rng = np.random.default_rng(0)
        data = [rng.integers(-2**15, 2**15, (2, 2, 4, 2, 4)).astype(np.int16)
                for _ in range(2)]
    src.store_batch([11, 12], *data, 2)
    c = _client(src, dst)
    assert c.fetch_run("http://peer", [11, 12]) == 2
    _assert_bytes_equal(src, dst, [11, 12])
    [(_, k, *_)] = dst.get_run([11])
    assert frames.wire_name(k.dtype) == dtype


def test_client_connect_error_degrades_and_breaker_opens():
    def dead(url):
        raise ConnectError("refused")

    stats = KvNetStats()
    c = _client(_tier(4), _tier(4), stats=stats, handler=dead)
    for _ in range(4):
        assert c.fetch_run("http://peer", [1, 2]) == 0
    snap = stats.snapshot()
    assert snap["fallbacks"] >= 4 and snap["errors"] >= 3
    assert c.breaker_of("http://peer").state != "closed"
    errs = snap["errors"]
    assert c.fetch_run("http://peer", [1, 2]) == 0
    assert stats.snapshot()["errors"] == errs   # fail-fast: no attempt


def test_client_recovered_retry_does_not_accumulate_breaker_failures():
    src = _tier(8)
    src.store_batch([1, 2], *_blockdata(src, 2), 2)
    state = {"calls": 0}

    def flaky(url):
        state["calls"] += 1
        if state["calls"] % 2 == 1:
            raise ConnectError("blip")
        return 200, frames.encode_frames(src.get_run([1, 2]))

    for _ in range(4):
        c = _client(src, _tier(8), handler=flaky, connect_retries=1)
        assert c.fetch_run("http://peer", [1, 2]) == 2
        assert c.breaker_of("http://peer").state == "closed"


def test_client_rejects_dtype_drift_by_wire_name():
    """A peer whose blocks are int16 words is not a bf16 peer, though the
    bf16 tier stores int16 words too; and a float64 peer is not a float32
    one: the drift check compares wire names."""
    for src_dt, dst_dt in (("int16", "bfloat16"), ("float64", "float32")):
        src, dst = _tier(8, dtype=src_dt), _tier(8, dtype=dst_dt)
        src.store_batch([1], *_blockdata(src, 1), 1)
        c = _client(src, dst)
        assert c.fetch_run("http://peer", [1]) == 0
        assert not dst.has(1) and c.stats.snapshot()["fallbacks"] == 1


def test_client_rejects_corrupt_and_mismatched_frames():
    src, dst = _tier(8), _tier(8)
    src.store_batch([1, 2], *_blockdata(src, 2), 2)
    c = _client(src, dst, handler=lambda url: (200, b"not frames at all"))
    assert c.fetch_run("http://peer", [1, 2]) == 0
    assert c.stats.snapshot()["fallbacks"] == 1
    c2 = _client(src, dst, handler=lambda url: (
        200, frames.encode_frames(src.get_run([2]))))   # confused peer
    assert c2.fetch_run("http://peer", [1, 2]) == 0 and not dst.has(2)
    big = HostKVTier(n_layers=2, block_size=8, n_kv_heads=2, head_dim=4,
                     dtype=np.float32, capacity_bytes=1 << 20,
                     async_copy=False)
    big.store_batch([1], *_blockdata(big, 1), 1)
    assert _client(big, dst).fetch_run("http://peer", [1]) == 0
    assert not dst.has(1)
    c4 = _client(src, dst, handler=lambda url: (404, b""))
    assert c4.fetch_run("http://peer", [1]) == 0
    assert c4.stats.snapshot()["fallbacks"] == 1


def test_client_budget_and_peer_validation():
    src, dst = _tier(8), _tier(8)
    src.store_batch([1, 2], *_blockdata(src, 2), 2)
    c = _client(src, dst)
    assert c.fetch_run("http://peer", [1, 2], budget_s=0.0) == 0
    assert c.stats.snapshot()["fallbacks"] == 1 and not dst.has(1)
    assert c.fetch_run("ftp://169.254.169.254/x", [1, 2]) == 0
    assert c.stats.snapshot()["fallbacks"] == 2
    c2 = _client(src, dst)
    c2.allowed_peers = ("http://trusted",)
    assert c2.fetch_run("http://attacker", [1, 2]) == 0
    assert c2.fetch_run("http://trusted:8000", [1, 2]) == 2
    c3 = _client(src, dst)
    for i in range(MAX_PEER_BREAKERS + 40):
        c3.breaker_of(f"http://p{i}")
    assert len(c3._breakers) <= MAX_PEER_BREAKERS
    c.allowed_peers = ("http://kv.internal",)
    assert c.peer_allowed("http://kv.internal:8000")
    assert c.peer_allowed("http://kv.internal/kv/blocks")
    assert not c.peer_allowed("http://kv.internal.evil.com")
    assert not c.peer_allowed("http://kv.internal@evil.com")
    assert not c.peer_allowed("https://kv.internal")
    c.allowed_peers = ()
    assert c.peer_allowed("http://anything")
    assert not c.peer_allowed("http://user@anything")


def test_client_publish_is_synchronous_on_async_tiers():
    src = _tier(8)
    src.store_batch([1, 2, 3], *_blockdata(src, 3), 3)
    dst = _tier(8, async_copy=True)
    assert _client(src, dst).fetch_run("http://peer", [1, 2, 3]) == 3
    assert dst.has(1) and dst.has(3) and dst._worker is None


class _Peer(http.server.ThreadingHTTPServer):
    """A localhost HTTP peer for the client's own transport: ``/kv/blocks``
    from a tier, or ``/huge`` streaming 2 MiB of zeros."""

    def __init__(self, tier):
        self.tier = tier
        tier_ = tier

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                url = urllib.parse.urlsplit(self.path)
                if url.path == "/huge/kv/blocks":
                    body = b"\0" * (2 << 20)
                elif url.path == "/kv/blocks":
                    q = urllib.parse.parse_qs(url.query)
                    body = frames.encode_frames(tier_.get_run(
                        [int(h) for h in q["hashes"][0].split(",")]))
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        super().__init__(("127.0.0.1", 0), H)
        threading.Thread(target=self.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server_address[1]}"


def test_client_http_transport_pulls_and_caps_responses():
    src, dst = _tier(8), _tier(8)
    src.store_batch([1, 2], *_blockdata(src, 2), 2)
    peer = _Peer(src)
    try:
        c = KvNetClient(dst, KvNetStats(), connect_retries=0)
        assert c.fetch_run(peer.url, [1, 2]) == 2
        _assert_bytes_equal(src, dst, [1, 2])
        # a body past len(chunk) * block_nbytes * 2 + 64 KiB is cut off
        # while it streams: an error and a fallback, nothing published
        dst2 = _tier(8)
        c2 = KvNetClient(dst2, KvNetStats(), connect_retries=0)
        assert c2.fetch_run(peer.url + "/huge", [1, 2]) == 0
        snap = c2.stats.snapshot()
        assert snap["fallbacks"] == 1 and snap["errors"] == 1
        assert dst2.n_entries == 0
    finally:
        peer.shutdown()
        peer.server_close()
    # a peer that is gone: connect-phase, counted into its breaker
    c3 = KvNetClient(_tier(8), KvNetStats(), connect_retries=0,
                     connect_timeout_s=2.0)
    assert c3.fetch_run(peer.url, [1]) == 0
    assert c3.breaker_of(peer.url)._consecutive_failures == 1


def test_client_probe_does_not_skew_admission_hit_rate():
    src, dst = _tier(8), _tier(8)
    src.store_batch([1, 2], *_blockdata(src, 2), 2)
    assert _client(src, dst).fetch_run("http://peer", [1, 2]) == 2
    snap = dst.snapshot()
    assert snap["hits"] == 0 and snap["misses"] == 0
    assert dst.probe_run([1, 2]) == 2 and dst.snapshot()["hits"] == 2


def test_client_fault_site_kvnet_fetch_degrades():
    src, dst = _tier(4), _tier(4)
    src.store_batch([1, 2], *_blockdata(src, 2), 2)
    rz_faults.configure("kvnet.fetch=error", 0)
    try:
        c = _client(src, dst)
        assert c.fetch_run("http://peer", [1, 2]) == 0
        snap = c.stats.snapshot()
        assert snap["fallbacks"] == 1 and snap["errors"] == 1
        assert not dst.has(1)
    finally:
        rz_faults.reset()


def test_kvnet_families_export_on_tier_pods_only():
    tele = StepTelemetry(total_blocks=8)
    tele.kvnet = KvNetStats()
    tele.kvnet.count_served(2, 100)
    tele.kvnet.count_fetched(1, 50)
    tele.kvnet.count_fallback()
    out = Exposition()
    engine_families(out, tele, "t")
    fams = {f.name: f for f in text_string_to_metric_families(out.text())}
    for fam in ("shai_kvnet_fetched", "shai_kvnet_served",
                "shai_kvnet_bytes", "shai_kvnet_errors",
                "shai_kvnet_fallbacks"):
        assert fams[fam].type == "counter", fam
    assert fams["shai_kvnet_bytes"].samples[0].value == 150.0
    bare = Exposition()
    engine_families(bare, StepTelemetry(total_blocks=8), "t")
    assert "shai_kvnet" not in bare.text()


# -- the handoff, engine to engine -------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


def _env(monkeypatch, tier=True, quant=False, async_decode=None):
    monkeypatch.setenv("SHAI_KVTIER", "1" if tier else "0")
    monkeypatch.setenv("SHAI_KVTIER_ASYNC", "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8" if quant else "")
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "0")
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    monkeypatch.delenv("SHAI_ROLE", raising=False)
    if async_decode is not None:
        monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_decode else "0")


def _port(tiny, monkeypatch, role="both", tier=True, quant=False,
          async_decode=None, **over):
    _, _, tcfg, model = tiny
    _env(monkeypatch, tier, quant, async_decode)
    return LLMEngine(tcfg, model, tconfig.EngineConfig(
        **dict(ENGINE_KW, role=role, **over)), device="cpu")


def _jax(tiny, monkeypatch, role="both", tier=True):
    jcfg, params, _, _ = tiny
    _env(monkeypatch, tier)
    return JEngine(jcfg, params, jconfig.EngineConfig(
        **dict(ENGINE_KW, role=role)))


def _prompt(seed, length=40):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(2, 500, length)]


def _run(eng, prompt, n, lp=0):
    Params = JParams if isinstance(eng, JEngine) else SamplingParams
    rid = eng.add_request(list(prompt), Params(
        temperature=0.0, max_new_tokens=n, logprobs=lp))
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


def _ship(src_tier, dst_tier, hashes, dst_frames=frames) -> int:
    """The wire in-process: the leading run, encoded by the source's
    package, decoded by the destination's, stored in its tier."""
    run = src_tier.get_run(hashes)
    src_frames = jframes if isinstance(src_tier, JTier) else frames
    entries = dst_frames.decode_frames(src_frames.encode_frames(run))
    stacked = [np.stack([e[1 + ai] for e in entries], axis=1)
               for ai in range(len(entries[0]) - 1)]
    dst_tier.store_batch([e[0] for e in entries], *stacked, len(entries))
    return len(entries)


@pytest.mark.parametrize("mode", ["async", "lockstep", "int8"])
def test_handoff_equals_monolithic(tiny, monkeypatch, mode):
    quant = mode == "int8"
    ad = mode != "lockstep"
    prompt = _prompt(5)
    pre = _port(tiny, monkeypatch, "prefill", quant=quant, async_decode=ad)
    dec = _port(tiny, monkeypatch, "decode", quant=quant, async_decode=ad)
    mono = _port(tiny, monkeypatch, "both", tier=False, quant=quant,
                 async_decode=ad)
    _run(pre, prompt, 1)
    hashes = pre.cache.prefix_hashes(prompt)
    assert pre.cache.tier.n_entries == len(hashes) == 5
    assert _ship(pre.cache.tier, dec.cache.tier, hashes) == len(hashes)
    _assert_bytes_equal(pre.cache.tier, dec.cache.tier, hashes)
    if quant:
        assert len(dec.cache.tier.get_run(hashes[:1])[0]) == 5
    fd, fm = _run(dec, prompt, 8), _run(mono, prompt, 8)
    assert fd.token_ids == fm.token_ids
    assert dec.cache.tier.snapshot()["restored"] > 0
    for e in (pre, dec):
        _assert_pool_exact(e)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_handoff_across_packages(tiny, monkeypatch, direction):
    """A run banked by one package's prefill engine, through the other's
    codec, restored and decoded by the other's engine: the monolithic
    port run's greedy tokens, or parting at a bf16 tie."""
    prompt = _prompt(7)
    mono = _run(_port(tiny, monkeypatch, tier=False), prompt, 8, lp=2)
    if direction == "jax-to-port":
        pre = _jax(tiny, monkeypatch, "prefill")
        dec = _port(tiny, monkeypatch, "decode")
        dst_frames = frames
    else:
        pre = _port(tiny, monkeypatch, "prefill")
        dec = _jax(tiny, monkeypatch, "decode")
        dst_frames = jframes
    _run(pre, prompt, 1)
    hashes = pre.cache.prefix_hashes(prompt)
    assert hashes == dec.cache.prefix_hashes(prompt)
    assert _ship(pre.cache.tier, dec.cache.tier, hashes,
                 dst_frames) == len(hashes)
    _assert_bytes_equal(pre.cache.tier, dec.cache.tier, hashes)
    got = _run(dec, prompt, 8, lp=2)
    assert dec.cache.tier.snapshot()["restored"] > 0
    assert_greedy_parity([got], [mono], label=direction)
    assert pre.cache.leaked_blocks == dec.cache.leaked_blocks == 0


def test_handoff_fetch_fault_degrades_to_recompute(tiny, monkeypatch):
    prompt = _prompt(6)
    pre = _port(tiny, monkeypatch, "prefill")
    dec = _port(tiny, monkeypatch, "decode")
    mono = _port(tiny, monkeypatch, "both", tier=False)
    _run(pre, prompt, 1)
    hashes = pre.cache.prefix_hashes(prompt)
    stats = KvNetStats()
    rz_faults.configure("kvnet.fetch=error", 0)
    try:
        c = _client(pre.cache.tier, dec.cache.tier, stats=stats)
        assert c.fetch_run("http://peer", hashes) == 0
    finally:
        rz_faults.reset()
    assert stats.snapshot()["fallbacks"] == 1 and dec.cache.tier.n_entries == 0
    fd, fm = _run(dec, prompt, 8), _run(mono, prompt, 8)
    assert fd.token_ids == fm.token_ids and fd.stop_reason in ("length",
                                                                "eos")
    _assert_pool_exact(pre)
    _assert_pool_exact(dec)


def test_engine_role_env_override(tiny, monkeypatch):
    _, _, tcfg, model = tiny
    _env(monkeypatch)
    monkeypatch.setenv("SHAI_ROLE", "prefill")
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                    device="cpu")
    assert eng.role == "prefill" and eng._prefill_role
    monkeypatch.setenv("SHAI_ROLE", "nonsense")
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(
        **dict(ENGINE_KW, role="decode")), device="cpu")
    assert eng.role == "decode"


# -- pods over sockets --------------------------------------------------------------

POD_CONFIG = {"model": "tiny", "max_model_len": 256, "block_size": 16,
              "context_encoding_buckets": [32, 64, 128],
              "max_new_tokens": 16, "enable_prefix_caching": True}


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """A JAX and a port pod of each role (prefill, decode) and a monolithic
    port pod, one process, the same weights."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SHAI_KVTIER", "1")
    mp.setenv("SHAI_KVTIER_ASYNC", "1")
    mp.delenv("SHAI_ROLE", raising=False)
    tmp = tmp_path_factory.mktemp("disagg")
    servers, out = [], {}
    try:
        for role in ("prefill", "decode", "both"):
            conf = tmp / f"{role}.yaml"
            conf.write_text(json.dumps({**POD_CONFIG, "role": role}))
            cfg, service = _port_service(tmp, vllm_config=str(conf))
            servers.append(Server(create_app(cfg, service),
                                  host="127.0.0.1", port=0))
            out["port", role] = service
            if role == "both":
                continue
            jcfg = JServeConfig(app="vllm", device="cpu", model_id="tiny",
                                batch_size=4, max_new_tokens=32,
                                vllm_config=str(conf))
            servers.append(JServer(jcreate_app(jcfg, get_model("vllm")(jcfg)),
                                   host="127.0.0.1", port=0))
            out["jax", role] = None
        keys = list(out)
        bases = {}
        for key, srv in zip(keys, servers):
            h, p = srv.start_background()
            bases[key] = f"http://{h}:{p}"
        for base in bases.values():
            _wait_ready(base)
        yield bases, out
    finally:
        for srv in servers:
            srv.stop()
        mp.undo()


def _tokens(base, prompt, n, lp=2, **extra):
    status, out = _http(base + "/generate", {
        "prompt": prompt, "max_new_tokens": n, "temperature": 0.0,
        "logprobs": lp, **extra})
    assert status == 200, out
    return out


@pytest.mark.parametrize("pair", [("jax", "port"), ("port", "jax")],
                         ids=["jax-prefill", "port-prefill"])
def test_disaggregated_pods_over_sockets(pods, pair):
    bases, services = pods
    pre, dec = bases[pair[0], "prefill"], bases[pair[1], "decode"]
    prompt = f"{pair[0]} prefills, {pair[1]} decodes: " + \
        "the quick brown fox jumps over the lazy dog " * 3
    status, handoff = _http(pre + "/generate", {"prompt": prompt,
                                                "temperature": 0.0})
    assert status == 200 and handoff["kv_ready"] is True, handoff
    assert handoff["role"] == "prefill" and handoff["hashes_len"] > 4
    got = _tokens(dec, prompt, 12, kv_peer=pre,
                  kv_hashes_len=handoff["hashes_len"],
                  kv_digest=handoff["digest"])
    want = _tokens(bases["port", "both"], prompt, 12)
    if got["generated_text"] != want["generated_text"]:
        fg = dataclasses.make_dataclass("F", ["token_ids", "logprobs"])
        assert_greedy_parity(
            [fg([e["token"] for e in got["logprobs"]], got["logprobs"])],
            [fg([e["token"] for e in want["logprobs"]], want["logprobs"])],
            label=f"{pair} pods")
    status, stats = _http(dec + "/stats")
    assert stats["role"] == "decode"
    assert stats["kvnet"]["fetched"] >= handoff["hashes_len"]
    assert stats["kvtier"]["restored"] > 0
    assert stats["kvnet"]["fallbacks"] == 0
    status, pstats = _http(pre + "/stats")
    assert pstats["role"] == "prefill" and pstats["kvnet"]["served"] > 0
    if pair[1] == "port":
        eng = services["port", "decode"]._engine
        assert eng.cache.leaked_blocks == 0 and eng.obs.recompiles == 0
        status, text = _http(dec + "/metrics", raw=True)
        fams = {f.name for f in text_string_to_metric_families(text)}
        assert {"shai_kvnet_fetched", "shai_kvtier_restored",
                "shai_kvtier_hit_rate"} <= fams
        assert services["port", "decode"].affinity_digests()
    if pair[0] == "port":
        status, out = _http(pre + "/v1/completions", {"prompt": "x"})
        assert status == 400
        status, blk = _http(pre + "/kv/blocks?hashes=1,2", raw=True)
        assert status == 200 and blk == ""   # nothing resident: empty run
        status, dig = _http(pre + "/kv/digests")
        assert status == 200 and dig["adverts"]
