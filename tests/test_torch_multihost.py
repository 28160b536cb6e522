"""The port's units over tensor-parallel ranks (``serve/multihost.py``,
``serve/units/common.py``'s ``unit_ranks``, the ``llama`` and ``vllm``
units), on the CPU over gloo, held against the JAX package.

One module fixture starts every group of the file at once and collects
what they did:

- a two-rank toy group (``spawn_ranks``, ``tests/multihost_cases.py``):
  ``MultihostDriver``'s semantics case by case, as the reference's
  ``tests/test_multihost.py`` mirror worker shows them: calls in order, a
  400 that leaves the follower looping, the leader's trace id on the
  follower's mirror traces, the shutdown, an unmirrored name refused, a
  divergence that kills the follower, and a dropped mirror that ends the
  leader's process with ``FAIL_EXIT`` within :data:`DROP_BOUND_S`; on
  the same group, the dense generate: greedy tokens the whole model's,
  sampled ones equal on both ranks;
- a second two-rank toy group whose leader beats, then stops without a
  word (``SIGSTOP``): the follower ends with ``FAIL_EXIT`` within
  :data:`SILENT_BOUND_S`;
- the ending of :data:`ENDED_RANKS` spawned child ranks: toy units over
  ``start_ranks`` at ``tp=5`` (``multihost_cases.endings``, in a process
  of its own), one after the other, each mirroring a few sums and then
  closed; every child must exit with code 0 (a child that returned into
  the interpreter's teardown once aborted there with -6 under load);
- the ``llama`` unit at ``MESH_SPEC=tp=2`` (this process rank 0, behind
  the stdlib server; one follower process), its weights the JAX unit's
  numpy draws carried to every rank (``multihost_cases.Carried``): greedy
  ``/generate`` equal to the port's unit at tp=1 and to the JAX unit at
  ``mesh_spec="tp=2"`` on two of the 8 virtual devices, two prompts, once
  with ``max_new_tokens=5``; the warmup and every call mirrored;
- the ``vllm`` unit with ``tensor_parallel_size: 2`` against tp=1;
- through the entry point, as ``tests/test_multihost.py::_run_cluster``
  starts its processes: two hosts of ``python -m
  scalable_hw_agnostic_inference_tpu_torch.serve llama`` under
  ``SHAI_COORDINATOR`` (host 1 a follower with its probes, both ending
  with rc 0 after the leader's SIGTERM), and one host at ``tp=2`` whose
  follower is killed: ``/readiness`` 503, then the leader's exit with
  ``FAIL_EXIT`` within :data:`KILL_BOUND_S`, no rank left.
"""

import concurrent.futures
import json
import math
import multiprocessing
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.core.budget import (
    GIB,
    HbmBudgetError,
    dense_lm_budget,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.ranks import (
    stream_rank_state,
)
from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
    LlamaConfig,
    random_params,
    replicate_kv_heads,
    tp_rules,
)
from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
    quantize_state_dict,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.distributed import (
    spawn_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.sharding import (
    shard_state_dict,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.multihost import (
    BEAT_MISSES,
    FAIL_EXIT,
    FAIL_GRACE_S,
    start_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import multihost_cases as cases  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = str(Path(__file__).resolve().parent.parent)
#: the llama units' cap on new tokens here
NEW = 12
#: one bucket (32 tokens)
PROMPTS = ["the quick brown fox", "a"]
#: the toy group's collective timeout: how long the leader waits alone.
#: It bounds the group's rendezvous too, so it leaves room for the two
#: ranks' interpreters to start seconds apart on a loaded machine
TOY_TIMEOUT_S = 8.0
#: a dropped mirror ends the leader's process within this: the timeout,
#: then at most a second of the spawner's polling, with room for a loaded
#: machine
DROP_BOUND_S = TOY_TIMEOUT_S + 7.0
#: a follower hears nothing from a stopped leader for this long before it
#: ends (its bound), and the spawner sees it end within a second and a
#: half more; room for a loaded machine
SILENT_MISS_S = BEAT_MISSES * cases.SILENT_BEAT_S
SILENT_BOUND_S = SILENT_MISS_S + 6.0
#: a killed follower ends the leader's process within this: the watch's
#: poll and ``FAIL_GRACE_S``, with room for a loaded machine
KILL_BOUND_S = FAIL_GRACE_S + 6.0
#: a process's limit to come up (an interpreter, torch, the tiny unit)
BOOT_S = 120.0
#: the toy units whose child ranks are ended, and their tp
ENDINGS, ENDING_TP = 2, 5
ENDED_RANKS = ENDINGS * (ENDING_TP - 1)


def _free_ports(n: int):
    """``n`` distinct free ports (all held open while they are picked)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _http(url, payload=None, timeout=60.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except (urllib.error.URLError, ConnectionError):
        return None, {}


def _wait(url, proc=None, log=None, status=200, timeout=BOOT_S):
    """Poll ``url`` until it answers ``status``; fail, with the end of
    ``log``, when the serving process ``proc`` ends or at ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        got = _http(url)
        if got[0] == status:
            return got[1]
        why = (f"the process ended with {proc.returncode}"
               if proc is not None and proc.poll() is not None else
               None if time.monotonic() < deadline else f"still {got}")
        tail = Path(log).read_text()[-3000:] if log else ""
        assert why is None, f"{url}: {why}\n{tail}"
        time.sleep(0.1)


def _entry(env, log):
    """``python -m ...serve llama`` on the tiny tier under ``env``, its
    output to the file ``log``."""
    full = dict(os.environ)
    full.pop("XLA_FLAGS", None)
    full.update({"DEVICE": "cpu", "MODEL_ID": "tiny", "APP": "llama",
                 "METRICS_PORT": "0", "MAX_NEW_TOKENS": "4",
                 "DRAIN_BUDGET_S": "2", "OMP_NUM_THREADS": "1",
                 "PYTHONPATH": REPO + os.pathsep + full.get("PYTHONPATH",
                                                            ""), **env})
    return subprocess.Popen(
        [sys.executable, "-m", "scalable_hw_agnostic_inference_tpu_torch."
         "serve", "llama"], env=full, cwd=REPO, stdout=open(log, "w"),
        stderr=subprocess.STDOUT)


def _children(pid):
    """The spawned rank processes whose parent is ``pid``."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
            cmd = Path(f"/proc/{d}/cmdline").read_bytes()
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        if ppid == pid and b"spawn_main" in cmd:
            out.append(int(d))
    return out


def _alive(pid) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _two_hosts(tmp):
    """Two hosts of the entry point at tp=2 under ``SHAI_COORDINATOR``;
    one request, then SIGTERM to the leader."""
    coord, *ports = _free_ports(3)
    logs = [os.path.join(tmp, f"host{pid}.log") for pid in range(2)]
    procs = []
    try:
        for pid in range(2):
            procs.append(_entry({
                "SHAI_COORDINATOR": f"127.0.0.1:{coord}",
                "SHAI_NUM_PROCESSES": "2", "SHAI_PROCESS_ID": str(pid),
                "MESH_SPEC": "tp=2", "PORT": str(ports[pid])}, logs[pid]))
        lead, fol = (f"http://127.0.0.1:{p}" for p in ports)
        health = _wait(fol + "/health", procs[1], logs[1])
        follower_ready = _wait(fol + "/readiness", procs[1], logs[1])
        _wait(lead + "/readiness", procs[0], logs[0])
        gen = _http(lead + "/generate", {"prompt": "hi", "temperature": 0})
        procs[0].send_signal(signal.SIGTERM)
        rcs = [p.wait(60) for p in procs]
        return {"health": health, "ready": follower_ready, "generate": gen,
                "rcs": rcs}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)


def _killed_follower(tmp):
    """One host of the entry point at tp=2; its follower killed."""
    [port] = _free_ports(1)
    log = os.path.join(tmp, "killed.log")
    proc = _entry({"MESH_SPEC": "tp=2", "PORT": str(port)}, log)
    base = f"http://127.0.0.1:{port}"
    try:
        _wait(base + "/readiness", proc, log)
        [child] = _children(proc.pid)
        grandchildren = _children(child)
        t0 = time.monotonic()
        os.kill(child, signal.SIGKILL)
        seen = []
        while proc.poll() is None and time.monotonic() - t0 < 30:
            seen.append(_http(base + "/readiness", timeout=2)[0])
            time.sleep(0.05)
        took = time.monotonic() - t0
        rc = proc.wait(30)
        return {"rc": rc, "seconds": took, "readiness": seen,
                "child_alive": _alive(child), "grandchildren": grandchildren,
                "left": _children(proc.pid)}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def _toy(tmp):
    t0 = time.monotonic()
    try:
        spawn_ranks(cases.toy_rank, 2, "gloo", timeout_s=BOOT_S,
                    args=(tmp,), group_timeout_s=TOY_TIMEOUT_S)
        err = None
    except RuntimeError as e:
        err = str(e)
    ended = time.time()
    ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
             for r in range(2)]
    return {"error": err, "ended": ended, "ranks": ranks,
            "seconds": time.monotonic() - t0}


def _silent(tmp):
    try:
        spawn_ranks(cases.silent_leader_rank, 2, "gloo", timeout_s=BOOT_S,
                    args=(tmp,), group_timeout_s=TOY_TIMEOUT_S)
        err = None
    except RuntimeError as e:
        err = str(e)
    ended = time.time()
    return {"error": err, "ended": ended,
            "leader": json.loads(Path(tmp, "rank0.json").read_text())}


def _draws(shapes, seed):
    """Numpy draws of a flax tree: kernels and embeddings N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        fan = (int(np.prod(s.shape[:-1])) if name == "kernel"
               else s.shape[-1])
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_tp2():
    """The JAX ``llama`` unit at ``mesh_spec="tp=2"``, its flax init
    replaced by numpy draws; returns (the unit, the drawn tree)."""
    jservice = get_model("llama")(JServeConfig(
        app="llama", model_id="tiny", device="cpu", mesh_spec="tp=2",
        max_new_tokens=NEW, warmup=False))
    orig, drawn = fnn.Module.init, {}

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kw),
                                rngs, *args)
        drawn[type(self).__name__] = _draws(shapes, 3)
        return drawn[type(self).__name__]

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Module, "init", init)
    try:
        jservice.load()
    finally:
        mp.undo()
    return jservice, jax.tree.map(np.asarray, drawn["LlamaForCausalLM"])


def _payloads():
    return [{"prompt": p, "temperature": 0.0, **extra} for p in PROMPTS
            for extra in ({}, {"max_new_tokens": 5})]


def _llama_tp2(carried):
    """The port's llama unit at tp=2: this process rank 0 behind the
    stdlib server, one follower process; the answers, the mirrored counts
    and the 400s."""
    cfg = ServeConfig(app="llama", device="cpu", model_id="tiny",
                      mesh_spec="tp=2", max_new_tokens=NEW)
    service = UNITS["llama"](cfg, weights=carried)
    fails = []
    ranks = start_ranks(cfg, service, on_fail=fails.append)
    server = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = server.start_background()
    base = f"http://{host}:{port}"
    try:
        _wait(base + "/readiness")
        answers = [_http(base + "/generate", p) for p in _payloads()]
        past_cap = _http(base + "/generate", {"prompt": "hi",
                                              "max_new_tokens": NEW + 1})
        no_number = _http(base + "/generate", {"prompt": "hi",
                                               "max_new_tokens": "many"})
        sentiment = _http(base + "/sentiment", {"text": "great movie"})
    finally:
        server.stop()
        ranks.close()
    return {"answers": answers, "past_cap": past_cap, "no_number": no_number,
            "sentiment": sentiment, "mirrored": ranks.mirrored,
            "boot": ranks.boot, "fails": fails, "group": service.group,
            "heads": service.model.layers[0].attn.n_kv_heads,
            "follower_exit": [p.exitcode for p in ranks.procs]}


def _vllm(tmp, tp):
    path = os.path.join(tmp, f"vllm-tp{tp}.yaml")
    Path(path).write_text(json.dumps({"tensor_parallel_size": tp,
                                      "max_new_tokens": 8,
                                      "max_num_seqs": 2}))
    service = UNITS["vllm"](ServeConfig(app="vllm", device="cpu",
                                        model_id="tiny", vllm_config=path,
                                        warmup=False))
    service.load()
    try:
        texts = [service.infer({"prompt": p, "temperature": 0.0,
                                "max_new_tokens": 8})["generated_text"]
                 for p in PROMPTS]
        followers = (service._engine.mirror.followers
                     if service._engine.mirror else [])
    finally:
        service.close()
    return {"texts": texts, "exit": [p.exitcode for p in followers]}


@pytest.fixture(scope="module")
def runs():
    tmp = tempfile.mkdtemp(prefix="shai-mh-test-")
    toy_dir = os.path.join(tmp, "toy")
    os.makedirs(toy_dir)
    silent_dir = os.path.join(tmp, "silent")
    os.makedirs(silent_dir)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        toy = pool.submit(_toy, toy_dir)
        silent = pool.submit(_silent, silent_dir)
        # one entry point after the other: fewer interpreters start at
        # once beside the other test workers
        hosts = pool.submit(lambda: (_two_hosts(tmp), _killed_follower(tmp)))
        # a process of its own: each toy unit's rank 0 holds that
        # process's default group
        ctx = multiprocessing.get_context("spawn")
        ending = concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx)
        endings = ending.submit(cases.endings, ENDINGS, ENDING_TP)
        jservice, tree = _jax_tp2()
        carried = cases.Carried(tree)
        # rank 0 in a thread here, its follower booting meanwhile; it
        # ends before the vllm unit's group (one default group a process)
        llama = pool.submit(_llama_tp2, carried)
        jax_answers = [jservice.infer(p) for p in _payloads()]
        one = UNITS["llama"](ServeConfig(app="llama", device="cpu",
                                         model_id="tiny",
                                         max_new_tokens=NEW),
                             weights=carried)
        one.load()
        tp1 = [one.infer(p) for p in _payloads()]
        llama = llama.result()
        vllm = {tp: _vllm(tmp, tp) for tp in (1, 2)}
        entry = hosts.result()
        out = {"toy": toy.result(), "silent": silent.result(),
               "hosts": entry[0], "killed": entry[1],
               "jax": jax_answers, "tp1": tp1,
               "llama": llama, "vllm": vllm, "logs": tmp,
               "endings": endings.result()}
        ending.shutdown()
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def _strip(body):
    return {k: v for k, v in body.items() if k != "latency_s"}


# -- a rank's load: priced first, then only its shard placed ------------------


class _Placed(TorchFunctionMode):
    """Records the shape of every tensor made on the meta device (the
    card's stand-in, where nothing is allocated), under the name of the
    entry being read."""

    def __init__(self):
        super().__init__()
        self.entry = None
        self.made = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.device.type == "meta":
            self.made.append((self.entry, tuple(out.shape)))
        return out


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_a_rank_places_only_its_shard(tp, quant):
    """``stream_rank_state`` (the llama unit's load at a rank of several),
    the meta device standing in for the card: no tensor made there while
    an entry is read is larger than that entry's slice (no whole entry
    reaches the device; at tp=4 the tiny model's 2 kv heads are widened
    first), the shard's bytes are ``dense_lm_budget``'s price,
    and on the CPU the shard equals the whole dict's, widened and then
    sharded."""
    cfg = LlamaConfig.tiny()
    state = random_params(cfg, 5, dtype=torch.float32, device="cpu")
    rank = tp - 1
    spy = _Placed()

    def items():
        for name, t in state.items():
            spy.entry = name
            yield name, t.clone()

    with spy:
        wide, shard = stream_rank_state(cfg, items(), tp, rank, "meta",
                                        quantize=quant)
    assert wide.n_kv_heads == max(cfg.n_kv_heads, tp)
    derived = {}
    for name in state:
        stem = name[: -len(".weight")]
        derived[name] = [k for k in (name, f"{stem}.weight_q",
                                     f"{stem}.scale") if k in shard]
    # a whole split entry has tp times its slice's elements
    assert spy.made and all(
        math.prod(shape) <= max(shard[k].numel() for k in derived[entry])
        for entry, shape in spy.made), spy.made
    placed = sum(t.numel() * t.element_size() for t in shard.values())
    price = dense_lm_budget(
        cfg, tp=tp, quantization="int8" if quant else None,
        prompt_buckets=[32], max_new_tokens=4, hbm_gib_per_chip=1.0,
        what="tiny", dtype="float32").params_gib * GIB
    if quant:
        # int8 is priced at 1.02 bytes an element, the f32 scale of a row
        # of thousands; the tiny model's rows are 16 to 64 wide, so its
        # scales weigh more: within 5% here
        assert abs(placed - price) < 0.05 * price, (placed, price)
    else:
        assert placed == price
    whole = quantize_state_dict(dict(state)) if quant else dict(state)
    whole, _ = replicate_kv_heads(whole, cfg, tp)
    want = shard_state_dict(whole, tp_rules(), tp, rank)
    _, got = stream_rank_state(cfg, iter(state.items()), tp, rank, "cpu",
                               quantize=quant)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_70b_tiers_priced_per_rank():
    """The multi-host manifests' model (Llama-3-70B) on 80 GB cards: the
    whole model does not fit one, a rank of tp=16 (bf16) and of tp=32
    (int8) does."""
    cfg = LlamaConfig.llama3_70b()

    def price(tp, quant):
        return dense_lm_budget(
            cfg, tp=tp, quantization=quant, prompt_buckets=[32, 64],
            max_new_tokens=128, hbm_gib_per_chip=80.0, what="70b")

    with pytest.raises(HbmBudgetError, match="OVER BUDGET"):
        price(1, None).check()
    assert price(16, None).check().params_gib < 10.0
    assert price(32, "int8").check().params_gib < 3.0


def test_llama_unit_prices_its_load_before_reading(monkeypatch):
    """Under the gate (on the card always; here ``SHAI_ENFORCE_HBM=1``), a
    load that cannot fit is refused before any weight is read."""
    monkeypatch.setenv("SHAI_ENFORCE_HBM", "1")
    monkeypatch.setenv("SHAI_HBM_GIB", "0.0001")
    service = UNITS["llama"](ServeConfig(app="llama", device="cpu",
                                         model_id="tiny", max_new_tokens=4))

    def read_state(*args):
        raise AssertionError("a weight read before the price")

    monkeypatch.setattr(service, "read_state", read_state)
    with pytest.raises(HbmBudgetError, match="'tiny' tp=1"):
        service.load()


# -- the driver, over a two-rank gloo group -----------------------------------


def test_mirror_order_400_trace_and_shutdown(runs):
    lead, fol = runs["toy"]["ranks"]
    assert lead["sums"] == [2.0, 4.0] and lead["rejected"] == 400
    # the follower ran both calls in order (the 400 between them did not
    # end its loop); each entered the same sum
    assert fol["seen"] == lead["seen"] == [[1.0, 2.0], [2.0, 4.0]]
    assert lead["calls"] == fol["calls"] == {"infer": 3}
    # the first call's mirror traced under the leader's trace id
    assert fol["traces"][0] == [lead["trace_id"], "mirror infer"]
    assert len({t for t, _ in fol["traces"]}) == 3


def test_unmirrored_name_and_divergence(runs):
    lead, fol = runs["toy"]["ranks"]
    assert fol["unmirrored"] == "unmirrored method 'load'"
    # a call that raises on the leader fails the unit (on_fail), and
    # kills the follower's loop
    assert lead["raised"] == fol["died"] == "this rank diverged"
    assert lead["on_fail"] == ["mirrored infer raised RuntimeError: this "
                               "rank diverged"]


def test_dense_generate_agrees_on_both_ranks(runs):
    """``make_generate`` over the two-rank group: greedy tokens equal to
    the whole model's, and sampled tokens (one generator a rank, seeded
    by the call) equal on both ranks, so their ``done`` reads agree and
    they leave the decode loop together."""
    lead, fol = (r["generate"] for r in runs["toy"]["ranks"])
    assert lead == fol
    assert lead["greedy"] == cases.generate_tokens()["greedy"]
    assert lead["sampled"] != lead["greedy"]


def test_dropped_mirror_ends_the_leader(runs):
    toy = runs["toy"]
    assert toy["error"] is not None and \
        f"rank 0 exited with code {FAIL_EXIT}" in toy["error"], toy["error"]
    took = toy["ended"] - toy["ranks"][0]["dropped_at"]
    assert TOY_TIMEOUT_S <= took < DROP_BOUND_S, took


def test_silent_leader_ends_the_follower(runs):
    """A leader that stops without a word (its connections open) leaves
    the follower no collective to fail: the missing beats end it."""
    silent = runs["silent"]
    assert silent["leader"]["sums"] == [[1.0, 2.0]]
    assert silent["error"] is not None and \
        f"rank 1 exited with code {FAIL_EXIT}" in silent["error"], \
        silent["error"]
    took = silent["ended"] - silent["leader"]["stopped_at"]
    # the last beat came at most one beat before the stop
    assert SILENT_MISS_S - cases.SILENT_BEAT_S <= took < SILENT_BOUND_S, \
        took


def test_child_ranks_end_with_code_0(runs):
    """Every spawned child rank ends through the repaired path: the group
    left, the streams flushed, exit code 0 (``close`` raises on any other
    code, unchanged)."""
    endings = runs["endings"]
    codes = [c for e in endings for c in e["exit"]]
    assert len(codes) == ENDED_RANKS >= 8
    for e in endings:
        assert e["error"] is None and e["fails"] == [], e
        assert e["exit"] == [0] * (ENDING_TP - 1), e
        assert e["sums"] == [ENDING_TP * x for x in (1.0, 2.0, 3.0)]
        assert e["mirrored"] == [{"infer": 3}] * ENDING_TP


# -- the llama unit over two ranks ------------------------------------------


@pytest.mark.parametrize("i", range(len(PROMPTS) * 2))
def test_llama_tp2_generates_the_tp1_and_jax_tokens(runs, i):
    status, body = runs["llama"]["answers"][i]
    assert status == 200, body
    assert _strip(body) == runs["tp1"][i] == runs["jax"][i]
    assert body["n_tokens"] <= (5 if i % 2 else NEW)


def test_llama_tp2_mirrors_every_call(runs):
    llama = runs["llama"]
    # the warmup, 4 requests, the two 400s, /sentiment: on both ranks,
    # the 400s raised on each before any device work
    assert llama["mirrored"] == [{"generate_text": 8}] * 2
    assert llama["past_cap"][0] == llama["no_number"][0] == 400
    assert llama["sentiment"][0] == 200
    assert llama["fails"] == [] and llama["follower_exit"] == [0]
    assert [b["rank"] for b in llama["boot"]] == [0, 1]
    assert llama["group"].size == 2 and llama["group"].rank == 0
    assert llama["heads"] == 1   # the tiny model's 2 kv heads over 2 ranks


def test_vllm_tensor_parallel_size_2_equals_tp1(runs):
    one, two = runs["vllm"][1], runs["vllm"][2]
    assert two["texts"] == one["texts"] and all(two["texts"])
    assert one["exit"] == [] and two["exit"] == [0]


# -- the entry point -------------------------------------------------------


def test_two_hosts_through_the_entry_point(runs):
    hosts = runs["hosts"]
    assert hosts["health"]["role"] == "follower"
    assert hosts["health"]["process"] == 1 and hosts["health"]["rank"] == 1
    assert hosts["ready"] == {"status": "ready", "role": "follower"}
    assert hosts["generate"][0] == 200
    assert hosts["rcs"] == [0, 0], open(os.path.join(
        runs["logs"], "host0.log")).read()[-3000:]


def test_killed_follower_ends_the_unit(runs):
    killed = runs["killed"]
    assert killed["rc"] == FAIL_EXIT, killed
    assert killed["seconds"] < KILL_BOUND_S, killed
    # readiness went 503 before the process ended
    assert 503 in killed["readiness"], killed["readiness"]
    # the follower spawned no rank of its own, and none is left
    assert killed["grandchildren"] == []
    assert not killed["child_alive"] and killed["left"] == []
