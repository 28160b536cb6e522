"""What the spawned ranks of ``tests/test_torch_multihost.py`` run: a toy
service, its scenarios over ``serve.multihost.MultihostDriver``, and the
weights seam that carries the JAX unit's drawn tree into every rank of the
``llama`` unit. Importable by reference in a spawned rank: no JAX here."""

import json
import os
import signal
import time

import torch

from scalable_hw_agnostic_inference_tpu_torch.engine.ranks import rank_state
from scalable_hw_agnostic_inference_tpu_torch.models import llama as pllama
from scalable_hw_agnostic_inference_tpu_torch.models import t5 as pt5
from scalable_hw_agnostic_inference_tpu_torch.models.generate import (
    make_generate,
)
from scalable_hw_agnostic_inference_tpu_torch.obs import trace as obs_trace
from scalable_hw_agnostic_inference_tpu_torch.resilience import faults
from scalable_hw_agnostic_inference_tpu_torch.serve import multihost
from scalable_hw_agnostic_inference_tpu_torch.serve.asgi import HTTPError


class Toy:
    """Every call of ``infer`` enters a collective (the sum of ``x`` over
    the ranks); ``bad`` is the symmetric 400, ``boom`` a divergence."""

    supports_multihost = True
    mirror_methods = ("infer",)

    def __init__(self, group):
        self.group = group
        self.seen = []

    def infer(self, payload):
        if payload.get("bad"):
            raise HTTPError(400, "bad payload")
        if payload.get("boom"):
            raise RuntimeError("this rank diverged")
        total = self.group.all_reduce(
            torch.full((1,), float(payload["x"])))
        self.seen.append([payload["x"], float(total)])
        return float(total)


class ToyUnit:
    """The smallest unit ``serve.multihost.start_ranks`` takes: nothing
    to load, and every mirrored ``infer`` enters the group's sum."""

    supports_multihost = True
    mirror_methods = ("infer",)
    group = None

    def __init__(self, cfg):
        self.cfg = cfg

    def load(self):
        pass

    def ready_error(self):
        return None

    def infer(self, payload):
        return float(self.group.all_reduce(
            torch.full((1,), float(payload["x"]))))


def endings(units, tp):
    """``units`` toy units over ``serve.multihost.start_ranks`` at ``tp``,
    one after the other, on the CPU: a few mirrored sums, then ``close``;
    each child rank's exit code (and ``close``'s error, if it raised). Run
    in a process of its own (this process becomes each unit's rank 0, and
    a process holds one default group at a time)."""
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    torch.set_num_threads(1)
    out = []
    for _ in range(units):
        cfg = ServeConfig(app="toy", device="cpu", mesh_spec=f"tp={tp}")
        unit, fails = ToyUnit(cfg), []
        ranks = multihost.start_ranks(cfg, unit, on_fail=fails.append)
        unit.load()
        sums = [unit.infer({"x": x}) for x in (1.0, 2.0, 3.0)]
        try:
            ranks.close()
            err = None
        except RuntimeError as e:
            err = str(e)
        out.append({"sums": sums, "fails": fails, "error": err,
                    "exit": [p.exitcode for p in ranks.procs],
                    "mirrored": ranks.mirrored})
    return out


#: the dense generate over the group: the tiny Llama's seed, two right-
#: padded prompts in one 16-token bucket, the sampled call's knobs
GEN_SEED, GEN_IDS, GEN_LENS, GEN_NEW = 7, [[1, 40, 51, 9, 77, 3, 0, 0] + [0] * 8,
                                           [1, 5, 0, 0] + [0] * 12], [6, 2], 10
GEN_SAMPLED = dict(seed=5, temperature=0.8, top_k=20, top_p=0.9)


def generate_tokens(group=None):
    """``make_generate``'s greedy and sampled tokens for ``GEN_IDS`` on
    the tiny Llama (fp32, seeded), over ``group``'s rank of it (None: the
    whole model)."""
    cfg = pllama.LlamaConfig.tiny()
    state = pllama.random_params(cfg, GEN_SEED, dtype=torch.float32,
                                 device="cpu")
    if group is not None:
        cfg, state = rank_state(cfg, state, group, "cpu")
    model = pllama.LlamaForCausalLM.from_state_dict(
        cfg, state, dtype=torch.float32, group=group)
    gen = make_generate(model, cfg, prompt_bucket=16,
                        max_new_tokens=GEN_NEW)
    ids, lens = torch.tensor(GEN_IDS), torch.tensor(GEN_LENS)
    return {"greedy": gen(ids, lens, temperature=0.0).tokens.tolist(),
            "sampled": gen(ids, lens, **GEN_SAMPLED).tokens.tolist()}


def _save(outdir, rank, out):
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def toy_rank(group, outdir):
    """The driver's semantics on one rank, scenario by scenario: (1) calls
    in order, a 400 that leaves the follower looping, the leader's trace
    id on the follower's mirror traces, the shutdown; (2) an unmirrored
    name, refused; (3) a call that raises on every rank: the leader's
    ``on_fail`` and a follower that dies; then the dense generate over the
    group (:func:`generate_tokens`); then the results are saved and
    (4) the leader's broadcast is dropped: it waits alone in the sum until
    the group's timeout and its process exits with ``FAIL_EXIT``, and
    the follower's loop ends when the leader's process does."""
    torch.set_num_threads(1)
    obs_trace.configure(True)
    rank, lead = group.rank, group.rank == 0
    out = {}
    # (1)
    svc = Toy(group)
    traces = []
    drv = multihost.MultihostDriver(svc, group, trace_sink=traces.append)
    if lead:
        drv.wrap_leader()
        tr = obs_trace.begin_request_trace("request")
        with obs_trace.use_trace(tr):
            sums = [svc.infer({"x": 1.0})]
        try:
            svc.infer({"bad": True})
        except HTTPError as e:
            out["rejected"] = e.status
        sums.append(svc.infer({"x": 2.0}))
        drv.shutdown()
        out.update(sums=sums, trace_id=tr.trace_id)
    else:
        drv.follower_loop()
        out["traces"] = [[t["trace_id"], t["name"]] for t in traces]
    out.update(seen=svc.seen, calls=dict(drv.calls))
    # (2)
    if lead:
        group.broadcast((multihost._OP_CALL, ("load", (), {}, None)))
    else:
        try:
            multihost.MultihostDriver(Toy(group), group).follower_loop()
        except ValueError as e:
            out["unmirrored"] = str(e)
    # (3)
    svc = Toy(group)
    fails = []
    drv = multihost.MultihostDriver(svc, group, on_fail=fails.append)
    if lead:
        drv.wrap_leader()
        try:
            svc.infer({"boom": True})
        except RuntimeError as e:
            out["raised"] = str(e)
        out["on_fail"] = fails
    else:
        try:
            drv.follower_loop()
        except RuntimeError as e:
            out["died"] = str(e)
    # the dense generate over the group: both ranks leave the loop
    # together, the same tokens on each
    out["generate"] = generate_tokens(group)
    # (4)
    out["dropped_at"] = time.time()
    _save(outdir, rank, out)
    svc = Toy(group)
    drv = multihost.MultihostDriver(svc, group)
    if lead:
        faults.configure("multihost.mirror=drop#1")
        drv.wrap_leader()
        svc.infer({"x": 3.0})   # alone in the sum: the process ends
        return "the leader returned"
    try:
        drv.follower_loop()
    except Exception as e:
        return {"leader_gone_after": time.time() - out["dropped_at"],
                "error": type(e).__name__}
    return "the follower's loop ended"


#: the silent-leader group's beat: a follower hears nothing for
#: ``BEAT_MISSES`` of them before it ends
SILENT_BEAT_S = 0.5


def silent_leader_rank(group, outdir):
    """A leader lost without a word: it beats (``SILENT_BEAT_S``) through
    one call and some idle beats, then stops (``SIGSTOP``: its process and
    its connections stay, nothing more comes). The follower, which heard
    every beat till then, ends with ``FAIL_EXIT`` once
    ``BEAT_MISSES`` beats have gone missing."""
    torch.set_num_threads(1)
    svc = Toy(group)
    drv = multihost.MultihostDriver(svc, group, beat_s=SILENT_BEAT_S)
    if group.rank == 0:
        drv.wrap_leader()
        drv.start_beats()
        svc.infer({"x": 1.0})
        # idle longer than the follower's bound: only the beats keep it
        time.sleep(2 * multihost.BEAT_MISSES * SILENT_BEAT_S)
        with drv._lock:   # no beat is half sent when the process stops
            _save(outdir, 0, {"stopped_at": time.time(),
                              "sums": svc.seen})
            os.kill(os.getpid(), signal.SIGSTOP)
        return "the leader resumed"
    drv.follower_loop()
    return "the follower's loop ended"


class CarriedT5:
    """The ``t5`` unit's weights seam over a JAX ``T5Encoder`` tree of
    numpy leaves (``models.t5.params_from_jax``), pickled into every
    rank."""

    def __init__(self, tree):
        self.tree = tree

    def __call__(self, mcfg, device):
        return {k: v.to(device)
                for k, v in pt5.params_from_jax(self.tree).items()}


class Carried:
    """The ``llama`` unit's weights seam over a JAX tree of numpy leaves
    (``models.llama.params_from_jax``), pickled into every rank."""

    def __init__(self, tree):
        self.tree = tree

    def __call__(self, mcfg, device):
        return {k: v.to(device)
                for k, v in pllama.params_from_jax(self.tree, mcfg).items()}
