"""The ``t5`` and ``flux`` units over tensor-parallel ranks (ROADMAP A7.3b)
on the CPU, held against tp=1 and the JAX package's sharded paths on the
8 virtual devices (``tests/conftest.py``).

- the sectioned splits (``parallel/sharding.py``): each section of each
  rank concatenates back, a split that does not divide a section is
  refused, a column-parallel bias splits with its output and a
  row-parallel one is added once, after the all-reduce;
- the rank-local T5 encoder and Flux transformer at tp 2 and 4 over
  ``LoopbackGroup``, numpy-drawn flax trees carried in: within
  :data:`TP_ATOL` of tp=1 and of the JAX package's sharded forward
  (``shard_pytree`` + jit, ``tests/test_models_t5.py`` and
  ``tests/test_models_flux.py``'s recipes), fp32;
- the two-rank denoise (``FluxPipeline.denoise`` over the rank-local
  transformer), given the JAX run's latents and conditioning, against the
  JAX pipeline's denoise on a 2-device submesh;
- through ``serve.multihost.start_ranks`` and the stdlib server, one
  spawned follower at a time (this process is rank 0): the ``t5`` unit
  at ``MESH_SPEC=tp=2``, the JAX unit's drawn weights carried to both
  ranks, ``/embed`` within :data:`TP_ATOL` of the port at tp=1 and of the
  JAX unit at ``mesh_spec="tp=2"``; the ``flux`` unit at
  ``SUBMESH=0:2`` against the port's tp=1 on the same seed, within
  :data:`IMAGE_LEVELS`; the 400s (no text, a ``steps`` value outside the
  set, a bad knob) raised on both ranks and counted there, the follower
  serving on after them, every mirrored call counted on both ranks, the
  follower's exit code 0;
- the refusals before any rank starts: several hosts for both units, a
  tp that does not divide the heads; the group of one through the env
  path; the entry point's choice;
- the per-rank price (``core.budget.rank_budget``): the bytes a rank
  places, the leader's encoders where they share its device, a load that
  cannot fit refused before any weight is read; a diffusers snapshot's
  entries read one at a time.
"""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_hw_agnostic_inference_tpu.core.mesh import build_mesh
from scalable_hw_agnostic_inference_tpu.models import flux as jflux
from scalable_hw_agnostic_inference_tpu.models import t5 as jt5
from scalable_hw_agnostic_inference_tpu.models import vae as jvae
from scalable_hw_agnostic_inference_tpu.models.flow_match import (
    FlowMatchConfig as JFlowMatchConfig,
)
from scalable_hw_agnostic_inference_tpu.models.flux_pipeline import (
    FluxPipeline as JFluxPipeline,
)
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.parallel.sharding import shard_pytree
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.core.budget import (
    GIB,
    HbmBudgetError,
    module_shapes,
    rank_budget,
)
from scalable_hw_agnostic_inference_tpu_torch.models import flux as pflux
from scalable_hw_agnostic_inference_tpu_torch.models import imageio
from scalable_hw_agnostic_inference_tpu_torch.models import t5 as pt5
from scalable_hw_agnostic_inference_tpu_torch.models.encoder import (
    Dense,
    row_linear,
)
from scalable_hw_agnostic_inference_tpu_torch.models.flux_pipeline import (
    FluxPipeline,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.loopback import (
    LoopbackGroup,
    run_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.sharding import (
    ShardSpec,
    gather_shards,
    sectioned,
    shard_shape,
    shard_state_dict,
    shard_tensor,
    stream_shard,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.__main__ import (
    wants_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.multihost import (
    start_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
from scalable_hw_agnostic_inference_tpu_torch.serve.units import (
    flux as uflux,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units import t5 as ut5
from scalable_hw_agnostic_inference_tpu_torch.serve.units.common import (
    unit_layout,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import multihost_cases as cases  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

#: the sharded fp32 forwards' tolerance (``tests/test_models_llama.py``'s,
#: ``tests/test_torch_sharding.py``'s), also the embeddings': values of
#: order 1, sums taken in another order over the ranks
TP_ATOL = 2e-4
#: the tiny flux images at tp=2 against tp=1, every stage fp32: at most
#: one uint8 level (a value within rounding of a .5 boundary rounds
#: either way)
IMAGE_LEVELS = 1
STEPS = 2
BOOT_S = 120.0
TINY = dict(model_id="tiny", device="cpu", num_inference_steps=STEPS)
TEXTS = ["hello embeddings", "something else entirely, longer"]
FLUX_OK = {"prompt": "a watercolor fox", "seed": 3}
FLUX_400 = [{"prompt": "x", "steps": 3}, {"prompt": "x", "steps": "many"}]


def _draw(shapes, seed):
    """Numpy draws of a flax tree: kernels N(0, 1/fan_in), embeddings
    N(0, 1), norm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name in ("scale", "q_scale", "k_scale"):
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(
                float(np.prod(s.shape[:-1])))
        elif name == "bias":
            a = 0.1 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _mesh(tp):
    return build_mesh(f"tp={tp}", devices=jax.devices()[:tp])


def _loopback(tp, make, call):
    """``call(make(rank, group))`` on each rank of a ``tp``-rank loopback
    group, under inference mode; the ranks' results in rank order."""
    group = LoopbackGroup(tp)
    with torch.inference_mode():
        return run_ranks(lambda r: call(make(r, group)), group)


# -- the sectioned splits ------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_sections_round_trip_and_biases(tp):
    """A fused ``[3h + m, h]`` weight and its bias cut per section: rank r
    holds slice r of q, k, v and the MLP, and the pieces concatenate back;
    a row-parallel dense's bias is added once, after the sum."""
    h, m = 8, 32
    spec = sectioned(0, 1, 1, 1, 4)
    w = torch.arange((3 * h + m) * 3, dtype=torch.float32).reshape(-1, 3)
    b = torch.arange(3 * h + m, dtype=torch.float32)
    for t in (w, b):
        parts = [shard_tensor("w", t, spec, tp, r) for r in range(tp)]
        assert torch.equal(gather_shards(parts, spec), t)
        for r, p in enumerate(parts):
            want = torch.cat([t[s + r * k // tp: s + (r + 1) * k // tp]
                              for s, k in ((0, h), (h, h), (2 * h, h),
                                           (3 * h, m))])
            assert torch.equal(p, want)
    assert shard_shape("w", w.shape, spec, tp) == ((3 * h + m) // tp, 3)
    with pytest.raises(ValueError, match="sections .* not divisible"):
        shard_shape("w", (3 * 6, 3), sectioned(0, 1, 1, 1), 4)
    with pytest.raises(ValueError, match="proportions"):
        shard_shape("w", (7, 3), sectioned(0, 1, 1, 1), 1)
    # a row-parallel dense over the ranks: its bias added once
    rng = np.random.default_rng(tp)
    dense = Dense(4 * tp, 5, True, torch.float32, "cpu")
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(rng.standard_normal((5, 4 * tp))))
        dense.bias.copy_(torch.from_numpy(rng.standard_normal(5)))
    x = torch.from_numpy(rng.standard_normal((2, 4 * tp)).astype(np.float32))
    spec = ShardSpec(1)

    def make(r, group):
        part = Dense(4, 5, True, torch.float32, "cpu")
        with torch.no_grad():
            part.weight.copy_(shard_tensor("w", dense.weight, spec, tp, r))
            part.bias.copy_(dense.bias)
        return part, x[:, r * 4:(r + 1) * 4], group

    outs = _loopback(tp, make, lambda a: row_linear(*a))
    with torch.inference_mode():
        want = dense(x)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)


def test_flux_table_splits_column_biases_and_keeps_row_biases():
    rules = pflux.tp_rules(pflux.FluxConfig.tiny())
    assert rules.spec_for("double_0.txt_qkv.bias", 1) == sectioned(0, 1, 1, 1)
    assert rules.spec_for("double_1.img_mlp1.bias", 1) == ShardSpec(0)
    assert rules.spec_for("single_0.linear1.bias", 1) == \
        sectioned(0, 1, 1, 1, 4)
    for name in ("double_0.img_proj.bias", "double_0.txt_mlp2.bias",
                 "single_0.linear2.bias", "single_0.mod.bias",
                 "double_0.img_qknorm.q_scale", "final_proj.bias"):
        assert rules.spec_for(name, 1) == ShardSpec(None), name


# -- the rank-local forwards ---------------------------------------------------

@pytest.fixture(scope="module")
def t5_case():
    jcfg = jt5.T5Config.tiny()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    model = jt5.T5Encoder(jcfg)
    tree = _draw(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.asarray(ids), jnp.asarray(mask)), 3)
    want = {tp: np.asarray(jax.jit(model.apply)(
        shard_pytree(tree, _mesh(tp), jt5.tp_rules()), ids, mask))
        for tp in (2, 4)}
    pcfg = pt5.T5Config(**dataclasses.asdict(jcfg))
    state = pt5.params_from_jax(tree)
    with torch.inference_mode():
        one = pt5.build(pcfg, state)(torch.from_numpy(ids),
                                     torch.from_numpy(mask)).numpy()
    return pcfg, state, ids, mask, one, want


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_local_t5_equals_tp1_and_the_jax_sharded_forward(t5_case, tp):
    pcfg, state, ids, mask, one, want = t5_case

    def make(r, group):
        return pt5.build(pcfg, shard_state_dict(state, pt5.tp_rules(), tp, r),
                         group=group)

    outs = _loopback(tp, make, lambda m: m(torch.from_numpy(ids),
                                           torch.from_numpy(mask)))
    for out in outs:
        assert torch.equal(out, outs[0])
        np.testing.assert_allclose(out.numpy(), one, atol=TP_ATOL)
        np.testing.assert_allclose(out.numpy(), want[tp], atol=TP_ATOL)


def _flux_args(cfg, B=1, Lt=4, h=8, w=8, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, (h // 2) * (w // 2), cfg.in_channels)),
            rng.standard_normal((B, Lt, cfg.t5_dim)),
            rng.standard_normal((B, cfg.clip_dim)),
            rng.uniform(size=(B,)), np.full((B,), 3.5),
            np.asarray(jflux.make_ids(B, Lt, h, w)))


@pytest.fixture(scope="module")
def flux_case():
    jcfg = jflux.FluxConfig.tiny()
    args = [np.asarray(a, np.int32 if i == 5 else np.float32)
            for i, a in enumerate(_flux_args(jcfg))]
    model = jflux.FluxTransformer(jcfg, dtype=jnp.float32)
    tree = _draw(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                *args), 4)
    want = {tp: np.asarray(jax.jit(model.apply)(
        shard_pytree(tree, _mesh(tp), jflux.tp_rules()), *args))
        for tp in (2, 4)}
    pcfg = pflux.FluxConfig(**dataclasses.asdict(jcfg))
    state = pflux.params_from_jax(tree)
    targs = [torch.from_numpy(a.copy()) for a in args]
    with torch.inference_mode():
        one = pflux.build(pcfg, state, dtype=torch.float32)(*targs).numpy()
    return pcfg, tree, state, targs, one, want


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_local_flux_equals_tp1_and_the_jax_sharded_forward(flux_case,
                                                                 tp):
    pcfg, _, state, targs, one, want = flux_case

    def make(r, group):
        return pflux.build(pcfg, shard_state_dict(
            state, pflux.tp_rules(pcfg), tp, r), dtype=torch.float32,
            group=group)

    outs = _loopback(tp, make, lambda m: m(*targs))
    for out in outs:
        assert torch.equal(out, outs[0])
        np.testing.assert_allclose(out.numpy(), one, atol=TP_ATOL)
        np.testing.assert_allclose(out.numpy(), want[tp], atol=TP_ATOL)


def test_two_rank_denoise_equals_the_jax_pipeline_on_a_submesh(flux_case):
    """The port's denoise over two ranks, given the JAX run's latents
    (``jax.random.normal`` of the seed's key) and conditioning, against
    the JAX pipeline's denoise with its transformer on a 2-device
    submesh."""
    pcfg, tree, state, _, _, _ = flux_case
    jcfg = jflux.FluxConfig.tiny()
    mesh = _mesh(2)
    jpipe = JFluxPipeline(jcfg, shard_pytree(tree, mesh, jflux.tp_rules()),
                          jvae.VAEConfig.tiny(), None, None, None,
                          schedule=JFlowMatchConfig(), dtype=jnp.float32,
                          mesh=mesh)
    B, h, w, Lt, seed, guidance = 1, 8, 8, 4, 5, 3.5
    rng = np.random.default_rng(6)
    txt = rng.standard_normal((B, Lt, jcfg.t5_dim)).astype(np.float32)
    pooled = rng.standard_normal((B, jcfg.clip_dim)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jpipe._denoise_for(B, h, w, Lt, STEPS)(
        jpipe.params, jnp.asarray(txt), jnp.asarray(pooled), key,
        jnp.float32(guidance)))
    lat = torch.from_numpy(np.array(jax.random.normal(
        key, (B, h, w, jpipe.latent_ch), jnp.float32)))

    def make(r, group):
        model = pflux.build(pcfg, shard_state_dict(
            state, pflux.tp_rules(pcfg), 2, r), dtype=torch.float32,
            group=group)
        return FluxPipeline(model, None, None, None, group=group,
                            vae_scale=2)

    outs = _loopback(2, make, lambda p: p.denoise(
        lat, torch.from_numpy(txt), torch.from_numpy(pooled), STEPS,
        guidance))
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), want, atol=TP_ATOL)


# -- the units over two spawned ranks -----------------------------------------

def _http(url, payload=None, timeout=120.0):
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except (urllib.error.URLError, ConnectionError):
        return None, {}


def _served(cfg, service, route, payloads, ranked):
    """``service`` behind the stdlib server (over ranks through
    ``start_ranks``, this process rank 0): each payload's answer on
    ``route``, then, over ranks, the mirrored counts and the followers'
    exit codes after the shutdown."""
    fails = []
    ranks = start_ranks(cfg, service, on_fail=fails.append) if ranked \
        else None
    server = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = server.start_background()
    base = f"http://{host}:{port}"
    try:
        deadline = time.monotonic() + BOOT_S
        while _http(base + "/readiness")[0] != 200:
            assert time.monotonic() < deadline, _http(base + "/readiness")
            time.sleep(0.05)
        answers = [_http(base + route, p) for p in payloads]
    finally:
        server.stop()
        if ranks is not None:
            ranks.close()
    out = {"answers": answers}
    if ranks is not None:
        out.update(mirrored=ranks.mirrored, fails=fails,
                   exit=[p.exitcode for p in ranks.procs],
                   boot=[b["rank"] for b in ranks.boot])
    return out


def _strip(answer):
    status, body = answer
    return status, {k: v for k, v in body.items() if k != "latency_s"}


def _jax_t5_tp2():
    """The JAX ``t5`` unit at ``mesh_spec="tp=2"``, its flax init replaced
    by numpy draws; returns (the unit, the drawn tree)."""
    jservice = get_model("t5")(JServeConfig(app="t5", model_id="tiny",
                                            device="cpu", mesh_spec="tp=2"))
    orig, drawn = fnn.Module.init, {}

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kw),
                                rngs, *args)
        drawn["tree"] = _draw(shapes, 7)
        return drawn["tree"]

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Module, "init", init)
    try:
        jservice.load()
    finally:
        mp.undo()
    return jservice, jax.tree.map(np.asarray, drawn["tree"])


def _t5_payloads():
    return [{"text": t} for t in TEXTS] + [{}] + [{"text": TEXTS[0]}]


@pytest.fixture(scope="module")
def units():
    """Both units over two ranks, one after the other in a thread (a
    process holds one default group at a time), while this thread runs
    the JAX unit and the port's units at tp=1."""
    jservice, tree = _jax_t5_tp2()
    carried = cases.CarriedT5(tree)
    t5_cfg = ServeConfig(app="t5", mesh_spec="tp=2", **TINY)
    flux_cfg = ServeConfig(app="flux", submesh="0:2", **TINY)
    flux_payloads = [FLUX_OK] + FLUX_400 + [FLUX_OK]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranked = pool.submit(lambda: (
            _served(t5_cfg, UNITS["t5"](t5_cfg, weights=carried), "/embed",
                    _t5_payloads(), True),
            _served(flux_cfg, UNITS["flux"](flux_cfg), "/genimage",
                    flux_payloads, True)))
        jax_embed = [jservice.infer(p) for p in _t5_payloads()[:2]]
        one_cfg = ServeConfig(app="t5", **TINY)
        one = UNITS["t5"](one_cfg, weights=carried)
        one.load()
        t5_one = [one.infer(p) for p in _t5_payloads()[:2]]
        fcfg = ServeConfig(app="flux", **TINY)
        fone = UNITS["flux"](fcfg)
        fone.load()
        flux_one = fone.infer(FLUX_OK)
        t5_two, flux_two = ranked.result()
    return {"t5": t5_two, "flux": flux_two, "jax_embed": jax_embed,
            "t5_one": t5_one, "flux_one": flux_one}


def test_t5_tp2_embeds_as_tp1_and_the_jax_unit_at_tp2(units):
    answers = units["t5"]["answers"]
    for i in range(2):
        status, body = answers[i]
        assert status == 200, body
        assert body["dim"] == units["t5_one"][i]["dim"] == 32
        np.testing.assert_allclose(body["embedding"],
                                   units["t5_one"][i]["embedding"],
                                   atol=TP_ATOL)
        np.testing.assert_allclose(body["embedding"],
                                   units["jax_embed"][i]["embedding"],
                                   atol=TP_ATOL)
    # the 400 on both ranks, and the follower served on after it
    assert answers[2][0] == 400
    assert _strip(answers[3]) == _strip(answers[0])


def test_t5_tp2_mirrors_every_call(units):
    t5 = units["t5"]
    # the warmup and the four requests, the 400 among them
    assert t5["mirrored"] == [{"infer": 5}] * 2
    assert t5["fails"] == [] and t5["exit"] == [0] and t5["boot"] == [0, 1]


def _pixels(body):
    import base64

    return imageio.decode_png(base64.b64decode(body["image_b64"])).astype(
        np.int32)


def test_flux_over_two_ranks_draws_the_tp1_image(units):
    answers = units["flux"]["answers"]
    status, body = answers[0]
    assert status == 200, body
    want = units["flux_one"]
    assert {k: body[k] for k in ("steps", "height", "width")} == \
        {k: want[k] for k in ("steps", "height", "width")}
    assert np.abs(_pixels(body) - _pixels(want)).max() <= IMAGE_LEVELS
    # the steps value outside the set and the bad knob: 400s on both
    # ranks before any device work; the follower serves on after them
    assert [a[0] for a in answers[1:3]] == [400, 400]
    assert "STEPS_BUCKETS" in json.dumps(answers[1][1])
    assert _strip(answers[3]) == _strip(answers[0])


def test_flux_over_two_ranks_mirrors_every_call(units):
    flux = units["flux"]
    assert flux["mirrored"] == [{"warmup": 1, "infer": 4}] * 2
    assert flux["fails"] == [] and flux["exit"] == [0]
    assert flux["boot"] == [0, 1]


# -- the refusals, before any rank starts ---------------------------------------

def _env(monkeypatch, processes):
    monkeypatch.setenv("SHAI_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SHAI_NUM_PROCESSES", str(processes))
    monkeypatch.setenv("SHAI_PROCESS_ID", "0")


def test_several_hosts_and_a_bad_tp_are_refused_before_any_rank(
        monkeypatch):
    for k in ("SHAI_COORDINATOR", "SHAI_NUM_PROCESSES", "SHAI_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    before = multiprocessing.active_children()
    cases_ = [("t5", {"mesh_spec": "tp=2"}), ("flux", {"submesh": "0:2"})]
    _env(monkeypatch, 2)
    for name, spec in cases_:
        cfg = ServeConfig(app=name, **{**TINY, **spec})
        with pytest.raises(ValueError, match="SHAI_NUM_PROCESSES=2 .*does "
                           "not declare supports_multihost"):
            start_ranks(cfg, UNITS[name](cfg))
    for k in ("SHAI_COORDINATOR", "SHAI_NUM_PROCESSES", "SHAI_PROCESS_ID"):
        monkeypatch.delenv(k)
    for name, spec in (("t5", {"mesh_spec": "tp=3"}),
                       ("flux", {"submesh": "0:3"})):
        cfg = ServeConfig(app=name, **{**TINY, **spec})
        with pytest.raises(ValueError, match="tp=3: tp must divide "
                           "heads=4"):
            start_ranks(cfg, UNITS[name](cfg))
    assert multiprocessing.active_children() == before
    # the published widths: T5-XXL's 64 heads, FLUX.1's 24
    with pytest.raises(ValueError, match="heads=64"):
        pt5.check_tp(pt5.T5Config.t5_v1_1_xxl(), 3)
    with pytest.raises(ValueError, match="heads=24"):
        pflux.check_tp(pflux.FluxConfig(), 16)
    for tp in (2, 4, 6, 8):
        pflux.check_tp(pflux.FluxConfig(), tp)
    # and in the module itself, before anything is allocated
    with pytest.raises(ValueError, match="heads=4"):
        pflux.FluxTransformer(pflux.FluxConfig.tiny(), device="meta",
                              group=LoopbackGroup(3))


def test_layouts_and_the_entry_points_choice(monkeypatch):
    for k in ("SHAI_COORDINATOR", "SHAI_NUM_PROCESSES", "SHAI_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    t5_cfg = ServeConfig(app="t5", mesh_spec="tp=2", **TINY)
    flux_cfg = ServeConfig(app="flux", submesh="0:2", **TINY)
    assert unit_layout(t5_cfg, ranks_over="MESH_SPEC")[1].tp == 2
    assert unit_layout(flux_cfg, ranks_over="SUBMESH")[1].tp == 2
    assert wants_ranks(t5_cfg, UNITS["t5"](t5_cfg))
    assert wants_ranks(flux_cfg, UNITS["flux"](flux_cfg))
    plain = ServeConfig(app="flux", **TINY)
    # SUBMESH unset on the CPU: one device, as before
    assert not wants_ranks(plain, UNITS["flux"](plain))
    assert not unit_layout(plain, ranks_over="SUBMESH")[1].ranked
    with pytest.raises(ValueError, match="serve_multihost"):
        UNITS["flux"](flux_cfg).load()
    # a coordinator with one process: a group of one through the env path
    _env(monkeypatch, 1)
    for cfg, over in ((ServeConfig(app="t5", **TINY), "MESH_SPEC"),
                      (plain, "SUBMESH")):
        layout = unit_layout(cfg, ranks_over=over)[1]
        assert layout.ranked and layout.tp == 1 and layout.coordinator
        assert wants_ranks(cfg, UNITS[cfg.app](cfg))


# -- the per-rank price ------------------------------------------------------------

def test_a_rank_is_priced_as_it_places(monkeypatch):
    """``rank_budget``'s parameter bytes are the bytes each rank places;
    the flux leader's price holds the encoders and the VAE where they
    share its device; a load that cannot fit is refused before a weight is
    read."""
    for mcfg, module, rules in (
            (pt5.T5Config.tiny(), pt5.T5Encoder, pt5.tp_rules()),
            (pflux.FluxConfig.tiny(), pflux.FluxTransformer,
             pflux.tp_rules(pflux.FluxConfig.tiny()))):
        whole = module(mcfg, device="meta")
        state = {k: torch.zeros(v.shape) for k, v in
                 whole.state_dict().items()}
        for tp in (1, 2, 4):
            price = rank_budget(module_shapes(whole), rules, tp, what="x",
                                dtype="float32", act_bytes=0.0,
                                hbm_gib_per_chip=1.0).params_gib * GIB
            for r in range(tp):
                shard = stream_shard(iter(state.items()), rules, tp, r, "cpu")
                assert sum(t.numel() * 4 for t in shard.values()) == price
    monkeypatch.setenv("SHAI_ENFORCE_HBM", "1")
    monkeypatch.setenv("SHAI_HBM_GIB", "64")
    service = UNITS["flux"](ServeConfig(app="flux", **TINY))
    service.load()
    pipe = service.pipe
    mods = (pipe.model, pipe.vae, pipe.t5_encode.__closure__[0].cell_contents,
            pipe.clip_pooled.__closure__[0].cell_contents)
    held = sum(p.numel() * 4 for m in mods for p in m.parameters())
    assert service.hbm_budget.params_gib * GIB == held
    monkeypatch.setenv("SHAI_HBM_GIB", "0.00001")

    def read(*args, **kw):
        raise AssertionError("a weight read before the price")

    for name, unit_mod in (("t5", ut5), ("flux", uflux)):
        monkeypatch.setattr(unit_mod, "stream_shard", read)
        with pytest.raises(HbmBudgetError, match="'tiny' tp=1"):
            UNITS[name](ServeConfig(app=name, **TINY)).load()


def test_a_diffusers_snapshot_is_read_one_entry_at_a_time():
    """``flux.state_items`` over the diffusers layout reads an entry's
    diffusers tensors only when that entry is taken, and its entries are
    the eager converter's."""
    from test_torch_flux import diffusers_from_bfl

    cfg = pflux.FluxConfig.tiny()
    model = pflux.seeded(cfg, 1, dtype=torch.float32, device="cpu")
    bfl = {v: model.state_dict()[k] for k, v in pflux.bfl_names(cfg).items()}
    diff = diffusers_from_bfl(bfl, cfg)
    reads = []

    def get(name):
        reads.append(name)
        return diff[name]

    items = pflux.state_items(get, cfg, diff.keys())
    assert reads == []
    eager = pflux.state_from_bfl(diff.__getitem__, cfg, diff.keys())
    seen = 0
    for name, t in items:
        assert torch.equal(t, eager[name]), name
        assert len(reads) > seen and len(reads) - seen <= 4
        seen = len(reads)
    assert set(reads) == set(diff)
