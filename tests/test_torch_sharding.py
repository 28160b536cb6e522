"""The port's tensor-parallel plan (``parallel/sharding.py``,
``parallel/loopback.py``, ``models/llama.py``'s ``tp_rules``,
``cache_specs``, ``replicate_kv_heads`` and rank-local modules,
``engine/runner.py``'s ``EngineShardings``, Flux's and T5's tables) held
against the JAX package on the CPU.

- the rule tables, rule for rule: for every name of the tiny Llama state
  dicts (tied, untied, int8, mllama with a cross layer) and of the tiny
  T5 one, the port's split dim is the reference's spec on the matching
  flax path, transposed for a ``[out, in]`` weight; Flux's as rank-local
  placements (the weights split where the reference's are, fused ones
  per section, column-parallel biases with their outputs, every rank's
  pieces concatenating back to the reference's tensors);
- ``shard_state_dict``'s rank ``r`` is the shard the reference's
  ``shard_pytree`` puts on mesh position ``r``, value for value;
- ``replicate_kv_heads`` widens the weights as the reference does (bit for
  bit) and leaves the fp32 logits equal to the unwidened model's; the
  no-op and the bad factor;
- ``EngineShardings``' refusal is the reference's message, its per-rank
  counts the manifests' shapes; the engine refuses a tp without a group
  of that size, and a unit refuses tp ranks without one (on one device
  (ROADMAP A7.3c), or outside ``serve_multihost``);
- the rank-local fp32 forward at tp 2 and 4 (4 through widening) over
  ``LoopbackGroup``, for the tied tiny, an untied tiny and its int8
  weights: within 2e-4 of the port's unsharded forward and of the JAX
  package's sharded forward on the 8 virtual devices (``shard_pytree`` +
  jit, ``tests/test_models_llama.py``'s tolerance); the dense-cache
  prefill and decode steps at tp 2 equal the unsharded ones;
- the loopback group's collectives (rank order, one rank running at a
  time, a failing rank releasing the others) and the kernel wrappers'
  launch counter under contending threads.
"""

import dataclasses
import sys
import threading
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_hw_agnostic_inference_tpu.core.mesh import build_mesh
from scalable_hw_agnostic_inference_tpu.engine import runner as jrunner
from scalable_hw_agnostic_inference_tpu.models import flux as jflux
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.models import t5 as jt5
from scalable_hw_agnostic_inference_tpu.ops.quant import quantize_params_tree
from scalable_hw_agnostic_inference_tpu.parallel.sharding import shard_pytree
from scalable_hw_agnostic_inference_tpu_torch.engine import engine as pengine
from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
    EngineConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.runner import (
    EngineShardings,
)
from scalable_hw_agnostic_inference_tpu_torch.models import flux as pflux
from scalable_hw_agnostic_inference_tpu_torch.models import llama as pllama
from scalable_hw_agnostic_inference_tpu_torch.models import t5 as pt5
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import _build
from scalable_hw_agnostic_inference_tpu_torch.parallel.loopback import (
    LoopbackGroup,
    run_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.sharding import (
    ShardingRules,
    ShardSpec,
    gather_shards,
    shard_state_dict,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units.common import (
    unit_device,
    unit_layout,
    unit_ranks,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_imports import _forbidden_imports, _modules  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

#: tests/test_models_llama.py's sharded-forward tolerance
TP_ATOL = 2e-4


def _split_dim(spec) -> "int | None":
    """The dim a reference ``PartitionSpec`` splits on ``tp`` (or None)."""
    dims = [i for i, ax in enumerate(spec) if ax == "tp"]
    assert len(dims) <= 1
    return dims[0] if dims else None


def _leaves(tree):
    return [(tuple(str(k.key) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _check_table(flax_tree, jrules, prules, port_names, port_name_of):
    """Every flax leaf's port name exists, and its split dim is the
    reference's (transposed for a 2-D kernel); every port name is met."""
    seen = set()
    for path, leaf in _leaves(flax_tree):
        name = port_name_of(path)
        assert name in port_names, (path, name)
        seen.add(name)
        ref = _split_dim(jrules.spec_for("/".join(path), ndim=leaf.ndim))
        got = prules.spec_for(name, ndim=leaf.ndim).dim
        if ref is not None and path[-1] in ("kernel", "kernel_q"):
            assert leaf.ndim == 2
            ref = 1 - ref
        assert got == ref, (path, name, got, ref)
    assert seen == set(port_names)


# -- the rule tables ----------------------------------------------------------

def _llama_name(path) -> str:
    """A flax Llama path -> the port's state-dict name."""
    parts = [p for p in path if p != "params"]
    if parts[0].startswith("layer_"):
        parts[0] = "layers." + parts[0][len("layer_"):]
    leaf = {"kernel": "weight", "kernel_q": "weight_q",
            "embedding": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts[:-1] + [leaf])


LLAMA_KINDS = {
    "tied": (dict(), False),
    "untied": (dict(tie_embeddings=False), False),
    "int8": (dict(tie_embeddings=False), True),
    "mllama": (dict(tie_embeddings=False, cross_attention_layers=(1,)),
               False),
    "mllama-int8": (dict(tie_embeddings=False, cross_attention_layers=(1,)),
                    True),
}


@pytest.mark.parametrize("kind", list(LLAMA_KINDS))
def test_llama_rules_match_the_reference(kind):
    fields, quant = LLAMA_KINDS[kind]
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **fields)
    pcfg = dataclasses.replace(pllama.LlamaConfig.tiny(), **fields)
    tree = jax.eval_shape(lambda: jllama.geometry_params(jcfg, jnp.float32,
                                                         quant=quant))
    names = pllama.geometry_params(pcfg, torch.float32, device="cpu",
                                   quant=quant)
    _check_table(tree, jllama.tp_rules(), pllama.tp_rules(), list(names),
                 _llama_name)


def _flax_name(path, bare=()) -> str:
    """``models.encoder.state_from_flax``'s naming: ``kernel``, ``scale``
    and ``embedding`` become ``weight``; ``bare`` names a module whose
    table is a bare parameter in the port."""
    parts = [p for p in path if p != "params"]
    leaf = parts[-1]
    if leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    if parts[:-1] and parts[-2] in bare:
        return parts[-2]
    return ".".join(parts[:-1] + [leaf])


def test_flux_rules_match_the_reference():
    """Flux's table as rank-local placements: every weight is split on the
    dim the reference's spec splits (transposed for a kernel), a bias
    splits with a column-parallel output where the reference replicates
    it (its GSPMD reshards it) and stays whole beside a row-parallel one;
    at tp 2 and 4 the ranks' pieces of every entry concatenate back,
    section by section, to the reference's tensor, and a fused weight's
    piece is the rank's slice of each section (q, k, v and the MLP each
    cut by the rank's heads or slice)."""
    jcfg = dataclasses.replace(jflux.FluxConfig.tiny(), guidance_embed=True)
    B, Li, Lt = 1, 16, 4
    args = (jnp.zeros((B, Li, jcfg.in_channels)),
            jnp.zeros((B, Lt, jcfg.t5_dim)), jnp.zeros((B, jcfg.clip_dim)),
            jnp.zeros((B,)), jnp.zeros((B,)),
            jnp.zeros((B, Lt + Li, 3), jnp.int32))
    tree = jax.eval_shape(jflux.FluxTransformer(jcfg).init,
                          jax.random.PRNGKey(0), *args)
    pcfg = pflux.FluxConfig(**dataclasses.asdict(jcfg))
    prules, jrules = pflux.tp_rules(pcfg), jflux.tp_rules()
    names = pflux.FluxTransformer(pcfg, device="meta").state_dict()
    rng = np.random.default_rng(0)
    drawn = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), tree)
    state = pflux.params_from_jax(drawn)
    assert set(state) == set(names)
    weight_dim = {}
    for path, leaf in _leaves(tree):
        name = _flax_name(path)
        ref = _split_dim(jrules.spec_for("/".join(path), ndim=leaf.ndim))
        if path[-1] == "kernel" and ref is not None:
            weight_dim[name[: -len(".weight")]] = 1 - ref
    for path, leaf in _leaves(tree):
        name = _flax_name(path)
        spec = prules.spec_for(name, ndim=leaf.ndim)
        stem, leafname = name.rsplit(".", 1)
        if path[-1] == "kernel":
            assert spec.dim == weight_dim.get(stem), (name, spec)
        elif path[-1] == "bias":
            # the reference replicates every bias
            assert _split_dim(jrules.spec_for("/".join(path), 1)) is None
            want = 0 if weight_dim.get(stem) == 0 else None
            assert spec.dim == want, (name, spec)
        else:
            assert spec.dim is None, (name, spec)
        for tp in (2, 4):
            parts = [shard_state_dict({name: state[name]}, prules, tp, r)[
                name] for r in range(tp)]
            assert torch.equal(gather_shards(parts, spec), state[name])
            if spec.sections:
                sizes = spec.section_sizes(state[name].shape[spec.dim])
                for r, part in enumerate(parts):
                    at, mine = 0, []
                    for k in sizes:
                        mine.append(state[name].narrow(
                            spec.dim, at + r * k // tp, k // tp))
                        at += k
                    assert torch.equal(part, torch.cat(mine, spec.dim))
    # the fused weights are the ones cut per section
    assert prules.spec_for("double_0.img_qkv.weight").sections == (1, 1, 1)
    assert prules.spec_for("single_1.linear1.bias").sections == (1, 1, 1, 4)
    assert prules.spec_for("single_1.linear2.weight") == ShardSpec(1, (1, 4))


def test_t5_rules_match_the_reference():
    jcfg = jt5.T5Config.tiny()
    tree = jax.eval_shape(jt5.T5Encoder(jcfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32),
                          jnp.ones((1, 8), jnp.int32))
    pcfg = pt5.T5Config(**dataclasses.asdict(jcfg))
    names = pt5.T5Encoder(pcfg, device="meta").state_dict()
    _check_table(tree, jt5.tp_rules(), pt5.tp_rules(), list(names),
                 lambda p: _flax_name(p, bare=("embed", "rel_bias")))


def test_spec_rank_check_and_first_match():
    rules = ShardingRules([(r"a\.weight", ShardSpec(1)),
                           (r"weight", ShardSpec(0))])
    assert rules.spec_for("a.weight", ndim=2) == ShardSpec(1)
    assert rules.spec_for("b.weight", ndim=2) == ShardSpec(0)
    assert rules.spec_for("b.bias", ndim=1) == ShardSpec(None)
    with pytest.raises(ValueError, match="splits dim 1"):
        rules.spec_for("a.weight", ndim=1)
    assert rules.state_specs({"a.weight": torch.zeros(2, 2),
                              "c": torch.zeros(3)}) == {
        "a.weight": ShardSpec(1), "c": ShardSpec(None)}


# -- weights: the JAX tree, numpy-drawn --------------------------------------

def _jax_tree(cfg, seed: int, quant: bool):
    """A numpy-drawn flax Llama tree of ``cfg``'s shapes (kernels N(0,
    1/fan_in), embeddings N(0, 1), norm scales 1 + N(0, 0.1)); with
    ``quant`` the JAX package's int8 conversion of it."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jllama.geometry_params(cfg, jnp.float32))

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        else:
            a = rng.standard_normal(s.shape)
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    if quant:
        tree = jax.tree_util.tree_map(np.asarray,
                                      jax.jit(quantize_params_tree)(tree))
    return tree


def _widen(tree, cfg, tp):
    """The JAX package's ``replicate_kv_heads`` (compiled whole: one
    compile, not one a primitive), numpy leaves."""
    out = {}

    def widen(t):
        wide, out["cfg"] = jllama.replicate_kv_heads(t, cfg, tp)
        return wide

    wide = jax.jit(widen)(tree)
    return jax.tree_util.tree_map(np.asarray, wide), out["cfg"]


def test_shard_state_dict_is_the_reference_shard_pytree():
    """Rank ``r``'s tensors are the shards the reference places on mesh
    position ``r`` (transposed for ``[out, in]`` weights), int8 weights
    and their scales included; split shards own their storage and
    replicated entries are the full tensors."""
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), tie_embeddings=False)
    pcfg = dataclasses.replace(pllama.LlamaConfig.tiny(), tie_embeddings=False)
    tree = _jax_tree(cfg, 1, quant=True)
    tp = 2
    sharded = shard_pytree(tree, build_mesh(f"tp={tp}"), jllama.tp_rules())
    state = pllama.params_from_jax(tree, pcfg)
    ranks = [shard_state_dict(state, pllama.tp_rules(), tp, r)
             for r in range(tp)]
    mesh_devices = list(build_mesh(f"tp={tp}").devices.flat)
    for path, arr in _leaves(sharded):
        name = _llama_name(path)
        for shard in arr.addressable_shards:
            r = mesh_devices.index(shard.device)
            want = np.asarray(shard.data)
            if path[-1] in ("kernel", "kernel_q"):
                want = want.T
            np.testing.assert_array_equal(ranks[r][name].numpy(), want)
    for name, t in state.items():
        spec = pllama.tp_rules().spec_for(name, t.dim())
        for r in range(tp):
            if spec.dim is None:
                assert ranks[r][name] is t
            else:
                assert ranks[r][name].untyped_storage().data_ptr() != \
                    t.untyped_storage().data_ptr()
                assert ranks[r][name].is_contiguous()
    with pytest.raises(ValueError, match="illegal sharding"):
        shard_state_dict(state, pllama.tp_rules(), 3, 0)
    with pytest.raises(ValueError, match="outside"):
        shard_state_dict(state, pllama.tp_rules(), 2, 2)


# -- replicated GQA heads -----------------------------------------------------

def test_replicate_kv_heads_equals_the_reference_and_keeps_the_logits():
    """Widening is the reference's, bit for bit (float and int8 weights).
    The widened model's fp32 logits equal the unwidened model's to 1e-6
    (not bit for bit as the reference asserts: the plain attention groups
    the query heads over 4 kv heads instead of 2, and the k/v projections
    are 128-row products instead of 64-row ones, so the CPU's GEMM may
    block the same sums another way)."""
    jcfg = jllama.LlamaConfig.tiny()          # 4 query heads over 2
    pcfg = pllama.LlamaConfig.tiny()
    for quant in (False, True):
        tree = _jax_tree(jcfg, 2, quant)
        wide_tree, wide_jcfg = _widen(tree, jcfg, 4)
        state = pllama.params_from_jax(tree, pcfg)
        wide, wide_cfg = pllama.replicate_kv_heads(state, pcfg, 4)
        assert wide_cfg == dataclasses.replace(pcfg, n_kv_heads=4)
        want = pllama.params_from_jax(wide_tree, wide_cfg)
        assert wide.keys() == want.keys()
        for name in want:
            assert torch.equal(wide[name], want[name]), name
    ids = torch.tensor([[5, 9, 17, 3, 1, 8]])
    state = pllama.params_from_jax(_jax_tree(jcfg, 2, False), pcfg)
    wide, wide_cfg = pllama.replicate_kv_heads(state, pcfg, 4)
    with torch.inference_mode():
        ref = pllama.LlamaForCausalLM.from_state_dict(
            pcfg, state, dtype=torch.float32)(ids)
        out = pllama.LlamaForCausalLM.from_state_dict(
            wide_cfg, wide, dtype=torch.float32)(ids)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    same, same_cfg = pllama.replicate_kv_heads(state, pcfg, 2)
    assert same is state and same_cfg is pcfg
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        pllama.replicate_kv_heads(state, pcfg, 3)
    with pytest.raises(ValueError):
        jllama.replicate_kv_heads(_jax_tree(jcfg, 2, False), jcfg, 3)


# -- the engine's plan --------------------------------------------------------

def test_engine_shardings_refusal_is_the_reference_message():
    jcfg, pcfg = jllama.LlamaConfig.tiny(), pllama.LlamaConfig.tiny()
    tree = jax.eval_shape(lambda: jllama.geometry_params(jcfg, jnp.float32))
    with pytest.raises(ValueError) as want:
        jrunner.EngineShardings(build_mesh("tp=4"), tree, jcfg)
    with pytest.raises(ValueError) as got:
        EngineShardings(pcfg, 4)
    assert str(got.value) == str(want.value).replace(
        "(params, cfg, tp) — the serve layer does this automatically "
        "(units/vllm.py)", "(state, cfg, tp)")


def test_engine_shardings_per_rank_shapes():
    """The manifests' per-rank shapes: Meta-Llama-3-8B and Mistral-7B at
    tp 2, 4, 8; Llama-3-70B at 16 and DeepSeek-R1-Distill-Llama-70B at 32,
    kv heads widened to tp."""
    want = {("llama3_8b", 2): (16, 4), ("llama3_8b", 4): (8, 2),
            ("llama3_8b", 8): (4, 1), ("mistral_7b", 4): (8, 2),
            ("llama3_70b", 16): (4, 1), ("llama3_70b", 32): (2, 1)}
    for (preset, tp), heads in want.items():
        cfg = getattr(pllama.LlamaConfig, preset)()
        if tp > cfg.n_kv_heads:
            cfg = dataclasses.replace(cfg, n_kv_heads=tp)
        plan = EngineShardings(cfg, tp)
        assert (plan.n_heads, plan.n_kv_heads, plan.head_dim) == heads + (
            128,)
        jcfg = dataclasses.replace(getattr(jllama.LlamaConfig, preset)(),
                                   n_kv_heads=cfg.n_kv_heads)
        jspec = jllama.cache_specs(jcfg, axis_size=tp)["k"]
        assert plan.kv_layer["k"].dim == _split_dim(jspec) == 2
    shapes = EngineShardings(pllama.LlamaConfig.llama3_8b(),
                             4).projection_shapes()
    assert shapes == {"q": (1024, 4096), "k": (256, 4096),
                      "v": (256, 4096), "o": (4096, 1024),
                      "gate": (3584, 4096), "up": (3584, 4096),
                      "down": (4096, 3584), "lm_head": (32064, 4096)}
    cfg70 = dataclasses.replace(pllama.LlamaConfig.llama3_70b(),
                                n_kv_heads=32)
    s70 = EngineShardings(cfg70, 32).projection_shapes()
    assert (s70["q"], s70["k"], s70["o"], s70["gate"], s70["down"],
            s70["lm_head"]) == ((256, 8192), (128, 8192), (8192, 256),
                                (896, 8192), (8192, 896), (4008, 8192))
    assert pllama.cache_specs(pllama.LlamaConfig.llama3_70b(), 16)["k"] == \
        ShardSpec(None)


def test_engine_and_units_still_refuse_several_ranks():
    cfg = pllama.LlamaConfig.tiny()
    model = pllama.LlamaForCausalLM(cfg, dtype=torch.float32, device="cpu")
    ecfg = EngineConfig(max_model_len=256, context_encoding_buckets=(128,),
                        tensor_parallel_size=2, dtype="float32")
    # the engine serves tp ranks through a group (engine.ranks): without
    # one, a tp of 2 is refused
    with pytest.raises(ValueError, match="tensor_parallel_size=2 but the "
                       "engine's group has 1 rank.*parallel.distributed"):
        pengine.LLMEngine(cfg, model, ecfg, device="cpu")
    # a unit on one device refuses tp ranks (ROADMAP A7.3c); a unit that
    # serves them (supports_multihost) lays them out, and without the
    # group serve_multihost gives each rank, refuses to run on one
    cfg = types.SimpleNamespace(device="cpu", submesh=None,
                                mesh_spec="tp=4")
    with pytest.raises(ValueError, match="MESH_SPEC names 4 devices.*"
                       "A7.3c"):
        unit_device(cfg)
    assert unit_layout(cfg, multihost=True)[1].tp == 4
    with pytest.raises(ValueError, match="serve_multihost"):
        unit_ranks(cfg, multihost=True)


# -- the rank-local forward ---------------------------------------------------

FORWARD_KINDS = {"tied": (True, False), "untied": (False, False),
                 "int8": (False, True)}
IDS = np.array([[1, 5, 9, 13, 200, 7, 64], [3, 3, 8, 0, 511, 2, 9]],
               np.int32)


@pytest.fixture(scope="module", params=[
    (kind, tp) for kind in FORWARD_KINDS for tp in (2, 4)],
    ids=lambda p: f"{p[0]}-tp{p[1]}")
def sharded_case(request):
    """One configuration at one tp: the JAX package's sharded fp32 forward
    (compiled once), the port's unsharded forward, and the (widened)
    state the ranks shard."""
    kind, tp = request.param
    tied, quant = FORWARD_KINDS[kind]
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), tie_embeddings=tied)
    pcfg = dataclasses.replace(pllama.LlamaConfig.tiny(), tie_embeddings=tied)
    tree = _jax_tree(jcfg, 3, quant)
    state = pllama.params_from_jax(tree, pcfg)
    with torch.inference_mode():
        unsharded = pllama.LlamaForCausalLM.from_state_dict(
            pcfg, state, dtype=torch.float32)(torch.from_numpy(IDS).long())
    wide_tree, wide_jcfg = _widen(tree, jcfg, tp)
    model = jllama.LlamaForCausalLM(wide_jcfg, dtype=jnp.float32, quant=quant)
    sharded = shard_pytree(wide_tree, build_mesh(f"tp={tp}"),
                           jllama.tp_rules())
    want = np.asarray(jax.jit(lambda p, i: model.apply(p, i)[0])(
        sharded, jnp.asarray(IDS)))
    wide, wide_cfg = pllama.replicate_kv_heads(state, pcfg, tp)
    return tp, wide, wide_cfg, unsharded.numpy(), want


def _rank_forward(state, cfg, tp, fn):
    group = LoopbackGroup(tp)

    def rank(r):
        shard = shard_state_dict(state, pllama.tp_rules(), tp, r)
        model = pllama.LlamaForCausalLM.from_state_dict(
            cfg, shard, dtype=torch.float32, group=group)
        return fn(model, r)

    with torch.inference_mode():
        return run_ranks(rank, group)


def test_rank_local_forward_equals_unsharded_and_the_jax_package(
        sharded_case):
    tp, wide, wide_cfg, unsharded, want = sharded_case
    outs = _rank_forward(wide, wide_cfg, tp, lambda m, r: m(
        torch.from_numpy(IDS).long()))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    got = outs[0].numpy()
    np.testing.assert_allclose(got, unsharded, rtol=0, atol=TP_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=TP_ATOL)


def test_rank_local_dense_cache_equals_unsharded():
    """The dense-cache path at tp 2: each rank's cache holds its kv head,
    the prefill (lengths 5 and 7) and three decode steps give the
    unsharded model's logits."""
    cfg = pllama.LlamaConfig.tiny()
    state = pllama.params_from_jax(_jax_tree(jllama.LlamaConfig.tiny(), 4,
                                             False), cfg)
    ids = torch.from_numpy(IDS).long()
    lengths = torch.tensor([5, 7])
    steps = [torch.tensor([[11], [12]]), torch.tensor([[40], [41]]),
             torch.tensor([[7], [300]])]

    def run(model, group=None):
        cache = pllama.init_cache(cfg, 2, 16, dtype=torch.float32,
                                  device="cpu", group=group)
        assert cache.k[0].shape[2] == cfg.n_kv_heads // (
            1 if group is None else group.size)
        outs = [model(ids, cache=cache, lengths=lengths)]
        for t, tok in enumerate(steps):
            pos = lengths + t
            outs.append(model(tok, pos[:, None], cache=cache,
                              write_pos=pos))
        return outs

    with torch.inference_mode():
        want = run(pllama.LlamaForCausalLM.from_state_dict(
            cfg, state, dtype=torch.float32))
    got = _rank_forward(state, cfg, 2, lambda m, r: run(m, m.group))
    for rank_outs in got:
        for g, w in zip(rank_outs, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=TP_ATOL)


def test_rank_local_model_refuses_what_it_does_not_split():
    g = LoopbackGroup(4)    # tiny's 2 kv heads do not split 4 ways
    with pytest.raises(ValueError, match="must divide n_heads"):
        pllama.LlamaForCausalLM(pllama.LlamaConfig.tiny(), device="meta",
                                group=g)
    cfg = dataclasses.replace(pllama.LlamaConfig.tiny(),
                              cross_attention_layers=(1,))
    with pytest.raises(ValueError, match="cross layers"):
        pllama.LlamaForCausalLM(cfg, device="meta", group=LoopbackGroup(2))


# -- the loopback group and the launch counters ------------------------------

def test_loopback_collectives_combine_in_rank_order():
    tp = 3
    group = LoopbackGroup(tp)
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(64, generator=gen).to(torch.bfloat16) * (10 ** r)
             for r in range(tp)]
    want = parts[0].clone()
    for p in parts[1:]:
        want += p

    def rank(r):
        assert group.rank == r
        return (group.all_reduce(parts[r]),
                group.all_gather(torch.full((2, 1), r), dim=-1),
                group.all_gather(torch.full((1,), r), dim=0))

    for total, gathered, flat in run_ranks(rank, group):
        assert total.dtype == torch.bfloat16 and torch.equal(total, want)
        assert gathered.tolist() == [[0, 1, 2], [0, 1, 2]]
        assert flat.tolist() == [0, 1, 2]
    with pytest.raises(RuntimeError, match="not a rank"):
        group.rank


def test_loopback_failing_rank_releases_the_others():
    group = LoopbackGroup(4)
    done = []

    def rank(r):
        if r == 2:
            raise KeyError("rank 2 failed")
        group.all_reduce(torch.ones(2))
        done.append(r)

    with pytest.raises(KeyError, match="rank 2 failed"):
        run_ranks(rank, group)
    assert done == []
    assert threading.active_count() < 50


def test_loopback_ranks_take_turns():
    """12 ranks (more than the cores), the interpreter switching threads
    every microsecond, 50 all-reduces each: one rank runs at a time (a
    read-modify-write between collectives, a sleep inside it, loses no
    update), every rank reads every collective's full sum, and the group
    runs again after a first run."""
    tp, n = 12, 50
    group = LoopbackGroup(tp)
    state = {"running": 0, "most": 0, "count": 0}

    def rank(r):
        sums = []
        for i in range(n):
            state["running"] += 1
            state["most"] = max(state["most"], state["running"])
            c = state["count"]
            time.sleep(0)
            state["count"] = c + 1
            state["running"] -= 1
            sums.append(group.all_reduce(torch.tensor([float(r + i)])))
        return torch.cat(sums)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            state.update(running=0, most=0, count=0)
            outs = run_ranks(rank, group)
            assert state["most"] == 1 and state["count"] == tp * n
            want = torch.tensor([float(sum(range(tp)) + tp * i)
                                 for i in range(n)])
            for o in outs:
                assert torch.equal(o, want)
    finally:
        sys.setswitchinterval(interval)


def test_run_ranks_takes_the_callers_modes():
    group = LoopbackGroup(2)
    probe = lambda r: (torch.is_grad_enabled(),   # noqa: E731
                       torch.is_inference_mode_enabled())
    assert run_ranks(probe, group) == [(True, False)] * 2
    with torch.inference_mode():
        assert run_ranks(probe, group) == [(False, True)] * 2
    with torch.no_grad():
        assert run_ranks(probe, group) == [(False, False)] * 2


def test_launch_counter_is_exact_under_contending_threads():
    """16 threads adding 2,000 launches each, the interpreter switching
    threads every microsecond: no update lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000


def test_new_modules_are_scanned_and_import_no_jax():
    mods = {name for _, name in _modules()}
    new = {"scalable_hw_agnostic_inference_tpu_torch.core.budget",
           "scalable_hw_agnostic_inference_tpu_torch.parallel",
           "scalable_hw_agnostic_inference_tpu_torch.parallel.sharding",
           "scalable_hw_agnostic_inference_tpu_torch.parallel.loopback"}
    assert new <= mods
    paths = [p for p, name in _modules() if name in new or name.endswith(
        ("models.llama", "models.flux", "models.t5", "engine.runner"))]
    assert len(paths) == 8
    assert _forbidden_imports(paths) == []
