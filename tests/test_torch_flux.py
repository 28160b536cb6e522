"""Flux's modules in the port (``models/flow_match.py``, ``models/flux.py``)
held against the JAX package on the CPU at tiny sizes.

The same inputs, drawn from a seed with numpy, go through the JAX function
and its port; the JAX transformer's parameters (the tree's shape from
``jax.eval_shape`` of the flax ``init``, its values numpy draws,
``test_torch_diffusion._randomize``) are carried into the port through
``params_from_jax``.

- the flow-match tables equal the JAX package's, both schedule kinds
  (dynamic shift by image length, static shift), and the Euler step within
  one fp32 rounding (XLA may fuse the update into one multiply-add);
- ``patchify``, ``unpatchify``, ``make_ids`` and ``apply_rope_2d`` (on
  the same angles) equal, exactly; ``rope_freqs``' cos and sin within one
  fp32 rounding (torch's and XLA's libms differ in the last bit);
- the tiny ``FluxTransformer`` with and without the guidance embedding: in
  fp32 within ``FP32_RRMS`` of the output's rms; in bf16 by the attention
  rule and no further from the JAX bf16 output than twice that output's
  own distance from the JAX fp32 forward (the bf16 rounding floor,
  ``test_torch_diffusion``'s rule);
- ``state_from_bfl`` against the JAX package's ``params_from_torch`` on a
  synthetic BFL state dict (the JAX tests' inverse converter) and on its
  diffusers ``transformer/`` layout (through ``bfl_from_diffusers`` on both
  sides), and the seeded weights' q/k scales.

The pipeline and the unit are held against the JAX package's in
``test_torch_serve_flux.py``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models import flow_match as jfm
from scalable_hw_agnostic_inference_tpu.models import flux as jflux
from scalable_hw_agnostic_inference_tpu_torch.models import flow_match as pfm
from scalable_hw_agnostic_inference_tpu_torch.models import flux as pflux

sys.path.insert(0, str(Path(__file__).parent))
from test_models_flux import bfl_sd_from_params  # noqa: E402
from test_torch_diffusion import _check_bf16, _jax_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

#: fp32 modules: max |port - JAX| over rms(JAX)
FP32_RRMS = 1e-4

B, H_LAT, W_LAT, LT = 2, 8, 8, 6


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the flow-match scheduler -------------------------------------------------

SCHEDULES = {
    "dynamic": dict(),
    "static-1": dict(use_dynamic_shifting=False, shift=1.0),
    "static-3": dict(use_dynamic_shifting=False, shift=3.0),
}


@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_flow_match_tables_and_step_equal_the_jax_package(kind):
    ps = pfm.FlowMatchEuler(pfm.FlowMatchConfig(**SCHEDULES[kind]))
    js = jfm.FlowMatchEuler(jfm.FlowMatchConfig(**SCHEDULES[kind]))
    for steps in (1, 2, 4, 28, 50):
        for img_len in (0, 64, 1024, 4096):
            for p, j in zip(ps.tables(steps, img_len),
                            js.tables(steps, img_len)):
                assert p.dtype == np.float32
                np.testing.assert_array_equal(p, np.asarray(j))
    rng = np.random.default_rng(0)
    _, sig, nxt = ps.tables(4, 1024)
    for i in range(4):
        x = rng.standard_normal((2, 16, 64)).astype(np.float32)
        v = rng.standard_normal((2, 16, 64)).astype(np.float32)
        want = np.asarray(js.step(jnp.asarray(x), jnp.asarray(v),
                                  jnp.float32(sig[i]), jnp.float32(nxt[i])))
        got = ps.step(_t(x), _t(v), _t(sig[i]), _t(nxt[i])).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.spacing(np.abs(want)).max())


def test_scheduler_config_reads_the_reference_defaults():
    cfg = pfm.FlowMatchConfig.from_scheduler_config(
        {"shift": 3.0, "use_dynamic_shifting": True,
         "base_image_seq_len": 256, "max_image_seq_len": 4096})
    assert cfg == pfm.FlowMatchConfig(shift=3.0, use_dynamic_shifting=True)
    assert pfm.FlowMatchConfig.from_scheduler_config({}) == \
        pfm.FlowMatchConfig(shift=1.0, use_dynamic_shifting=False)
    assert pfm.mu_for_seq_len(pfm.FlowMatchConfig(), 1024) == \
        jfm.mu_for_seq_len(jfm.FlowMatchConfig(), 1024)


# -- patchify, ids, RoPE ------------------------------------------------------

def test_patchify_ids_and_rope_equal_the_jax_package():
    # patchify, make_ids and timestep_embedding's JAX references are
    # compiled whole (one compile each, not one a primitive); rope_freqs
    # and apply_rope_2d run op by op (compiled whole, XLA folds theta's
    # powers another way, 2 ulp off)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    tok = pflux.patchify(_t(lat))
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jax.jit(jflux.patchify)(lat)))
    np.testing.assert_array_equal(pflux.unpatchify(tok, 8, 12).numpy(), lat)
    ids = pflux.make_ids(2, 5, 8, 12, device="cpu")
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.jit(
        jflux.make_ids, static_argnums=(0, 1, 2, 3))(2, 5, 8, 12)))
    for axes, D in (((16, 56, 56), 128), ((4, 6, 6), 16)):
        cs = pflux.rope_freqs(ids, axes, 10000.0)
        jcs = jflux.rope_freqs(jnp.asarray(ids.numpy()), axes, 10000.0)
        # the angles equal; cos and sin within one rounding (two libms)
        np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), rtol=0,
                                   atol=np.float32(2 ** -24))
        cs = _t(np.asarray(jcs))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            x = rng.standard_normal((2, ids.shape[1], 3, D)).astype(
                np.float32)
            got = pflux.apply_rope_2d(_t(x).to(dt), cs)
            want = jflux.apply_rope_2d(jnp.asarray(x, jdt), jcs)
            assert got.dtype == dt
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the angles reach 999 rad, where one fp32 rounding of the argument
    # (6.1e-5) moves cos and sin by as much
    t = np.array([0.0, 0.25, 0.999], np.float32)
    np.testing.assert_allclose(
        pflux.timestep_embedding(_t(t), 256).numpy(),
        np.asarray(jax.jit(jflux.timestep_embedding, static_argnums=1)(
            jnp.asarray(t), 256)),
        rtol=0, atol=float(np.spacing(np.float32(999.0))))


# -- the transformer ----------------------------------------------------------

def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    Li = (H_LAT // 2) * (W_LAT // 2)
    return (rng.standard_normal((B, Li, cfg.in_channels)).astype(np.float32),
            rng.standard_normal((B, LT, cfg.t5_dim)).astype(np.float32),
            rng.standard_normal((B, cfg.clip_dim)).astype(np.float32),
            np.array([0.9, 0.3], np.float32), np.array([3.5, 1.0],
                                                       np.float32),
            np.asarray(jflux.make_ids(B, LT, H_LAT, W_LAT)))


def _port_cfg(jcfg) -> pflux.FluxConfig:
    return pflux.FluxConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=[True, False],
                ids=["guidance", "no-guidance"])
def flux_pair(request):
    """The JAX tree, the inputs and the JAX fp32 output (compiled once)."""
    jcfg = dataclasses.replace(jflux.FluxConfig.tiny(),
                               guidance_embed=request.param)
    args = _inputs(jcfg)
    params = _jax_params(jflux.FluxTransformer(jcfg).init, 7, *args)
    want32 = np.asarray(jax.jit(jflux.FluxTransformer(
        jcfg, dtype=jnp.float32).apply)(params, *args))
    return jcfg, params, args, want32


def _run_port(jcfg, params, args, dtype):
    m = pflux.FluxTransformer(_port_cfg(jcfg), dtype=dtype,
                              param_dtype=torch.float32, device="cpu")
    m.load_state_dict(pflux.params_from_jax(params))
    with torch.inference_mode():
        return m(*(_t(a) for a in args)).numpy()


def test_transformer_fp32_equals_the_jax_package(flux_pair):
    jcfg, params, args, want = flux_pair
    got = _run_port(jcfg, params, args, torch.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    rms = np.sqrt((want ** 2).mean())
    assert np.abs(got - want).max() <= FP32_RRMS * rms
    if jcfg.guidance_embed:
        # the guidance embedding is live
        other = list(args)
        other[4] = args[4] + 2.0
        assert np.abs(_run_port(jcfg, params, other, torch.float32)
                      - got).max() > 1e-6


def test_transformer_bf16_within_the_rounding_floor(flux_pair):
    jcfg, params, args, want32 = flux_pair
    want = np.asarray(jax.jit(jflux.FluxTransformer(
        jcfg, dtype=jnp.bfloat16).apply)(params, *args))
    got = _run_port(jcfg, params, args, torch.bfloat16)
    assert got.dtype == np.float32
    _check_bf16(got, want, want32)


# -- the weight paths ---------------------------------------------------------

def diffusers_from_bfl(sd, cfg) -> dict:
    """The inverse of ``bfl_from_diffusers``: a BFL state dict in the
    diffusers ``transformer/`` names (q, k, v split; ``[scale, shift]``)."""
    out = {}
    h = cfg.hidden

    def mv(dst, src):
        for suf in (".weight", ".bias"):
            if src + suf in sd:
                out[dst + suf] = sd[src + suf]

    def split(dsts, src, sizes):
        for suf in (".weight", ".bias"):
            for d, part in zip(dsts, torch.split(sd[src + suf], sizes)):
                out[d + suf] = part

    mv("x_embedder", "img_in")
    mv("context_embedder", "txt_in")
    for a, b in (("timestep_embedder", "time_in"),
                 ("text_embedder", "vector_in"),
                 ("guidance_embedder", "guidance_in")):
        mv(f"time_text_embed.{a}.linear_1", f"{b}.in_layer")
        mv(f"time_text_embed.{a}.linear_2", f"{b}.out_layer")
    mv("proj_out", "final_layer.linear")
    for suf in (".weight", ".bias"):
        a, b = torch.chunk(sd["final_layer.adaLN_modulation.1" + suf], 2)
        out["norm_out.linear" + suf] = torch.cat([b, a])
    for i in range(cfg.n_double):
        s, d = f"transformer_blocks.{i}", f"double_blocks.{i}"
        mv(f"{s}.norm1.linear", f"{d}.img_mod.lin")
        mv(f"{s}.norm1_context.linear", f"{d}.txt_mod.lin")
        split([f"{s}.attn.to_q", f"{s}.attn.to_k", f"{s}.attn.to_v"],
              f"{d}.img_attn.qkv", [h] * 3)
        split([f"{s}.attn.add_q_proj", f"{s}.attn.add_k_proj",
               f"{s}.attn.add_v_proj"], f"{d}.txt_attn.qkv", [h] * 3)
        for side, q, k in (("img", "norm_q", "norm_k"),
                           ("txt", "norm_added_q", "norm_added_k")):
            out[f"{s}.attn.{q}.weight"] = \
                sd[f"{d}.{side}_attn.norm.query_norm.scale"]
            out[f"{s}.attn.{k}.weight"] = \
                sd[f"{d}.{side}_attn.norm.key_norm.scale"]
        mv(f"{s}.attn.to_out.0", f"{d}.img_attn.proj")
        mv(f"{s}.attn.to_add_out", f"{d}.txt_attn.proj")
        mv(f"{s}.ff.net.0.proj", f"{d}.img_mlp.0")
        mv(f"{s}.ff.net.2", f"{d}.img_mlp.2")
        mv(f"{s}.ff_context.net.0.proj", f"{d}.txt_mlp.0")
        mv(f"{s}.ff_context.net.2", f"{d}.txt_mlp.2")
    for i in range(cfg.n_single):
        s, d = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        mv(f"{s}.norm.linear", f"{d}.modulation.lin")
        split([f"{s}.attn.to_q", f"{s}.attn.to_k", f"{s}.attn.to_v",
               f"{s}.proj_mlp"], f"{d}.linear1", [h] * 3 + [4 * h])
        mv(f"{s}.proj_out", f"{d}.linear2")
        out[f"{s}.attn.norm_q.weight"] = sd[f"{d}.norm.query_norm.scale"]
        out[f"{s}.attn.norm_k.weight"] = sd[f"{d}.norm.key_norm.scale"]
    return out


@pytest.mark.parametrize("layout", ["bfl", "diffusers"])
def test_state_from_bfl_equals_the_reference_converter(flux_pair, layout):
    """The port's state from a BFL state dict (or its diffusers layout)
    equals the port state of the JAX package's ``params_from_torch`` tree
    of the same dict, tensor for tensor; schnell is told apart by key."""
    jcfg, params, _, _ = flux_pair
    sd = bfl_sd_from_params(params, jcfg)
    if layout == "diffusers":
        sd = diffusers_from_bfl(sd, jcfg)
        want = jflux.params_from_torch(jflux.bfl_from_diffusers(sd), jcfg)
    else:
        want = jflux.params_from_torch(sd, jcfg)
    cfg = pflux.config_for_keys(sd.keys(), _port_cfg(jcfg))
    assert cfg.guidance_embed == jcfg.guidance_embed
    got = pflux.state_from_bfl(sd.__getitem__, cfg, sd.keys())
    want = pflux.params_from_jax(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    missing = {k: v for k, v in sd.items() if "linear2" not in k
               and "proj_out" not in k}
    with pytest.raises(ValueError, match="has no"):
        pflux.state_from_bfl(missing.__getitem__, cfg, missing.keys())


def test_seeded_weights_on_the_device_asked_for():
    m = pflux.seeded(pflux.FluxConfig.tiny(), 3, dtype=torch.float32,
                     device="cpu")
    q = m.double_0.img_qknorm.q_scale
    assert q.device.type == "cpu" and bool((q == 1).all())
    assert float(m.single_0.linear1.weight.std()) > 0
