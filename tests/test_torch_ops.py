"""The port's ops against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages. The JAX side
runs as its own tests run it: the Pallas kernels in interpret mode, the
rest through XLA. The port side runs the kernels' plain versions (a CPU
tensor never reaches a CUDA kernel). Tolerances:

- fp32 attention, norms and sampling distributions: ``atol`` 1e-5, i.e.
  fp32 rounding only (sums taken in another order);
- rope at positions up to 9000: ``atol`` 5e-4 (fp32 cos/sin of angles near
  1e4 rad differ by a few ulps of the angle between libraries);
- the module RMSNorm in bf16: exact (both round the same fp32 value).
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.ops import attention as jattn
from scalable_hw_agnostic_inference_tpu.ops import rope as jrope
from scalable_hw_agnostic_inference_tpu.ops import sampling as jsamp
from scalable_hw_agnostic_inference_tpu.ops.pallas.flash_attention import (
    flash_attention as j_flash,
    flash_eligible as j_flash_eligible,
)
from scalable_hw_agnostic_inference_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as j_paged,
)
from scalable_hw_agnostic_inference_tpu_torch.ops import attention as tattn
from scalable_hw_agnostic_inference_tpu_torch.ops import rope as trope
from scalable_hw_agnostic_inference_tpu_torch.ops import sampling as tsamp
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
    flash_attention as tflash,
    paged_attention as tpaged,
)
from scalable_hw_agnostic_inference_tpu_torch.ops.norms import RMSNorm, rms_norm

FP32_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(rng, B, T, S, H, Hkv, D):
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


# -- B1: flash attention (plain version vs the Pallas kernel) ----------------

@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal,lengths", [
    (2, 32, 32, 4, 2, 16, True, [0, 1]),        # length 0 -> zeros, 1
    (2, 32, 32, 4, 2, 16, True, [32, 17]),      # GQA, ragged lengths
    (1, 16, 48, 2, 2, 64, True, [48]),          # causal T < S offset
    (2, 16, 40, 4, 1, 16, False, [40, 9]),      # non-causal, ragged S
    (1, 24, 24, 4, 4, 16, True, None),          # MHA, no lengths
])
def test_flash_reference_matches_pallas(B, T, S, H, Hkv, D, causal, lengths):
    rng = np.random.default_rng(B * 100 + T + S + D)
    q, k, v = _qkv(rng, B, T, S, H, Hkv, D)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, lengths=jl, interpret=True))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = tflash.flash_attention_reference(_t(q), _t(k), _t(v),
                                           causal=causal, lengths=tl)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    if lengths is not None and 0 in lengths:
        b = lengths.index(0)
        assert np.all(got.numpy()[b] == 0.0)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 16, 16, 4, 2, 64))
    lens = torch.tensor([11], dtype=torch.int32)
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=True, lengths=lens)
    want = tflash.flash_attention_reference(q, k, v, causal=True,
                                            lengths=lens)
    assert torch.equal(got, want)
    assert tflash.flash_attention.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("shape,mask", [
    ((1, 128, 4, 64), False), ((1, 128, 4, 16), False),
    ((1, 7, 4, 64), False), ((1, 128, 4, 64), True), ((1, 64, 4, 320), False),
])
def test_flash_eligible_matches_reference(shape, mask):
    """The port's gate is the reference's without its Pallas tiling rule
    on ``T`` (the CUDA kernel masks its ragged query tile): it agrees with
    the reference's gate asked about the same call at a tileable ``T``."""
    B, T, H, D = shape
    q = np.zeros(shape, np.float32)
    k = np.zeros((B, T, 2, D), np.float32)
    m = np.ones((1, 1, T, T), bool) if mask else None
    q128 = np.zeros((B, 128, H, D), np.float32)
    assert tflash.flash_eligible(
        _t(q), _t(k), _t(k), mask=None if m is None else _t(m)) == \
        j_flash_eligible(jnp.asarray(q128), jnp.asarray(k), jnp.asarray(k),
                         mask=None if m is None else jnp.asarray(m))


@pytest.mark.parametrize("causal,use_lengths,use_mask", [
    (True, True, False), (False, False, True), (True, False, False),
])
def test_dot_product_attention_matches_reference(causal, use_lengths,
                                                 use_mask):
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 16, 24, 4, 2, 16)
    lens = np.array([24, 5], np.int32) if use_lengths else None
    mask = rng.random((2, 1, 16, 24)) > 0.3 if use_mask else None
    want = np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal,
        kv_lengths=None if lens is None else jnp.asarray(lens)))
    got = tattn.dot_product_attention(
        _t(q), _t(k), _t(v), mask=None if mask is None else _t(mask),
        causal=causal, kv_lengths=None if lens is None else _t(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


def test_dot_product_attention_pallas_impl_raises_when_ineligible(
        monkeypatch):
    """On CUDA every call takes the kernel route (the reference's
    ``impl="pallas"``) and one the kernel does not take raises; nothing on
    CUDA reaches the plain path. The dispatch reads only shapes and the
    device, so stand-ins of CUDA tensors drive it here with the kernel
    replaced by a recorder."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or "B1")
    cuda = torch.device("cuda")

    def on_cuda(*shape):
        return types.SimpleNamespace(shape=shape, device=cuda)

    q, k = on_cuda(1, 21, 4, 128), on_cuda(1, 21, 2, 128)
    lens = torch.tensor([13])
    # T = 21 is no Pallas tile, yet the call goes to B1 with its lengths
    assert tattn.dot_product_attention(q, k, k, causal=True,
                                       kv_lengths=lens) == "B1"
    assert calls == [{"causal": True, "scale": 1.0 / 128 ** 0.5,
                      "lengths": lens}]
    m = torch.ones(1, 1, 21, 21, dtype=torch.bool)
    for kw in ({"mask": m}, {"bias": m.float()}):
        with pytest.raises(ValueError, match="not eligible"):
            tattn.dot_product_attention(q, k, k, causal=True, **kw)
    with pytest.raises(ValueError, match="not eligible"):
        tattn.dot_product_attention(on_cuda(1, 8, 2, 16),
                                    on_cuda(1, 8, 2, 16),
                                    on_cuda(1, 8, 2, 16), causal=True)
    assert len(calls) == 1


# -- B2: paged decode attention (plain version vs the Pallas kernel) ---------

def _pool(rng, B, H, Hkv, D, bs, N, M, lengths):
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    # every row's table is a shuffled draw of distinct pool blocks
    tables = rng.permutation(N)[:B * M].reshape(B, M).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("B,H,Hkv,D,bs,N,M,lengths", [
    (4, 4, 2, 16, 16, 32, 6, [0, 1, 37, 96]),   # length 0 -> zeros, 1, GQA
    (2, 8, 8, 64, 16, 24, 4, [64, 5]),          # MHA, full window
    (3, 4, 1, 16, 8, 40, 5, [40, 3, 23]),       # MQA, block size 8
])
def test_paged_reference_matches_pallas(B, H, Hkv, D, bs, N, M, lengths):
    rng = np.random.default_rng(B + H + D + M)
    q, kp, vp, tables, lens = _pool(rng, B, H, Hkv, D, bs, N, M, lengths)
    want = np.asarray(j_paged(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tables),
                              jnp.asarray(lens), interpret=True))
    got = tpaged.paged_decode_attention_reference(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    for b, n in enumerate(lengths):
        if n == 0:
            assert np.all(got.numpy()[b] == 0.0)


def test_paged_truncated_bucket_matches_full_window():
    """Dispatching a context bucket (tables[:, :m]) is exact while every
    live block fits — the engine's bucketed decode."""
    rng = np.random.default_rng(5)
    q, kp, vp, tables, lens = _pool(rng, 2, 4, 2, 16, 16, 32, 8, [20, 30])
    args = (_t(q), _t(kp), _t(vp))
    full = tpaged.paged_decode_attention(*args, _t(tables), _t(lens))
    cut = tpaged.paged_decode_attention(*args, _t(tables[:, :2].copy()),
                                        _t(lens))
    want = np.asarray(j_paged(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tables[:, :2]),
                              jnp.asarray(lens), interpret=True))
    np.testing.assert_allclose(cut.numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_allclose(cut.numpy(), want, atol=FP32_ATOL, rtol=0)


# -- rope, norms, sampling ----------------------------------------------------

@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
def test_rope_matches_reference(scaling):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 9000, (2, 5)).astype(np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       500000.0, scaling))
    got = trope.apply_rope(_t(x), _t(pos), 500000.0, scaling)
    # positions up to 9000 make angles of ~1e4 rad: fp32 cos/sin of such
    # arguments differ by a few ulps of the angle between libraries
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)
    cos_j, _ = jrope.rope_angles(jnp.asarray(pos[:, :2] % 64), 64, 10000.0)
    cos_t, _ = trope.rope_angles(_t(pos[:, :2] % 64), 64, 10000.0)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j),
                               atol=FP32_ATOL)


def test_rmsnorm_matches_reference():
    from scalable_hw_agnostic_inference_tpu.engine.runner import _rmsnorm
    from scalable_hw_agnostic_inference_tpu.ops.norms import RMSNorm as JNorm

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32) * 3
    scale = rng.standard_normal((32,)).astype(np.float32)
    want = np.asarray(_rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = rms_norm(_t(x), _t(scale), 1e-5).to(torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=1e-6)
    # the module form casts to its compute dtype, as flax's does
    jn = JNorm(eps=1e-5, dtype=jnp.bfloat16)
    jout = jn.apply({"params": {"scale": jnp.asarray(scale)}},
                    jnp.asarray(x))
    tn = RMSNorm(32, eps=1e-5, dtype=torch.bfloat16)
    with torch.no_grad():
        tn.scale.copy_(_t(scale))
    with torch.no_grad():
        tout = tn(_t(x))
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=0, rtol=0)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 12, 0.6),
    (0.0, 0, 1.0), ([0.0, 0.8, 1.0], [0, 3, 0], [1.0, 1.0, 0.5]),
])
def test_sampling_probs_match_reference(temperature, top_k, top_p):
    rng = np.random.default_rng(13)
    logits = (rng.standard_normal((3, 50)) * 2).astype(np.float32)

    def knobs(mod):
        return [mod(np.asarray(x)) if isinstance(x, list) else x
                for x in (temperature, top_k, top_p)]

    want = np.asarray(jsamp.sampling_probs(jnp.asarray(logits),
                                           *knobs(jnp.asarray)))
    got = tsamp.sampling_probs(_t(logits), *knobs(_t))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    np.testing.assert_array_equal(tsamp.greedy(_t(logits)).numpy(),
                                  np.asarray(jsamp.greedy(
                                      jnp.asarray(logits))))


def test_sample_logits_draws_from_sampling_probs():
    """The draws follow :func:`sampling_probs` (a chi-square-free check:
    tokens outside the support never appear, greedy rows are exact, and a
    fixed generator seed reproduces the draws)."""
    rng = np.random.default_rng(17)
    logits = _t((rng.standard_normal((4, 40)) * 2).astype(np.float32))
    temp = torch.tensor([0.0, 1.0, 0.7, 1.0])
    top_k = torch.tensor([0, 4, 0, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 0.5, 1.0])
    probs = tsamp.sampling_probs(logits, temp, top_k, top_p)
    draws = torch.stack([
        tsamp.sample_logits(logits, torch.Generator().manual_seed(s), temp,
                            top_k, top_p) for s in range(200)])
    support = probs > 0
    assert bool(support.gather(1, draws.T.long()).all())
    assert bool((draws[:, 0] == logits[0].argmax()).all())
    again = tsamp.sample_logits(logits, torch.Generator().manual_seed(0),
                                temp, top_k, top_p)
    assert torch.equal(again, draws[0])
    # the unrestricted row's empirical frequencies track its distribution
    freq = torch.bincount(draws[:, 3].long(), minlength=40).float() / 200
    assert float((freq - probs[3]).abs().max()) < 0.12
