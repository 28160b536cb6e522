"""The port's int8 KV codec and ragged paged attention (B3) against the JAX
package's, on the CPU.

Inputs come from a numpy seed and go through both packages. The JAX side
runs as its own tests run it: the Pallas kernels in interpret mode, the
rest through XLA. The port side runs B3's plain version (a CPU tensor
never reaches the CUDA kernel). Tolerances:

- the codec on identical fp32 inputs: int8 values equal, scales within
  1e-6 relative (one fp32 division, ``amax / 127``, taken by both);
- fp32 attention: ``atol`` 2e-5, fp32 rounding only (sums in another
  order), the bound the JAX package's own ragged test uses
  (``tests/test_ragged_quant.py``); a length-0 row is exactly zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.ops import attention as jattn
from scalable_hw_agnostic_inference_tpu.ops import quant as jquant
from scalable_hw_agnostic_inference_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as j_paged,
)
from scalable_hw_agnostic_inference_tpu.ops.pallas.ragged_paged_attention import (  # noqa: E501
    ragged_paged_attention as j_ragged,
)
from scalable_hw_agnostic_inference_tpu_torch.ops import attention as tattn
from scalable_hw_agnostic_inference_tpu_torch.ops import quant as tquant
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
    paged_attention as tpaged,
    ragged_paged_attention as tragged,
)

ATOL = 2e-5
SCALE_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the int8 KV-block codec ---------------------------------------------------

def _blocks(seed, shape, kind):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "outlier":
        x[0, 2, 1, 3] = 100.0          # one (block, head) scale only
    elif kind == "zeros":
        x[:] = 0.0                     # the 1e-8 floor, never a /0
    elif kind == "halves":
        # values that land on .5 steps: round half to even in both
        x = (np.arange(x.size, dtype=np.float32).reshape(shape) % 9 - 4) / 4
        x[..., 0] = 127.0 / 2          # amax 63.5 -> scale 0.5 exactly
    return x


@pytest.mark.parametrize("kind", ["normal", "outlier", "zeros", "halves"])
def test_quantize_dequantize_match_jax(kind):
    x = _blocks(0, (6, 8, 2, 16), kind)
    jq, js = jquant.quantize_kv_blocks(jnp.asarray(x))
    tq, ts = tquant.quantize_kv_blocks(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (6, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL,
                               atol=0)
    # dequantize both packages' codes with the same scales
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jquant.dequantize_kv_blocks(jq, js, jdt)
                          .astype(jnp.float32))
        got = tquant.dequantize_kv_blocks(_t(np.asarray(jq)),
                                          _t(np.asarray(js)), dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fresh", [True, False], ids=["empty", "resident"])
def test_requantize_block_tokens_matches_jax(fresh):
    """One decode write into a fresh (scale 0) or an occupied block; the
    scale is the running max of the old one and the new token's."""
    rng = np.random.default_rng(1)
    if fresh:
        q8 = np.zeros((3, 8, 2, 16), np.int8)
        sc = np.zeros((3, 2), np.float32)
    else:
        jq, js = jquant.quantize_kv_blocks(
            jnp.asarray(rng.standard_normal((3, 8, 2, 16)), jnp.float32))
        q8, sc = np.asarray(jq), np.asarray(js)
    pos = np.array([0, 5, 7], np.int32)
    for mult in (0.01, 3.0):           # a scale that stays, one that grows
        tok = (rng.standard_normal((3, 2, 16)) * mult).astype(np.float32)
        jq, js = jquant.requantize_block_tokens(
            jnp.asarray(q8), jnp.asarray(sc), jnp.asarray(tok),
            jnp.asarray(pos))
        tq, ts = tquant.requantize_block_tokens(_t(q8), _t(sc), _t(tok),
                                                _t(pos))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                   rtol=SCALE_RTOL, atol=0)
        assert (ts.numpy() >= sc).all()  # a block's scale only grows
        q8, sc = np.asarray(jq), np.asarray(js)


# -- B3: the plain version against the Pallas kernel -------------------------

def _fixture(H, Hkv, quant, zero_row):
    """``tests/test_ragged_quant.py``'s pool (12 blocks of 8 tokens, D 16),
    widened to ``H``/``Hkv`` heads, optionally with a length-0 row."""
    rng = np.random.default_rng(3)
    kp = rng.standard_normal((12, 8, Hkv, 16)).astype(np.float32)
    vp = rng.standard_normal((12, 8, Hkv, 16)).astype(np.float32)
    tables = [[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0]]
    lengths = [29, 11, 3]
    if zero_row:
        tables.append([8, 9, 0, 0])
        lengths.append(0)
    tables = np.asarray(tables, np.int32)
    lengths = np.asarray(lengths, np.int32)
    q = rng.standard_normal((len(lengths), H, 16)).astype(np.float32)
    ks = vs = None
    if quant:
        kq, ks = jquant.quantize_kv_blocks(jnp.asarray(kp))
        vq, vs = jquant.quantize_kv_blocks(jnp.asarray(vp))
        kp, vp = np.asarray(kq), np.asarray(vq)
        ks, vs = np.asarray(ks), np.asarray(vs)
    return q, kp, vp, ks, vs, tables, lengths


def _j(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _tt(*arrs):
    return [None if a is None else _t(a) for a in arrs]


CASES = [(4, 2, False), (4, 2, True), (8, 2, True)]
CASE_IDS = ["G2", "G2-len0", "H8-Hkv2-len0"]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("H,Hkv,zero_row", CASES, ids=CASE_IDS)
def test_ragged_reference_matches_pallas(H, Hkv, zero_row, quant):
    q, kp, vp, ks, vs, tables, lens = _fixture(H, Hkv, quant, zero_row)
    want = np.asarray(j_ragged(*_j(q, kp, vp, tables, lens, ks, vs),
                               interpret=True))
    got = tragged.ragged_paged_attention_reference(
        *_tt(q, kp, vp, tables, lens, ks, vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if zero_row:
        assert np.all(got.numpy()[-1] == 0.0)
    # the wrapper takes the plain version for a CPU tensor
    via = tragged.ragged_paged_attention(
        *_tt(q, kp, vp, tables, lens, ks, vs))
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_ragged_reference_bf16_pool_matches_pallas():
    """The working types of the engine: bf16 queries and pool."""
    q, kp, vp, _, _, tables, lens = _fixture(8, 2, False, True)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    want = np.asarray(j_ragged(*bf, jnp.asarray(tables), jnp.asarray(lens),
                               interpret=True).astype(jnp.float32))
    got = tragged.ragged_paged_attention_reference(
        *[_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in bf], _t(tables), _t(lens))
    assert got.dtype == torch.bfloat16
    # both compute in fp32 and round the output once to bf16: equal, or one
    # bf16 ulp apart where the fp32 sums straddle a rounding boundary
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=ATOL)


# -- the CPU dispatch -----------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_ragged_dispatch_matches_jax_on_cpu(quant):
    """``ops.attention.ragged_paged_attention`` on the CPU is the gather
    path (int8 dequantized after the gather, to ``q``'s dtype), as the JAX
    dispatch is off the TPU; multi-query ``positions [B, T]`` too."""
    q, kp, vp, ks, vs, tables, lens = _fixture(4, 2, quant, False)
    want = np.asarray(jattn.ragged_paged_attention(
        *_j(q, kp, vp, tables, lens, ks, vs)))
    got = tattn.ragged_paged_attention(*_tt(q, kp, vp, tables, lens, ks, vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    pos = np.array([[26, 27, 28], [8, 9, 10], [0, 1, 2]], np.int32)
    q3 = np.random.default_rng(4).standard_normal((3, 3, 4, 16)).astype(
        np.float32)
    want = np.asarray(jattn.ragged_gather_attention(
        *_j(q3, kp, vp, tables, pos, ks, vs)))
    got = tattn.ragged_gather_attention(*_tt(q3, kp, vp, tables, pos, ks, vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_paged_decode_with_scales_is_ragged():
    """B2 with int8 scales returns B3 on the caller's truncated tables, as
    the Pallas kernel's int8 branch does; on the CPU that is B3's plain
    version."""
    q, kp, vp, ks, vs, tables, lens = _fixture(4, 2, True, True)
    cut = tables[:, :2].copy()
    lens = np.minimum(lens, 16)
    want = np.asarray(j_paged(*_j(q, kp, vp, cut, lens, ks, vs),
                              interpret=True))
    got = tpaged.paged_decode_attention(*_tt(q, kp, vp, cut, lens, ks, vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), tragged.ragged_paged_attention_reference(
            *_tt(q, kp, vp, cut, lens, ks, vs)).numpy())


def test_ragged_wrapper_refuses_other_devices():
    q, kp, vp, ks, vs, tables, lens = _fixture(4, 2, True, False)
    args = [t.to("meta") for t in _tt(q, kp, vp, tables, lens, ks, vs)]
    with pytest.raises(ValueError, match="unsupported device"):
        tragged.ragged_paged_attention(*args)


# -- rows_per_table: a run of R rows shares one table row ---------------------

R_CHUNK = 5
STARTS = (20, 9)


def _shared_fixture(quant):
    """A two-sequence continuation chunk: ``R_CHUNK`` query rows per
    sequence, each with length ``start + t + 1`` (a causal edge), and one
    table row per sequence, not per query row."""
    rng = np.random.default_rng(5)
    kp = rng.standard_normal((12, 8, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((12, 8, 2, 16)).astype(np.float32)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    lengths = np.asarray([s + t + 1 for s in STARTS for t in range(R_CHUNK)],
                         np.int32)
    q = rng.standard_normal((len(lengths), 4, 16)).astype(np.float32)
    ks = vs = None
    if quant:
        kq, ks = jquant.quantize_kv_blocks(jnp.asarray(kp))
        vq, vs = jquant.quantize_kv_blocks(jnp.asarray(vp))
        kp, vp = np.asarray(kq), np.asarray(vq)
        ks, vs = np.asarray(ks), np.asarray(vs)
    return q, kp, vp, ks, vs, tables, lengths


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_rows_per_table_matches_repeated_tables_and_jax(quant):
    """``rows_per_table=R`` with ``[rows / R, M]`` tables equals the R = 1
    call on the repeated tables, the JAX gather oracle with each
    sequence's R queries at positions ``start + t``, and the Pallas
    kernel (interpret mode) on the repeated tables."""
    q, kp, vp, ks, vs, tables, lens = _shared_fixture(quant)
    rep = np.repeat(tables, R_CHUNK, axis=0)
    got = tragged.ragged_paged_attention(
        *_tt(q, kp, vp, tables, lens, ks, vs), rows_per_table=R_CHUNK)
    r1 = tragged.ragged_paged_attention(*_tt(q, kp, vp, rep, lens, ks, vs))
    np.testing.assert_array_equal(got.numpy(), r1.numpy())
    pos = (lens - 1).reshape(len(STARTS), R_CHUNK)
    want = np.asarray(jattn.ragged_gather_attention(
        *_j(q.reshape(len(STARTS), R_CHUNK, 4, 16), kp, vp, tables, pos, ks,
            vs))).reshape(q.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    pallas = np.asarray(j_ragged(*_j(q, kp, vp, rep, lens, ks, vs),
                                 interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)
    # the dispatch the runner's ragged continuation calls
    via = tattn.ragged_paged_attention(
        *_tt(q, kp, vp, tables, lens, ks, vs), rows_per_table=R_CHUNK)
    np.testing.assert_allclose(via.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("entry", ["kernel", "dispatch"])
@pytest.mark.parametrize("R,n_tables", [(R_CHUNK, 10), (R_CHUNK, 1), (3, 3)],
                         ids=["repeated", "too-few", "not-a-divisor"])
def test_rows_per_table_refuses_mismatched_tables(entry, R, n_tables):
    q, kp, vp, ks, vs, tables, lens = _shared_fixture(False)
    tables = np.resize(tables, (n_tables, tables.shape[1]))
    fn = (tragged.ragged_paged_attention if entry == "kernel"
          else tattn.ragged_paged_attention)
    with pytest.raises(ValueError, match="rows_per_table"):
        fn(*_tt(q, kp, vp, tables, lens), rows_per_table=R)


@pytest.mark.parametrize("case,want", [
    # the continuation: 512 rows of one table, G = 4 -> 16 rows a tile,
    # 32 tiles x 8 kv heads fill 132 SMs: no split
    ((512, 512, 32, 8, 16, 256, 132), (16, 1)),
    # a 441-row tail chunk: 28 tiles x 8 heads, still no split
    ((441, 441, 32, 8, 16, 256, 132), (16, 1)),
    # decode B=8 takes the decode CTA: 64 CTAs, split to about 2 per SM
    ((8, 1, 32, 8, 16, 256, 132), (1, 5)),
    # decode B=1: capped at 4 key tiles a split of the 4096-key window
    ((1, 1, 32, 8, 16, 256, 132), (1, 16)),
    # a window of 2 key tiles is not split at all
    ((8, 1, 32, 8, 16, 8, 132), (1, 1)),
    # G = 16: 4 rows a tile; a 512-key window splits at most in 2
    ((64, 64, 16, 1, 16, 32, 132), (4, 2)),
    # one row a table but G = 64, past the decode CTA's 32: the tile walk,
    # about 4 CTAs per SM, at least 4 key tiles a split
    ((8, 1, 64, 1, 16, 256, 132), (1, 16)),
])
def test_ragged_plan(case, want):
    assert tragged.ragged_plan(*case) == want
    rt, _ = want
    G = case[2] // case[3]
    assert rt * G <= tragged.MAX_PRODUCT_ROWS


@pytest.mark.parametrize("case,splits", [
    # B2 at B=8 over a 128-block bucket (2048 keys): 64 (row, kv head)
    # CTAs, split to about 2 per SM of 132
    ((8, 32, 8, 16, 128, 132), 5),
    # B=1 over the same bucket: capped at 4 key tiles of 64 a split
    ((1, 32, 8, 16, 128, 132), 8),
    # serve's bucket of 32 blocks (512 keys): at most 2 splits
    ((8, 32, 8, 16, 32, 132), 2),
    # 17 rows x 8 kv heads = 136 CTAs fill 132 SMs: no split
    ((17, 32, 8, 16, 128, 132), 1),
    # G = 32 (Hkv = 1), block size 24 (a 1536-key window)
    ((2, 32, 1, 24, 64, 132), 6),
])
def test_decode_plan(case, splits):
    """Every one-table-a-row launch with at most 32 query heads per kv head
    takes the decode CTA: 4 warps, one row a CTA, its keys split until
    the card is about twice full."""
    rows, H, Hkv, bs, M, n_sms = case
    assert tragged.decode_plan(*case) == (4, splits)
    assert tragged.DECODE_WARPS == 4
    assert tragged.ragged_plan(rows, 1, H, Hkv, bs, M, n_sms) == (1, splits)


@pytest.mark.parametrize("H,Hkv,bs", [(4, 2, 8), (8, 1, 24)],
                         ids=["G2-bs8", "G8-bs24"])
def test_paged_and_ragged_plain_versions_agree_on_truncated_tables(H, Hkv,
                                                                   bs):
    """B2 is B3 with one table row a query row on the caller's truncated
    ``[B, M]`` tables: their plain versions agree, and with the Pallas B2
    (interpret mode), with a length past ``M * bs`` (the whole bucket
    counts) and a length-0 row (zeros)."""
    rng = np.random.default_rng(bs + H)
    N, D, M = 16, 16, 3
    kp = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    full = rng.permutation(N)[:12].reshape(3, 4).astype(np.int32)
    cut = np.ascontiguousarray(full[:, :M])
    lens = np.asarray([M * bs + 5, 0, bs + 1], np.int32)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    b2 = tpaged.paged_decode_attention_reference(*_tt(q, kp, vp, cut, lens))
    b3 = tragged.ragged_paged_attention_reference(*_tt(q, kp, vp, cut, lens),
                                                  rows_per_table=1)
    np.testing.assert_allclose(b2.numpy(), b3.numpy(), atol=ATOL, rtol=0)
    assert np.all(b2.numpy()[1] == 0.0) and np.all(b3.numpy()[1] == 0.0)
    clipped = tpaged.paged_decode_attention_reference(
        *_tt(q, kp, vp, cut, np.minimum(lens, M * bs)))
    np.testing.assert_array_equal(b2.numpy(), clipped.numpy())
    want = np.asarray(j_paged(*_j(q, kp, vp, cut, lens), interpret=True))
    np.testing.assert_allclose(b2.numpy(), want, atol=ATOL, rtol=0)
    # the wrappers on the CPU: each its own plain version
    np.testing.assert_array_equal(
        tpaged.paged_decode_attention(*_tt(q, kp, vp, cut, lens)).numpy(),
        b2.numpy())
