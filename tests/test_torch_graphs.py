"""The decode graphs' bookkeeping (``engine/graphs.py``), on the CPU.

A CUDA graph cannot be captured here, so the capture bookkeeping runs
against stand-ins of the CUDA calls (a recorder for the graph, streams that
do nothing) and a decode function that asks for split scratch and counts
its launches as the kernel wrappers do. What is held:

- the split scratch is reserved for the largest key before any capture,
  and a capture (or the eager run before it) that would grow it raises;
- a capture's launches come off the counters and go back on at every
  replay, per kernel;
- a replay checks the KV pool's addresses against the capture's;
- on the CPU a decode graph runs the decode function eagerly on its static
  inputs: the tokens of ``make_decode`` on the same inputs and draws,
  ``pos + 1``, fresh draws at every step, greedy rows blind to them.
"""

import contextlib

import numpy as np
import pytest
import torch

from scalable_hw_agnostic_inference_tpu_torch.engine import runner
from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
    COUNTED,
    DecodeGraph,
    GraphPool,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
    paged_attention as tpaged,
)
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
    ragged_paged_attention as trpa,
)

CPU = torch.device("cpu")
LAYERS = 4
B, V, M = 2, 32, 4


class _Stream:
    cuda_stream = 0x5A5A

    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


class _Graph:
    """Records that it was captured and how often it was replayed."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA calls a capture makes, as stand-ins; yields a pool that
    believes it is on the card."""
    captures = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        captures.append((g, pool, stream, capture_error_mode))
        yield

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(trpa, "_scratch", {})
    for _, fn, attr in COUNTED:
        monkeypatch.setattr(fn, attr, 0)
    pool = GraphPool(CPU)
    pool.cuda, pool.stream, pool.handle = True, _Stream(), (7, 0)
    pool.captures = captures
    yield pool


def _pool_kv():
    return [{"k": torch.zeros(8, 4, 1, 16), "v": torch.zeros(8, 4, 1, 16)}
            for _ in range(LAYERS)]


def _stand_in_decode(need, frozen_seen):
    """A decode step of ``LAYERS`` B2 launches, each taking ``need`` split
    scratch on the current (capture) stream first, as ``_launch`` does."""

    def decode(model, kv, tokens, pos, tables, rng, temp, topk, topp):
        for _ in range(LAYERS):
            frozen_seen.append(trpa._frozen)
            trpa._split_scratch(CPU, _Stream.cuda_stream, *need)
            tpaged.paged_decode_attention.launches += 1
        # the feedback decode's outputs: tokens, pos + 1 and the logprob
        # readout (top_ids, top_lp, tok_lp)
        n = len(tokens)
        return (kv, tokens + 1, pos + 1,
                torch.zeros(n, runner.K_LOGPROBS, dtype=torch.int32),
                torch.zeros(n, runner.K_LOGPROBS), torch.zeros(n))

    return decode


def _graph(pool, decode, kv):
    return DecodeGraph((M, B), decode, None, kv, B, M, V, device="cpu",
                       pool=pool)


def test_capture_counts_launches_on_every_replay(fake_cuda):
    frozen = []
    fake_cuda.reserve([(100, 4), (300, 2), (200, 8)])
    assert fake_cuda.reserved == (300, 8)      # the largest of each
    part, counters = trpa._scratch[(None, _Stream.cuda_stream)]
    g = _graph(fake_cuda, _stand_in_decode((300, 8), frozen), _pool_kv())
    g.capture()
    assert g.captured and len(fake_cuda.captures) == 1
    (_, pool, stream, mode), = fake_cuda.captures
    assert (pool, stream, mode) == ((7, 0), fake_cuda.stream, "thread_local")
    # the eager run before the capture launched; the capture did not
    assert tpaged.paged_decode_attention.launches == LAYERS
    assert g.launches == {"paged_decode_attention": LAYERS}
    # both the eager run and the capture ran with the scratch frozen, and
    # neither replaced it
    assert frozen == [True] * (2 * LAYERS) and not trpa._frozen
    assert trpa._scratch[(None, _Stream.cuda_stream)] == (part, counters)
    for n in range(1, 4):
        g.replay()
        assert tpaged.paged_decode_attention.launches == (1 + n) * LAYERS
    assert g._graph.replays == g.replays == 3
    assert g.nxt.tolist() == [1, 1] and g.pos_next.tolist() == [1, 1]


def test_capture_needs_the_scratch_reserved_for_the_largest_key(
        fake_cuda):
    frozen = []
    g = _graph(fake_cuda, _stand_in_decode((300, 8), frozen), _pool_kv())
    with pytest.raises(RuntimeError, match="reserve the pool"):
        g.capture()
    fake_cuda.reserve([(100, 8)])
    with pytest.raises(RuntimeError, match="largest key before the first"):
        g.capture()
    assert not g.captured and not trpa._frozen
    assert tpaged.paged_decode_attention.launches == 0
    # outside a capture the scratch grows, and a smaller launch reuses it
    part, _ = trpa._split_scratch(CPU, 1, 300, 8)
    assert trpa._split_scratch(CPU, 1, 200, 4)[0] is part
    with trpa.frozen_scratch():
        assert trpa._split_scratch(CPU, 1, 300, 8)[0] is part
        with pytest.raises(RuntimeError, match="reserve it"):
            trpa._split_scratch(CPU, 1, 301, 8)


def test_split_scratch_size_follows_the_decode_plan():
    # serve's bucketed decode on 132 SMs: 8 rows x 8 kv heads fill 64 CTAs,
    # a window of 32 blocks of 16 keys allows 2 splits of 4 key tiles
    assert trpa.split_scratch_size(8, 1, 32, 8, 128, 16, 32, 132) == \
        (2 * 8 * 32 * 130, 8 * 8)
    # a grid that fills the card is not split: no scratch
    assert trpa.split_scratch_size(32, 1, 32, 8, 128, 16, 256, 132) == (0, 0)
    # the full 4096-token window of a lone row splits the most
    n1, c1 = trpa.split_scratch_size(1, 1, 32, 8, 128, 16, 256, 132)
    n8, c8 = trpa.split_scratch_size(8, 1, 32, 8, 128, 16, 256, 132)
    assert c1 == 8 and c8 == 64 and n1 == 16 * 32 * 130 < n8


def test_replay_checks_the_pool_addresses(fake_cuda):
    kv = _pool_kv()
    fake_cuda.reserve([(300, 8)])
    g = _graph(fake_cuda, _stand_in_decode((300, 8), []), kv)
    g.capture()
    g.replay()
    kv[1]["v"] = torch.zeros(8, 4, 1, 16)     # reallocated after capture
    with pytest.raises(RuntimeError, match="KV pool moved"):
        g.replay()


def test_replay_checks_the_cross_buffers(fake_cuda):
    """An mllama engine's graph holds the per-slot cross buffers and the
    cross tail's static inputs (padding rows: slot 0, gate 0, every state
    live), passes them to the step, and refuses to replay once a buffer
    was reallocated after capture."""
    kv = _pool_kv()
    cross = [{"k": torch.zeros(3, 7, 1, 16), "v": torch.zeros(3, 7, 1, 16)}]
    seen = []
    inner = _stand_in_decode((300, 8), [])

    def decode(*args, cross=None):
        seen.append(cross)
        return inner(*args)

    fake_cuda.reserve([(300, 8)])
    g = DecodeGraph((M, B), decode, None, kv, B, M, V, device="cpu",
                    pool=fake_cuda, cross_kv=cross, cross_text_len=7)
    assert g.inputs["slot_idx"].tolist() == [0] * B
    assert g.inputs["has_image"].tolist() == [0.0] * B
    assert g.inputs["cross_len"].tolist() == [7] * B
    g.capture()
    g.replay()
    bufs, has_image, slot_idx, cross_len = seen[-1]
    assert bufs is cross and has_image is g.inputs["has_image"]
    assert slot_idx is g.inputs["slot_idx"]
    assert cross_len is g.inputs["cross_len"]
    cross[0]["k"] = torch.zeros(3, 7, 1, 16)  # reallocated after capture
    with pytest.raises(RuntimeError, match="cross buffers moved"):
        g.replay()


def test_cpu_graph_runs_the_decode_eagerly():
    """No capture on the CPU: each replay is one eager call of the
    feedback decode on the static inputs, equal to ``make_decode`` on the
    same inputs and draws, with fresh draws each step."""
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.LlamaForCausalLM.from_state_dict(
        cfg, tllama.random_params(cfg, 0, device="cpu"))
    bs, bps = 16, 4
    kv = [{"k": torch.zeros(9, bs, cfg.n_kv_heads, cfg.head_dim,
                            dtype=torch.bfloat16),
           "v": torch.zeros(9, bs, cfg.n_kv_heads, cfg.head_dim,
                            dtype=torch.bfloat16)}
          for _ in range(cfg.n_layers)]
    g = DecodeGraph((bps, 2), runner.make_decode(
        cfg, bs, bps, 2, feedback=True), model, kv, 2, bps, cfg.vocab_size,
        device="cpu", pool=GraphPool(CPU))
    g.capture()
    assert not g.captured
    rng = np.random.default_rng(5)
    tables = np.array([[3, 4, 0, 0], [7, 0, 0, 0]], np.int32)
    a = g.inputs
    a["tokens"].copy_(torch.from_numpy(
        rng.integers(3, cfg.vocab_size, 2).astype(np.int32)))
    a["pos"].copy_(torch.tensor([20, 5], dtype=torch.int32))
    a["tables"].copy_(torch.from_numpy(tables))
    a["temp"].copy_(torch.tensor([0.0, 1.0]))
    gen = torch.Generator().manual_seed(0)
    seen = []
    for _ in range(3):
        g.draw(gen)
        u = g.uniforms.clone()
        seen.append(u)
        g.replay()
        want_kv = [{n: t.clone() for n, t in lay.items()} for lay in kv]
        with torch.inference_mode():
            _, want = runner.make_decode(cfg, bs, bps, 2)(
                model, want_kv, a["tokens"], a["pos"], a["tables"], u,
                a["temp"], a["topk"], a["topp"])
        assert torch.equal(g.nxt, want)
        assert g.pos_next.tolist() == [21, 6]
        # the greedy row's token is its readout's top id, and its logprob
        # the top logprob
        assert int(g.nxt[0]) == int(g.top_ids[0, 0])
        assert float(g.tok_lp[0]) == float(g.top_lp[0, 0])
    assert not torch.equal(seen[0], seen[1])
    assert g.replays == 3
