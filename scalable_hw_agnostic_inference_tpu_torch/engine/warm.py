"""Engine warmup: build the CLOSED executable set before readiness.

Port of ``scalable_hw_agnostic_inference_tpu/engine/warm.py``
(``warm_executables`` at ``:16``, ``_run_warm_calls`` at ``:114``) for the
text branches the port has: every prefill bucket x batch size, every
continuation key (the static-start ladder, or the one ragged entry), and
every soft-prefix prefill (``("prefix", bucket, P)``, ``warm.py:34-40``),
every decode key (context bucket x batch bucket) and, under speculative
decoding, every verify key of the same grid (``warm.py:99-104``, the
decode keys kept: a step without a draft replays one); under
``SHAI_FUSED_STEP``
the fused keys (one per batch bucket, and the chunk-only graph) replace the
decode grid and the ragged continuation (``warm.py:43-49``). With the
prefix cache on, the cached-admission ladder too (``warm.py:58-60,78-84``):
every ``(warm start, chunk bucket)`` pair of ``_cached_starts`` that fits
``max_model_len`` (``("cont", start_blocks, bucket)``), or every chunk
bucket that one can take (``("rcont", bucket)``), so that the warmed set is
the reference's key for key. Prefill and the
continuation run once eagerly here, which loads their kernels and primes
cuBLAS; each decode key is captured as a CUDA graph when ``_decode_for``
(or ``_verify_for``) builds it and replayed once here. Functions take the
engine explicitly.

An mllama engine's set is the same set with the cross signature
(``warm.py:39,70,135-163``): every prefill and continuation call takes the
text-only cross tail (zero keys, gates off), every decode and verify graph
holds the cross buffers, and the admission-time projection
(``runner.make_cross_kv`` and the slot write) runs once on zero states.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.sampling import sample_logits
from . import cross as _cross_mod


def warm_executables(eng, prefix_lens: Sequence[int] = (0,)) -> int:
    """Build the engine's closed executable set up front, so no request
    after readiness builds one (each later build counts as a recompile).
    Each ``P`` of ``prefix_lens`` past 0 adds the soft-prefix prefill of
    every bucket with ``0 < P < bucket`` (one sequence each; none on an
    mllama engine), the reference's ``:34-40``. Returns the number of
    executables built."""
    n = 0
    kmax = min(max(1, eng.ecfg.max_prefill_batch), eng.ecfg.max_num_seqs)
    batch_sizes = []
    k = 1
    while k <= kmax:
        batch_sizes.append(k)
        k *= 2
    for b in eng.buckets.buckets:
        for p in sorted(set(prefix_lens)):
            if p == 0:
                for kb in batch_sizes:
                    eng._prefill_for(b, kb)
                    n += 1
            elif 0 < p < b and eng._cross_kv is None:
                eng._prefill_for(b, 1, prefix_len=p)
                n += 1
    C = eng.buckets.max
    if eng._fused:
        # the chunk rides the fused keys built below: no continuation
        # function has a caller
        pass
    elif eng._ragged:
        # the chunk start is data: ONE continuation per chunk bucket, for
        # the chunked prompt and for every cached-admission bucket
        want = set()
        if eng.ecfg.max_model_len > C:
            want.add(C)
        if eng.cache.prefix_caching:
            for s in eng._cached_starts():
                for cb in eng.buckets.buckets:
                    if s + cb <= eng.ecfg.max_model_len:
                        want.add(cb)
        for cb in sorted(want):
            if ("rcont", cb) not in eng._prefill:
                eng._cont_for(0, cb)
                n += 1
    else:
        if eng.ecfg.max_model_len > C:
            # the static-start ladder: one continuation per chunk start
            start = C
            while start + C <= eng.ecfg.max_model_len:
                eng._cont_for(start // eng.ecfg.block_size)
                n += 1
                start += C
        if eng.cache.prefix_caching:
            # the cached-admission ladder: (warm start, chunk bucket)
            # pairs, the same _cached_starts list admission picks from
            bs = eng.ecfg.block_size
            for s in eng._cached_starts():
                for cb in eng.buckets.buckets:
                    if (s + cb <= eng.ecfg.max_model_len
                            and ("cont", s // bs, cb) not in eng._prefill):
                        eng._cont_for(s // bs, cb)
                        n += 1
    for m in eng._ctx_buckets:
        for bb in eng._batch_buckets():
            eng._decode_for(m, bb)   # captured here (fused: a fused key)
            n += 1
            if eng._drafter is not None:
                # the verify ladder mirrors decode's (ctx, batch) grid; the
                # decode keys stay in the set (a step with no draft falls
                # back to them)
                eng._verify_for(m, bb)
                n += 1
    if eng._fused:
        eng._chunk_graph()
    eng._run_warm_calls()
    eng._warmed = True
    # every executable built from here on is a bucket-miss recompile
    eng.obs.warmed_executables = eng.n_executables
    return n


def _run_warm_calls(eng) -> None:
    """Run every prefill and continuation once on null arguments (a null
    table writes into reserved block 0, which is allowed by contract),
    replay every decode graph once, and sample at every admission shape.
    Draws come from a generator of their own, so warmup leaves the
    engine's draws as they were."""
    dev = eng.device
    M = eng.ecfg.blocks_per_seq
    gen = torch.Generator(device=dev).manual_seed(0)

    def i32(*shape, value=0):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    with torch.inference_mode():
        for key, fn in list(eng._prefill.items()):
            if key[0] == "rcont":
                fn(eng.model, eng.cache.kv, i32(1, key[1]), i32(1, value=1),
                   i32(1, M), i32(1))
            elif key[0] == "cont":
                fn(eng.model, eng.cache.kv, i32(1, key[2]), i32(1, value=1),
                   i32(1, M), *_cross_mod.text_cross_args(eng, 1))
            elif key[0] == "prefix":
                _, bucket, P = key
                fn(eng.model, eng.cache.kv, i32(1, bucket - P),
                   i32(1, value=1), i32(1, M),
                   prefix=torch.zeros((1, P, eng.cfg.dim), device=dev))
            else:
                bucket, K = key
                _, logits = fn(eng.model, eng.cache.kv, i32(K, bucket),
                               i32(K, value=1), i32(K, M),
                               *_cross_mod.text_cross_args(eng, K))
                # the admission sampler at this batch size, per-row knobs
                sample_logits(logits, gen,
                              torch.ones(K, device=dev), i32(K),
                              torch.ones(K, device=dev))
                # and with the scalar knobs of a final chunk
                sample_logits(logits[:1], gen, 1.0, 0, 1.0)
        for graph in eng.graphs():
            graph.draw(gen)
            graph.replay()
        if eng._cross_kv is not None:
            # the admission-time projection and slot write, on zero states
            # (slot 0's rows are rewritten when a request takes it)
            per_layer = eng._cross_embed(eng.model, torch.zeros(
                (eng.cross_seq_len, eng.cfg.dim), device=dev))
            eng._cross_write(eng._cross_kv, per_layer, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
