#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, end to end.

    python3 chip_smoke.py                  # every phase (needs one card)
    python3 chip_smoke.py --phases build,flash,paged,ragged

Phases:
  1. ``card``   the card's name and power limit (nvidia-smi);
  2. ``build``  build every kernel from ``csrc/*.cu`` with nvcc (sm_90a);
  3. ``flash``  hold B1 (flash attention) against its plain version at
                Llama-3-8B prefill shapes and at mllama's cross shapes
                (non-causal over 6,404 vision states, lengths 1,601 to
                6,404: 8 rows at T=1 and T=5, one 512-token chunk), and
                time kernel, plain version, bound and the SDPA yardstick;
  4. ``paged``  the same for B2 (paged decode attention, the decode CTA of
                B3's walk) at decode shapes and at serve's shape, plus block
                sizes 8 and 24 and a group of 32 heads; B2 must return
                exactly B3's output with ``rows_per_table`` 1, and the
                split count and the in-kernel merge are measured against
                the alternatives; and speculative verify's shape (8
                sequences x k+1 = 5 rows over their tables repeated,
                lengths 1 to 2048), timed beside a bound of the unique
                bytes read;
  5. ``ragged`` the same for B3 (ragged paged attention) over bf16 and
                int8 pools at decode (split-K) and chunked-prefill
                continuation shapes (one table row shared through
                ``rows_per_table``, and copied per row); B2 given int8
                scales must return B3's result; and B3 over the fused
                step's mixed rows (one launch over row groups: 8 decode
                rows, lengths 1 to 4096, and a 512-token chunk at starts
                0, 512 and 2560, M=256), timed beside the decode-only and
                chunk-only launches it replaces; the verify shape over
                bf16 and int8 pools;
  6. ``int8_matmul`` B4, the W8A16 kernel (int8 weight-only
                projections, ``csrc/int8_matmul.cu``), against its plain
                version, the reference's ``(x @ Wq^T) * scale`` in bf16, at
                Llama-3-8B's projection shapes (q/o, k/v, gate/up, down,
                lm_head) and M in 1, 4, 8, 64 (the decode instantiation)
                and 128, 512, 2048 (the wide one): each output within
                ``INT8_ULPS`` bf16 ulps, which the plain version short of
                one 16-wide K slice must fail; kernel, plain version, bf16
                ``F.linear`` (the library yardstick) and the route the
                kernel replaced past 64 rows (the dequantized copy and a
                GEMM) timed with the L2 flushed, beside the bound; every
                instantiation's registers with no spills; calls it does not
                take raise;
  7. ``tp_plan`` the tensor-parallel plan on one card (the flash,
                paged, ragged and int8_matmul phases also hold and time
                B1-B4 at one rank's shapes of ``TP_PLANS``): (a) the boot
                HBM gate: ``llama-8b-geometry`` at ``TP_GATE_BLOCKS``
                blocks refused with the budget's breakdown and
                ``memory_allocated()`` unchanged across it, the serve
                geometry booted and warmed; (b) Llama-3-8B at full width,
                ``TP_LAYERS`` of its 32 layers, seeded bf16, through the
                rank-local modules over the loopback group at tp 1, 2, 4,
                8 and int8 at 1 and 4: a 512-token prefill and 8 eager
                greedy steps over
                each rank's dense cache, the last logits within
                ``TP_RRMS`` of tp=1's with a control outside it, the
                tokens by the plain deficit rule, B1, B2 (and B4) launches
                exact a rank;
  7b. ``tp_engine`` the paged engine over tensor-parallel ranks
                (``engine/ranks.py``), Llama-3-8B widths, ``TPE_LAYERS``
                of the engine phases' 32 layers,
                seeded bf16, 8 requests of 5 to 1,300 tokens: (a) tp=1
                over an NCCL group of one, its decode keys captured as
                CUDA graphs with the all-reduce inside, tokens exactly the
                unsharded engine's and B1/B2 launches a replay equal; (b)
                tp=2 as two processes sharing the card over gloo (NCCL
                refuses two ranks on one device; eager decode): greedy
                tokens held to the unsharded engine's by the tie rule at
                ``TIE_TOL``, then temperature 0.8, both ranks' digests
                equal and no leaked block; (c) (b) under int8 weights,
                int8 KV and ragged attention (B3 and B4 at rank shapes),
                held to the unsharded int8 engine the same way;
  7c. ``tp_units`` the LLM units over tensor-parallel ranks
                (``serve/multihost.py``: the leader serves HTTP, the other
                ranks mirror ``generate_text``) on the seeded Llama-3.2-1B
                directory, ``TPU_NEW`` greedy tokens for ``TPU_PROMPTS``,
                ``/sentiment`` and a 400: (a) the ``llama`` unit as a
                group of one over NCCL through the env path
                (``SHAI_COORDINATOR``, ``SHAI_NUM_PROCESSES=1``,
                ``MESH_SPEC=tp=1``): tokens exactly the plain unit's, the
                decode steps captured with the all-reduce inside (a
                replay makes no collective call and equals the eager step,
                which makes them), B1 and B2 launches the plain unit's;
                (b) ``MESH_SPEC=tp=2`` as two gloo ranks sharing the card:
                tokens (a)'s or within ``TIE_TOL`` of the plain scoring
                forward, the follower's mirrored calls counted on both
                ranks (warmup, every request, the 400, ``/sentiment``),
                the follower alive after the 400, rank 0's B1 and B2 one a
                layer a prefill and a decode step; then
                ``llama-8b-geometry`` at full width and depth at tp=2 (one
                request, B1 32 a prefill and B2 32 a step), and the
                ``deepseek`` unit under ``QUANTIZATION=int8`` at tp=2 on
                two prompts: tokens the plain ``deepseek`` int8 unit's or
                within ``TIE_TOL`` of its scoring forward, rank 0's B1,
                B2 and B4 launches its launches (B4 seven a layer a
                forward); each tp=2 run's follower boots beside the plain
                unit it is held against, where there is one; (c) the
                refusals, each before
                any allocation or spawned process: tp=2 over NCCL on one
                card, ``SHAI_NUM_PROCESSES=3`` with tp=2, ``dp=2,tp=1``,
                the ``vllm`` unit's ``tensor_parallel_size: 2`` on one
                card, the ``bert`` unit at tp=2 (ROADMAP A7.3c);
  8. ``decode_graph`` one decode step at Llama-3-8B width
                (``ENGINE_LAYERS`` of its 32 layers, seeded weights) captured as a CUDA graph
                (``engine/graphs.py``) at serve's bucketed shape (B=8, a
                32-block bucket, bf16 pool) and at the ragged int8 full
                window (256 blocks, lengths 1 to 4096): the replay's
                tokens, positions and logprob readout (top ids, top
                logprobs, the sampled token's logprob) against the eager
                call of the same decode function on the same inputs and
                draws, bit for bit; fresh draws per replay; wall and
                device time per step, eager against replay, launches per
                step, capture time and the graph pool's bytes; the
                readout's own device time at serve's shape; then one
                speculative verify key of each (``runner.make_verify``,
                k=4, 40 rows): every output (``o``, ``oex``, ``accept_p``
                and the logprob readout) of the replay against the eager
                call on the same inputs and both sets of draws, bit for
                bit, its device time beside the decode key's;
  9. ``engine`` the engine at Llama-3-8B widths with seeded random weights,
                warmed (every decode key captured), one prompt chunked
                through the static-start continuation, half the rows
                asking for 5 logprobs: greedy tokens against the argmax
                of the full-sequence scoring forward over prompt +
                generated tokens, each sampled token's logprob against
                that forward's log-softmax (``LP_TOL``), under the default
                async decode and equal to a lock-step run's
                (``SHAI_ASYNC_DECODE=0``), logprob entries included;
 10. ``engine_ragged`` the same model under ``SHAI_RAGGED_ATTENTION=1``
                (bf16), ``SHAI_RAGGED_ATTENTION=1 SHAI_KV_QUANT=int8`` and
                ``SHAI_KV_QUANT=int8`` alone, each also equal to lock-step;
 11. ``engine_fused`` the same model under ``SHAI_RAGGED_ATTENTION=1
                SHAI_FUSED_STEP=1``, bf16 and then ``SHAI_KV_QUANT=int8``:
                async equal to lock-step, greedy tokens equal to the
                laddered ragged run's or parting only at a near-tie of its
                top-2 logprobs (``TIE_GAP``), B3 exactly the layers times
                the fused and chunk-only replays (no continuation
                function, no eager continuation launch);
 12. ``engine_spec`` the engine phase's model with speculative decoding
                (``[ngram]``, k=4, lookup 4 to 1): its prompts and a
                quoting one (bench.py's repetitive shape, 1,024 tokens,
                after 16 tokens of the model's own greedy continuation of
                it), 32 greedy tokens each, and one sampled request;
                bucketed bf16, then
                ragged + int8 KV: async equal to lock-step (every token and
                logprob entry), the greedy tokens against the spec-off
                engine by the tie rule (its gap ``TIE_GAP`` or twice the
                logprob change measured between the two runs, whichever
                is larger; int8: the int8 rule against its argmax hits)
                and the plain scoring forward by ``TIE_TOL``; B2/B3
                exactly the layers times the decode and verify replays
                (and the chunks), 0 recompiles, no leaked block, a
                rollback; acceptance, tokens per verify,
                the verify replay's device time against a decode
                replay's, TPOT spec on and off;
 13. ``engine_int8`` the engine phase's model quantized at boot
                (``ops.quant.quantize_state_dict``): one captured decode
                step and one captured verify step against their eager
                calls, bit for bit, each with 7 x ``ENGINE_LAYERS`` + 1
                int8 launches (the projections and the lm_head; the
                verify's 40 rows through B4's decode instantiation);
                then the engine bucketed (scored by the engine phase's
                tie rule) and under ``SHAI_RAGGED_ATTENTION=1
                SHAI_KV_QUANT=int8`` (engine_ragged's int8 rule), async
                equal to lock-step, every graph as many int8 launches,
                prefill and chunks through B4's wide instantiation, scored through the int8 model's
                plain route; then fused (every fused replay's window
                through the wide instantiation inside the graph);
 14. ``checkpoint`` a seeded Llama-3.2-1B-width checkpoint written here
                (bf16, tied embeddings, two safetensors shards under HF
                names, llama3 rope scaling, a byte-level BPE
                ``tokenizer.json`` built here in Llama-3's layout), served
                from ``MODEL_ID=<dir>`` in bf16 and with
                ``QUANTIZATION=int8``: the loaded tensors equal the written
                ones, ``/generate`` and ``/v1/completions`` answer, greedy
                tokens equal an engine built from the same state dict;
                load seconds and GB/s;
 15. ``engine_prefix`` the engine phase's model with
                ``enable_prefix_caching`` and ``SHAI_KVTIER=1`` over a
                160-block pool, one request at a time: a 1,024-token
                shared prefix cold, as a device hit (a 100-token
                remainder: the 128-token continuation key), demoted by two
                fillers, then restored from the host tier; bucketed,
                ragged + int8 KV, fused; tokens against the cache-off
                engine by the tie rule (an int8 run against the scoring
                forward, as engine_ragged's), async equal to lock-step,
                B1, B2 and B3 exactly the layers times each eager prefill
                and continuation call and each replay's captured launches,
                0 recompiles, no leaked block; TTFT of each admission, the
                restore's GB/s and a 64-block copy-out's ms, pinned and
                pageable;
 16. ``engine_mllama`` Llama-3.2-11B-Vision at full width and depth
                (seeded, built on the card; the vision encoder at 560 px,
                32 + 8 layers): the vision states of a ``"random"`` image
                (1 tile) and an in-script 1120 x 1120 array (2 x 2 tiles),
                timed with their peak memory; one batch of those two image
                rows, a text-only row and a 1,300-token image prompt (the
                cross continuation ladder), 16 greedy tokens each, async
                equal to lock-step, scored by the plain scoring forward
                with each row's vision states (``TIE_TOL``), the image
                rows' tokens unlike the same prompts text-only; B1 and B2
                exactly the layers times the prefill calls and the replays
                (8 B1 launches a decode or verify replay); a speculative
                round (k=4) held by the tie rule; the cross-KV
                projection's time, a decode replay against the same weights
                without the cross layers, B1's share of it, the graph pool
                and the cross buffers;
 17. ``serve_disagg`` a prefill-role, a decode-role and a monolithic pod
                on one seeded Llama-3.2-1B-width directory (written by the
                checkpoint phase's writer), in this process over
                localhost, each with the prefix cache and the tier: each
                handoff pulled over ``GET /kv/blocks``, the decode pod's
                greedy tokens equal to the monolithic pod's, the pulled
                and served blocks equal to the banked ones byte for byte,
                an injected ``kvnet.fetch`` fault recomputing with a 200;
                the pull's GB/s and share of TTFT, the ``shai_kvnet_*`` and
                ``shai_kvtier_*`` families;
 18. ``serve_fleet`` the fleet KV fabric and live migration on
                serve_disagg's 1B directory, every pod in this process over
                localhost: a prefill pod banks 1,250-token runs and a pod
                armed with ``SHAI_KVFABRIC_PEERS`` naming it admits the
                same prompts warm from its tier through B1 while a decode
                runs beside the probe (a holder without the run and an
                injected ``kvfabric.probe`` fault recompute); a pod armed
                with ``SHAI_MIGRATE_PEER_URL`` drains with 4 requests 32
                tokens in and ships them, each ``{"resume": ...}`` replayed
                on the peer returns the whole output; bucketed bf16 (B1,
                B2), ragged int8 KV (B3), then one ``migrate.ship`` fault
                (the cold replay) and one ``migrate.restore`` fault (a
                recompute on the peer): the fabric's greedy tokens equal
                the fabric-off pod's (the tie rule), the resumed outputs
                held by the engine phases' scoring rules (bf16
                ``TIE_TOL``, int8 the int8 rule against the unmigrated
                run) beside their partings from the unmigrated pod's
                tokens, the ``shai_migrate_*`` and ``shai_kvfabric_*``
                counts, no leaked block; envelope
                bytes, ship and accept seconds, the restore, cut to the
                resumed request's next token beside a recompute's TTFT,
                the probe's seconds, blocks and GB/s, the step it ran in;
 19. ``serve``  serve ``llama-8b-geometry`` over HTTP (the unit a user runs,
                its closed set warmed before readiness) and answer 8
                concurrent ``POST /generate``; then an OpenAI round: 8
                concurrent streamed ``POST /v1/completions`` (the client's
                time to the first SSE chunk beside the engine's TTFT),
                ``n=2``, ``logprobs: 5`` (every sampled logprob
                ``-log(128256)`` within ``GEOMETRY_LP_ATOL``: zero weights
                give a uniform distribution), an expired
                ``X-SHAI-Deadline-Ms`` (504) and a ``/metrics`` scrape
                holding the ``shai_*`` contract families;
 20. ``serve_int8`` serve's tier, requests and switches with
                ``QUANTIZATION=int8`` (born int8): the weights pool exactly
                8,561,882,112 bytes, 225 int8 launches per replay, B4's
                decode and wide launches counted, beside serve's numbers;
 21. ``serve_ragged`` the same unit with ``SHAI_RAGGED_ATTENTION=1
                SHAI_KV_QUANT=int8`` and an engine ConfigMap of
                ``max_model_len`` 4096: two of the 8 prompts chunk;
 22. ``serve_fused`` the same with ``SHAI_FUSED_STEP=1 SHAI_KV_COW=1``
                (the chunks ride the fused graphs' replays), then one
                ``n=4`` completion admitted as one prefill with 3
                copy-on-write forks; its numbers beside serve_ragged's;
 23. ``serve_spec`` ``llama-8b-geometry`` with ``speculative_model:
                "[ngram]"`` and ``num_speculative_tokens: 4`` in its
                ConfigMap (``SERVE_SPEC_CONFIG``), ``BATCH_SIZE=8``: 8
                concurrent ``POST /generate`` of 128-token repetitive
                prompts asking for 128 greedy tokens, then the same round
                on the unit with speculation off: every token id 0 in both
                (zero weights), ``shai_spec_*`` on ``/metrics`` and the
                counters on ``/stats`` equal to the engine's, 0
                recompiles; tokens per verify, TPOT and the device busy
                share beside spec off;
 24. ``serve_mllama`` the unit on a seeded mllama directory written here
                in HF layout (full widths; text 10 layers with cross
                layers at 3 and 8, vision 8 + 2 layers): 8 concurrent
                ``POST /generate`` (4 PNG images of two sizes, 2
                ``"random"``, 2 text-only repeating two image prompts),
                the image rows unlike their prompts text-only, 400 for a
                malformed image and a JPEG, ``shai_hbm_cross_kv_bytes`` on
                ``/metrics``, the profiled pass, 0 recompiles; before
                them, the PNG decode and the tiling timed on the host on
                1080p and 12 MP all-Paeth PNGs;
 25. ``engine_sd`` Stable Diffusion 2.1 at full width and depth (UNet
                320/640/1280/1280, OpenCLIP-H's 23 layers, the VAE),
                seeded, through ``models.sd.StableDiffusion``: 512 x 512,
                25 DDIM steps, guidance 7.5 at batch 1 and 4, and 768 x 768
                under v-prediction at 10 steps; B1 exactly 32 launches a
                UNet forward and 23 a text encode; a 4-step run through B1
                against the same run through B1's plain version (at 512
                and at 768 px), a
                request's image in a batch of 4 against it alone
                (``SD_IMAGE_*``), the same seed twice bit for bit, the
                conditioning against the fp32 plain forward on the CPU
                (``SD_TEXT_RRMS``); ms per UNet step at UNet batch 2 and 8
                (wall, device, B1's share), text encode, VAE decode and
                PNG encode ms, images/s, peak bytes, the profiled run's
                busy share and device time by class; the flash phase
                holds B1 at every shape of SD2.1's that these phases give
                it (``SD_FLASH``);
 26. ``serve_sd`` the ``sd2`` unit on a seeded stable-diffusion-2-1-base
                directory written here (diffusers' layout, fp16 UNet and
                text encoder, a synthetic CLIP vocabulary), ``SD_BATCH_MAX
                =4``, 512 px, 25 steps, every bucket warmed before
                readiness: 4 concurrent ``POST /genimage`` (released from
                one barrier, the unit's own 20 ms window) as one batch-4
                denoise (``/stats``' ``coalesced_*``), a solo request, a
                400, the PNGs decoded back; B1 exactly 23 + 32 x 25 a
                batch; latency p50/p99, ``/metrics``, the traced round's
                busy share;
 27. ``engine_flux`` FLUX.1 at full width and depth (19 + 38 blocks of
                3,072, T5-XXL's 24 layers, CLIP-L, the FLUX VAE), seeded
                on the card, through ``models.flux_pipeline``: (a) schnell
                at 512 px, 4 steps, 256 T5 tokens (wall and device time,
                the text encode, a step and the VAE decode, peak bytes, B1
                exactly 12 + 57 x 4 launches and its share of a step); (b)
                dev's geometry at 1,024 px, 512 T5 tokens, the guidance
                embedding, 2 steps; (c) the 4-step image through B1
                against B1's plain version (``FLUX_IMAGE_*``), which a
                coarse-score control must fall outside; (d) a seed
                twice bit for bit; (e) finite; the flash phase holds B1 at
                Flux's shapes (``FLUX_FLASH``, (xi) and (xii) timed);
 28. ``serve_flux`` the ``flux`` unit on a seeded FLUX.1-schnell directory
                written here (the BFL single file, full widths, 2 + 4
                blocks, T5 at 2 layers, a synthetic Unigram
                ``tokenizer_2/``), ``SUBMESH=0:1``: a few ``POST
                /genimage``, a 400, B1 exactly (12 + 6 x 4) a request, no
                shape first run after warmup; then the ``t5`` unit on its
                ``text_encoder_2/``: ``/embed``, the 400, no kernel;
 28b. ``tp_diffusion`` the ``t5`` and ``flux`` units over tensor-parallel
                ranks (``serve/multihost.py``) on serve_flux's seeded
                directory, 512 px, 4 steps, ``TPD_PROMPTS``: (a) each as
                a group of one over NCCL through the env path
                (``SHAI_COORDINATOR``, ``SHAI_NUM_PROCESSES=1``):
                ``/embed`` equal to the plain unit's element for element,
                the PNG equal byte for byte, B1 launches the plain
                unit's (12 + 6 x 4 a request); (b) two gloo ranks sharing
                the card: ``t5`` at ``MESH_SPEC=tp=2``, ``/embed`` within
                ``T5_TP_RRMS`` of the plain unit's, a control (layer 0's
                o all-reduce one partial short) outside it; ``flux`` at
                ``SUBMESH=0:2``, the image within ``FLUX_IMAGE_*`` of the
                plain unit's; rank 0's B1 launches 12 + 6 x 4 a request
                and the follower's 6 x 4 (read through a mirrored call),
                every mirrored call counted on both ranks (warmup, the
                requests, the 400s for a steps value outside the set and
                a bad knob), the follower alive after them and exiting
                with 0; (c) the refusals before any allocation or spawn:
                both units with ``SHAI_NUM_PROCESSES=2``, ``t5`` at tp=3
                (64 heads), ``flux`` over a ``SUBMESH`` past the cards,
                tp=2 over NCCL on one card; the flash phase holds B1 at
                the ranks' heads (``FLUX_RANK_FLASH``, timed);
 29. ``serve_encoders`` the ``bert``, ``vit`` and ``yolo`` units, each
                on a seeded HF-layout directory at published widths
                written here (DistilBERT-base-uncased-SST-2 with a
                synthetic 30,522-entry WordPiece ``tokenizer.json``,
                ViT-base-patch16-224, YOLOS-tiny at 512 x 864): 3
                requests over HTTP each (PNGs from the port's encoder and
                ``"random"``), B1 exactly 6, 12 and 12 launches a request
                and nothing else launched, latency and a forward's device
                time; the encoder's output through B1 against B1's plain
                version (``ENCODER_RRMS``), which bert's control (a key
                less) must fall outside; a mask that is no prefix raises
                on the card; the flash phase holds B1 at these shapes
                (``ENCODER_FLASH``, (xiii)-(xv));
 30. ``serve_causal`` the ``llama`` unit on the seeded 1B-width
                directory: ``/generate`` greedy and ``/sentiment``, B1
                exactly one launch a layer a prefill and B2 one a layer a
                decode step, the 400 past ``MAX_NEW_TOKENS``; its greedy
                tokens against the plain scoring forward (``TIE_TOL``),
                and the ``vllm`` unit's greedy tokens on the same
                directory and prompts, all 16 a stream, against the same
                forward by the same rule (and their logprobs by
                ``LP_TOL``); a decode step's CUDA graph replay against
                its eager run bit for bit; ``deepseek`` with
                ``QUANTIZATION=int8`` (B4 one launch a projection a
                forward); then
                ``llama-8b-geometry`` at full width and depth, one
                128-token generate: ms a token, B1 and B2 launches; the
                flash and paged phases hold B1 at the dense prefill
                (``DENSE_FLASH``) and B2 over the dense cache's pool view
                (``DENSE_PAGED``);
 31. ``serve_ops`` serve's configuration under the operating layer
                (``SERVE_OPS_ENV``: ``MAX_INFLIGHT=8``, tracing, the fault
                endpoint armed, a perf projection of 50 tok/s over a 5 s
                window, a 2 s watchdog floor, a 60 s drain budget): the
                plain round beside serve's TPOT and step gap; the HBM
                ledger against the caching allocator (one tick with the
                engine idle); 16 concurrent requests shed to 429 with
                ``Retry-After``, counted on ``shai_shed_total``; one
                idempotency key four times (one engine admission); a
                ``traceparent`` round trip through ``/trace/{id}`` and
                ``/debug/flight``; the perf sentinel degraded by a 0.25 s
                ``engine.step`` delay and healthy again; a 3 s step stall
                failing ``/health`` and recovering with the graphs
                replaying on; ``/benchmark``, ``/load`` and ``/serve``;
                then the drain (readiness ``draining``, 503 with
                ``Retry-After``, the in-flight requests finishing, the loop
                stopped with no replay in flight) and the operating
                ``/metrics`` families.

Each engine and serve phase (and the serve phase's OpenAI round) zeroes
the launch counters just before its run and requires exactly its own
kernels to have risen just after, and B2's or B3's count to be exactly
the layers times the graph replays (plus, for B3 on the laddered engine,
the layers times the ragged continuation chunks); the serve phases also
require 0 recompiles after warmup and the warmed executable count
unchanged.
Every engine a phase builds logs its boot HBM gate's ``describe()`` line,
and after its warmup its measured peak (``_watch_engines``); the run then
lists them all on one line.
Any failed phase makes the script exit non-zero without the result lines.
A full run prints the card's name and power limit, then, second to last,
``{"kernels": [...]}`` (per kernel: route, source, the TPU kernel it
replaces, launches in the serve phase that runs it, max error,
kernel/plain/bound/library times, and its launches at the cached callers
of engine_prefix, serve_disagg and serve_fleet; B1 also its cross shapes
and launches in engine_mllama and serve_mllama, its LLaVA shapes, its
SD2.1 shapes and launches in engine_sd and serve_sd, its Flux shapes
and launches in engine_flux and serve_flux, and its Flux rank shapes and
launches in tp_diffusion; B3 also its fused
mixed-row launch; B2 and B3 their verify shape and verify replays'
launches, in serve_spec and engine_spec (b);
B4's decode and wide instantiations, which replace XLA's fused int8 dot
and no Pallas kernel, ``tpu_kernel: null``, bf16 ``F.linear`` as their
library time and the replaced route's time) and,
last, ``{"ok": true, "device":
{...}}``. It exits non-zero at once when CUDA is unavailable or the port's
package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
from pathlib import Path

PHASES = ("card", "build", "flash", "paged", "ragged", "int8_matmul",
          "tp_plan", "tp_engine", "tp_units", "decode_graph", "engine",
          "engine_ragged", "engine_fused",
          "engine_spec", "engine_int8", "checkpoint", "engine_prefix",
          "engine_mllama", "engine_llava", "serve_disagg", "serve_fleet",
          "serve", "serve_int8", "serve_ragged", "serve_fused",
          "serve_spec", "serve_mllama", "serve_llava", "engine_sd",
          "serve_sd", "engine_flux", "serve_flux", "tp_diffusion",
          "serve_encoders",
          "serve_causal", "serve_ops")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# kernel vs plain version: the plain version runs in fp32 on the same
# values (inputs upcast, output not rounded), and each output vector (one
# query and head, D values) must hold max |out - ref| <= KERNEL_ATOL +
# KERNEL_RRMS * rms(ref vector). Error model, u = 2^-8 (bf16 unit
# roundoff): B1 rounds P to bf16 before P.V and both kernels round the
# output, each at most u relative, so over D = 128 values the error stays
# near 6u * rms = 0.023 rms; 0.05 leaves twice that. A walk that loses the
# last k of n live keys moves each value by about sqrt(k/n) rms (0.06 rms
# at 8 of 2048, some of 128 values three times that), which this fails:
# every case also checks that the plain version with each row's length cut
# by DROPPED_KEYS fails it. KERNEL_ATOL only admits fp32 noise, so a
# length-0 row must come out as zeros.
KERNEL_ATOL = 1e-6
KERNEL_RRMS = 0.05
DROPPED_KEYS = 8

# engine vs scoring forward: logits of the random-weight model are O(1-5);
# the two paths round bf16 activations in different places over 32 layers
# (batched prefill vs single-sequence scoring, paged decode vs full
# causal attention), so a token may differ only where the scoring
# forward's logit for it is within this much of its maximum. The bucketed
# engine's tokens are scored by the scoring forward through B1's plain
# version (fp32 attention), so that the bar does not move with B1. The
# same engine through the kernels' plain versions, the reference semantics
# on the same card, misses that forward's argmax by 0.125 (0.156 for the
# ragged bf16 engine): the rounding of the rest of the model alone, so a
# bar of 0.1 fails the reference itself. 0.25 leaves 1.6x the larger; a
# wrong cache, table or mask gives tokens whole logits below the maximum.
TIE_TOL = 0.25
# the fused engine against the laddered ragged engine: greedy tokens may
# part only where the laddered run's top-2 logprobs are this close
# (``tests/parity.py``'s tie rule: bf16 rounding of a logit of a few units)
TIE_GAP = 3e-2
# The ragged and int8 runs are scored by the scoring forward through B1,
# and also through B1's plain version: the largest logit change between
# the two scoring forwards, eps, is what a rounding-level change of the
# attention arithmetic does to this model. If the engine's logits are
# within eps of the scoring forward's, its argmax is within 2 * eps of the
# scoring maximum, which the ragged bf16 run must hold.
NOISE_TIES = 2.0
# An int8 KV pool changes the numbers, not only their rounding, and this
# random-weight model's logits are flat (top-2 gaps of a few tenths among
# 128,256 tokens), so int8 flips many near-ties. An int8 run must stay
# within 2 * eps, and make as many of its tokens the scoring argmax as the
# same engine run through the kernels' plain versions (the reference
# semantics on the same card), less this share of the tokens: the two runs
# decode freely and part after their first flip.
INT8_SLACK = 0.1

# engine logprobs vs the scoring forward: each sampled token's logprob
# (the decode graph's readout, or the prefill's for the first token) must
# be within LP_TOL of the log-softmax of the full-sequence scoring forward
# through B1's plain version at that position. The same rounding that
# puts the engine's greedy token up to 0.156 below the scoring forward's
# maximum logit (TIE_TOL) moves a token's logit and, far less, the
# log-sum-exp over 128,256 logits, so it takes TIE_TOL.
LP_TOL = TIE_TOL
# the geometry tier's zero weights give all-equal logits: every logprob is
# -log(vocab) up to the f32 rounding of a log-sum-exp over 128,256 terms
GEOMETRY_LP_ATOL = 1e-5

#: the engine phases' model: Llama-3-8B's widths at 16 of its 32 layers
#: (the depth cut keeps the full smoke inside 85% of its time since the
#: tp phases joined it; every check counts from the config's layers)
ENGINE_LAYERS = 16
ENGINE_NEW_TOKENS = 16
# mllama's cross attention through B1 (non-causal, lengths = each row's
# valid vision states) at Llama-3.2-11B-Vision's shapes: decode (T = 1),
# speculative verify (T = k + 1 = 5) over 8 rows of 1 to 4 tiles (1,601
# states a tile, Lv = 6,404), and a 512-token prefill chunk over one tile
MLLAMA_LV = 6404
_TILES = [1601, 3202, 4803, 6404] * 2
MLLAMA_FLASH = [
    (8, 1, MLLAMA_LV, 128, _TILES, False, True),
    (8, 5, MLLAMA_LV, 128, _TILES, False, True),
    (1, 512, MLLAMA_LV, 128, [1601], False, True),
]
# the engine phases' prompts: 1300 tokens chunk 512 + 512 + 276 under the
# (128, 512) buckets; the engine phase also keeps slice 1's 120
#: B1 at the soft-prefix VLM's shapes (B, T, S, H, Hkv, D, lengths,
#: causal, timed): LLaVA-1.5-7B's CLIP tower (577 tokens, 16 heads of 64,
#: non-causal, no lengths) and its prefix prefill (the 2048 bucket, 32
#: heads over 32, causal, the 576 image tokens and 300 of text); then MHA
#: cases just past a tile, non-causal with and without lengths
LLAVA_FLASH = [
    (1, 577, 577, 16, 16, 64, None, False, True),
    (1, 2048, 2048, 32, 32, 128, [876], True, True),
    (2, 577, 577, 16, 16, 64, [577, 300], False, False),
    (2, 65, 65, 8, 8, 64, None, False, False),
    (2, 129, 129, 4, 4, 128, [129, 70], False, False),
    (2, 130, 130, 16, 16, 64, [130, 65], True, False),
    (1, 193, 257, 8, 8, 128, [257], True, False),
]
#: B1 at SD2.1's shapes (B, T, S, H, Hkv, D, lengths, causal, timed), each
#: non-causal with no lengths unless noted, B the UNet's batch (2 for one
#: image: [uncond; cond]): (vii) self-attention at the 64 x 64 level of a
#: 512 px image, 5 heads of 64; (viii) its cross-attention over the 77
#: text states (one partial key tile past a full one); (ix) the 96 x 96
#: level at 768 px; (x) the text encoder's causal 77 tokens, 16 heads;
#: then untimed every other shape engine_sd and serve_sd give B1
#: (``_sd_flash_untimed``)
SD_FLASH_TIMED = [
    (2, 4096, 4096, 5, 5, 64, None, False, True),
    (2, 4096, 77, 5, 5, 64, None, False, True),
    (2, 9216, 9216, 5, 5, 64, None, False, True),
    (2, 77, 77, 16, 16, 64, None, True, True),
]


def _sd_flash_untimed():
    """The UNet's four attention levels (latent side 1/8, 1/16, 1/32,
    1/64 of the image at 5, 10, 20 and 20 heads), self and cross over
    the 77 text states: at 512 px for UNet batches 2, 4 and 8 (images 1,
    2 and 4: engine_sd's batches and serve_sd's warmed buckets), at 768
    px for batch 2; the text encoder's causal 77 tokens at the same
    batches; less the timed rows."""
    rows, timed = [], {r[:6] for r in SD_FLASH_TIMED}
    for px, batches in ((512, (2, 4, 8)), (768, (2,))):
        for i, heads in enumerate((5, 10, 20, 20)):
            t = (px // 8 >> i) ** 2
            for B in batches:
                for S in (t, 77):
                    rows.append((B, t, S, heads, heads, 64, None, False,
                                 False))
    rows += [(B, 77, 77, 16, 16, 64, None, True, False) for B in (2, 4, 8)]
    return [r for r in rows if r[:6] not in timed]


SD_FLASH = SD_FLASH_TIMED + _sd_flash_untimed()
#: B1 at Flux's joint attention (B, T, S, H, Hkv, D, lengths, causal,
#: timed): 24 heads of 128 over 24, non-causal, no lengths; T = S = the
#: image tokens and the T5 tokens together: (xi) FLUX.1-schnell at 512 px
#: (1,024 + 256, engine_flux (a) and serve_flux), (xii) FLUX.1-dev at
#: 1,024 px (4,096 + 512, engine_flux (b)); untimed schnell at 1,024 px
#: (4,096 + 256) and CLIP-L's causal 77 tokens at 12 heads of 64 (the
#: pooled conditioning of every Flux request)
FLUX_FLASH = [
    (1, 1280, 1280, 24, 24, 128, None, False, True),
    (1, 4608, 4608, 24, 24, 128, None, False, True),
    (1, 4352, 4352, 24, 24, 128, None, False, False),
    (1, 77, 77, 12, 12, 64, None, True, False),
]
#: B1 at one tensor-parallel rank's heads of Flux's joint attention
#: (tp_diffusion; B, T, S, H, Hkv, D, lengths, causal, timed): 512 px
#: schnell's 1,280 tokens at 12 heads (tp=2, tp_diffusion (b)) and at 4
#: (tp=6, the manifest's SUBMESH=2:8), FLUX.1-dev's 4,608 at 12
FLUX_RANK_FLASH = [
    (1, 1280, 1280, 12, 12, 128, None, False, True),
    (1, 1280, 1280, 4, 4, 128, None, False, True),
    (1, 4608, 4608, 12, 12, 128, None, False, True),
]
#: B1 at the encoder units' shapes (B, T, S, H, Hkv, D, lengths, causal,
#: timed), non-causal, heads of 64 over as many kv heads: (xiii)
#: DistilBERT-base at the bert unit's 512 padded tokens, a request of 9
#: tokens and one that fills them; (xiv) ViT-base-patch16-224 (196
#: patches and the class token); (xv) YOLOS-tiny at 512 x 864 (1 + 32 x
#: 54 + 100 tokens, no multiple of a tile)
ENCODER_FLASH = [
    (1, 512, 512, 12, 12, 64, [9], False, True),
    (1, 512, 512, 12, 12, 64, [512], False, True),
    (1, 197, 197, 12, 12, 64, None, False, True),
    (1, 1829, 1829, 3, 3, 64, None, False, True),
]
#: B1 at the llama unit's dense-cache prefill, Llama-3-8B widths, causal
#: with the prompt's length: the 32- and the 512-token bucket
DENSE_FLASH = [
    (1, 32, 32, 32, 8, 128, [17], True, True),
    (1, 512, 512, 32, 8, 128, [333], True, True),
]
#: B2 over the dense cache seen as a pool of 16-slot blocks (label,
#: n_slots, lengths), Llama-3-8B widths: a 128-token generate over the 32
#: and the 512 bucket (160 and 640 slots), 64 steps in
DENSE_PAGED = [("dense n_slots=160", 160, [17 + 64]),
               ("dense n_slots=640", 640, [333 + 64])]
ENGINE_PROMPTS = (5, 37, 300, 1300)
SERVE_REQUESTS = 8
# serve_ragged's engine ConfigMap: the 8B counterpart of
# deploy/disagg/vllm-split-deploy.yaml's engine shapes, two buckets so
# that prompts past 512 tokens chunk
SERVE_RAGGED_CONFIG = {"max_model_len": 4096, "block_size": 16,
                       "max_num_seqs": 8,
                       "context_encoding_buckets": [128, 512],
                       "max_new_tokens": 16}

REPO = os.path.dirname(os.path.abspath(__file__))
TPU_PKG = "scalable_hw_agnostic_inference_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def _env(values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- timing ------------------------------------------------------------------


class Timer:
    """Median device time of one call, from CUDA events around each call.
    A 1 GiB write before every call evicts the 50 MB L2 (the real caller
    finds its operands cold) and keeps the device busy for some 0.3 ms
    while the host enqueues the call (a wrapper's checks, its scratch
    allocations, the launch), so host overhead stays out of the window. A
    256 MB write (80 us) was too short for the split-K wrapper on a slow
    host: its decode times doubled between two machines. :meth:`host`
    measures that host side on its own."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 2,
                 clean: bool = False) -> float:
        """``clean``: flush by reading the 1 GiB (a sum) instead of writing
        it, so the L2 holds clean lines: a bytes-bound kernel then pays no
        write-back of the flush's dirty lines, as in a decode step, whose
        earlier kernels mostly read weights."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if clean:
                self.flush.sum()
            else:
                self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def host(self, fn, reps: int = 50) -> float:
        """Host wall time of one call in ms: a wrapper's checks, plan,
        allocations and launch, without waiting for the device (the
        calls queue up behind each other, far from the launch queue's
        depth)."""
        fn()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        seconds = time.perf_counter() - t0
        self.torch.cuda.synchronize()
        return seconds / reps * 1e3


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ------------------------------------------------------------------


def phase_card(ctx):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    ctx["card"] = out
    log(f"card: {out}")


def phase_build(ctx):
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import _build

    t0 = time.monotonic()
    _build.build()
    _build.library()
    log(f"build: {len(_build.sources())} sources -> {_build.LIB_NAME} in "
        f"{time.monotonic() - t0:.1f} s (nvcc {_build.last_build_seconds:.1f}"
        f" s; 0 means already built)")
    # -Xptxas=-v: each kernel instantiation's registers and spills, named
    # kernel<D[, pool type]> from its mangled name
    import re

    name = "?"
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            m = re.search(
                r"((?:flash|decode|ragged|merge|groups|int8_matmul)_kernel)"
                r"ILi(\d+)E(a|13__nv_bfloat16|Li\d+E)?", line)
            name = line.strip() if m is None else (
                f"{m.group(1)}<{m.group(2)}"
                + {"a": ", int8", "13__nv_bfloat16": ", bf16"}.get(
                    m.group(3) or "", ", " + (m.group(3) or "")[2:-1])
                .rstrip(", ") + ">")
        elif "registers" in line or "spill" in line.lower():
            log(f"  ptxas: {name}: {line.split(':', 1)[-1].strip()}")


def _tolerance_share(out, ref) -> float:
    """Largest ``|out - ref|`` over its tolerance (see ``KERNEL_RRMS``);
    infinite when ``out`` holds a non-finite value."""
    import torch

    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        return float("inf")
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    tol = KERNEL_ATOL + KERNEL_RRMS * rms
    return ((out - ref).abs() / tol).max().item()


def _check_close(what: str, out, ref, dropped=None):
    """Fail unless ``out`` is finite and within the kernel tolerance of
    ``ref``, and unless ``dropped`` (the plain version with each row's
    last ``DROPPED_KEYS`` live keys left out) is not. Returns the largest
    absolute error and the shares of the tolerance used by ``out`` and by
    ``dropped``."""
    share = _tolerance_share(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    if share > 1.0:
        raise AssertionError(
            f"{what}: max |err| {err:.3e} uses {share:.2f} of the tolerance "
            f"{KERNEL_ATOL} + {KERNEL_RRMS} rms(ref), or is non-finite")
    d_share = None
    if dropped is not None:
        d_share = _tolerance_share(dropped, ref)
        if d_share <= 1.0:
            raise AssertionError(
                f"{what}: the tolerance is too loose: the plain version "
                f"without each row's last {DROPPED_KEYS} keys passes it "
                f"({d_share:.2f})")
    return err, share, d_share


def _cut(lens):
    return (lens - DROPPED_KEYS).clamp_min(1)


def _flash_case(torch, gen, B, T, S, H, Hkv, D, lengths, causal):
    q = torch.randn(B, T, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    lens = (None if lengths is None else
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    return q, k, v, lens


def _flash_work(B, T, S, H, Hkv, D, lengths, causal):
    """Bytes each input read once / output written once (keys only up to
    each row's length) and FLOPs over the live (query, key) pairs."""
    n_bytes = 2 * (2 * B * T * H * D)  # q in, o out
    pairs = 0
    for b in range(B):
        n = S if lengths is None else min(lengths[b], S)
        n_bytes += 2 * (2 * n * Hkv * D)
        for i in range(T):
            live = min(n, S - T + i + 1) if causal else n
            pairs += max(live, 0)
    if lengths is not None:
        n_bytes += 4 * B
    return n_bytes, 4 * D * H * pairs


def phase_flash(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    timer = ctx["timer"]
    H, Hkv = 32, 8
    # (B, T, S, D, lengths, causal, timed): Llama-3-8B prefill shapes;
    # lengths mix 1 and the full length; T < S (continuation) cases, one
    # whose causal offset S - T = 784 is no multiple of a key tile (the
    # static continuation at start 784); T = 100, no multiple of the query
    # tile; B = 4 at every other head size
    cases = [
        (1, 512, 512, 128, [512], True, True),
        (4, 512, 512, 128, [1, 100, 333, 512], True, True),
        (1, 2048, 2048, 128, [2048], True, True),
        (4, 2048, 2048, 128, [1, 700, 1500, 2048], True, True),
        (2, 512, 2048, 128, [2048, 1000], True, True),
        (1, 512, 1296, 128, [1296], True, True),
        (2, 100, 300, 128, [300, 37], True, False),
        (1, 512, 512, 128, None, False, False),
        (4, 512, 512, 64, [1, 100, 333, 512], True, True),
        (4, 512, 512, 192, [1, 100, 333, 512], True, True),
        (4, 512, 512, 256, [1, 100, 333, 512], True, True),
    ] + MLLAMA_FLASH
    small = [(64, 2, 256, 256, 8, 2, [200, 0], True),
             (192, 1, 128, 128, 8, 2, [100], True),
             (256, 2, 256, 256, 8, 2, [256, 77], True)]
    worst = 0.0
    rows = []
    for B, T, S, D, lengths, causal, timed in cases:
        line = _flash_row(ctx, torch, gen, fa, B, T, S, H, Hkv, D, lengths,
                          causal, timed)
        worst = max(worst, line["max_abs_err"])
        rows.append(line)
    # the soft-prefix VLM's shapes: the CLIP tower (MHA at D=64, 577 keys,
    # non-causal, no lengths) and the prefix prefill (MHA, causal); then
    # small MHA cases, T and S just past a tile, non-causal with and
    # without lengths
    llava = []
    for B, T, S, H_, Hkv_, D, lengths, causal, timed in LLAVA_FLASH:
        line = _flash_row(ctx, torch, gen, fa, B, T, S, H_, Hkv_, D, lengths,
                          causal, timed)
        worst = max(worst, line["max_abs_err"])
        if timed:
            llava.append(line)
    for D_, B, T, S, H_, Hkv_, lengths, causal in small:
        q, k, v, lens = _flash_case(torch, gen, B, T, S, H_, Hkv_, D_,
                                    lengths, causal)
        out = fa.flash_attention(q, k, v, causal=causal, lengths=lens)
        f32 = (q.float(), k.float(), v.float())
        ref = fa.flash_attention_reference(*f32, causal=causal, lengths=lens)
        dropped = fa.flash_attention_reference(*f32, causal=causal,
                                               lengths=_cut(lens))
        err, share, d_share = _check_close(f"flash_attention D={D_}", out,
                                           ref, dropped)
        worst = max(worst, err)
        if 0 in lengths and bool(out[lengths.index(0)].any()):
            raise AssertionError("flash_attention: a length-0 row is not 0")
        log(f"flash_attention: D={D_} B={B} T={T} lengths={lengths} "
            f"max |err| {err:.3e}, {share:.3f} of the tolerance (dropped "
            f"keys: {d_share:.2f})")
    # Stable Diffusion 2.1: the UNet's self- and cross-attention levels and
    # the text encoder's causal 77 tokens (no lengths: the 77 cross keys
    # end inside the second key tile, masked by S alone)
    sd = []
    for B, T, S, H_, Hkv_, D, lengths, causal, timed in SD_FLASH:
        line = _flash_row(ctx, torch, gen, fa, B, T, S, H_, Hkv_, D, lengths,
                          causal, timed)
        worst = max(worst, line["max_abs_err"])
        if timed:
            sd.append(line)
    ctx["flash_sd"] = sd
    # Flux: the joint attention of every double and single block
    flux_rows = []
    for B, T, S, H_, Hkv_, D, lengths, causal, timed in FLUX_FLASH:
        line = _flash_row(ctx, torch, gen, fa, B, T, S, H_, Hkv_, D, lengths,
                          causal, timed)
        worst = max(worst, line["max_abs_err"])
        if timed:
            flux_rows.append(line)
    ctx["flash_flux"] = flux_rows
    # one tensor-parallel rank's heads of the same (tp_diffusion)
    ctx["flash_flux_ranks"] = []
    for B, T, S, H_, Hkv_, D, lengths, causal, timed in FLUX_RANK_FLASH:
        line = _flash_row(ctx, torch, gen, fa, B, T, S, H_, Hkv_, D, lengths,
                          causal, timed)
        worst = max(worst, line["max_abs_err"])
        ctx["flash_flux_ranks"].append(line)
    # the encoder units (DistilBERT's padded keys, ViT, YOLOS) and the
    # llama unit's dense-cache prefill
    for key, table in (("flash_encoders", ENCODER_FLASH),
                       ("flash_dense", DENSE_FLASH)):
        ctx[key] = []
        for B, T, S, H_, Hkv_, D, lengths, causal, timed in table:
            line = _flash_row(ctx, torch, gen, fa, B, T, S, H_, Hkv_, D,
                              lengths, causal, timed)
            worst = max(worst, line["max_abs_err"])
            ctx[key].append(line)
    # one tensor-parallel rank's heads (TP_PLANS): the rank-local prefill
    # of tp_plan, 512 tokens causal
    ctx["flash_ranks"] = []
    for (H_, Hkv_), labels in _rank_heads().items():
        line = _flash_row(ctx, torch, gen, fa, 1, 512, 512, H_, Hkv_, 128,
                          [512], True, True)
        line["plans"] = labels
        worst = max(worst, line["max_abs_err"])
        ctx["flash_ranks"].append(line)
    # the summary row: the serving config's largest prefill bucket, batched
    ctx["flash"] = dict(rows[1], max_abs_err=worst)
    # mllama's cross shapes (non-causal over the vision states)
    ctx["flash_cross"] = rows[-len(MLLAMA_FLASH):]
    ctx["flash_llava"] = llava


def _flash_row(ctx, torch, gen, fa, B, T, S, H, Hkv, D, lengths, causal,
               timed):
    """One B1 case held against its plain version; a timed case also its
    ms beside the plain version's, SDPA's and its bound."""
    timer = ctx["timer"]
    q, k, v, lens = _flash_case(torch, gen, B, T, S, H, Hkv, D, lengths,
                                causal)
    out = fa.flash_attention(q, k, v, causal=causal, lengths=lens)
    f32 = (q.float(), k.float(), v.float())
    ref = fa.flash_attention_reference(*f32, causal=causal, lengths=lens)
    dropped = None if lens is None else fa.flash_attention_reference(
        *f32, causal=causal, lengths=_cut(lens))
    torch.cuda.synchronize()
    shape = (f"B={B} T={T} S={S} H={H} Hkv={Hkv} D={D} causal={causal} "
             f"lengths={lengths}")
    err, share, d_share = _check_close(f"flash_attention {shape}", out,
                                       ref, dropped)
    del f32, ref, dropped
    line = {"shape": shape, "max_abs_err": err, "tol_share": share,
            "dropped_keys_tol_share": d_share}
    if timed:
        ms = timer(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              lengths=lens))
        plain = timer(lambda: fa.flash_attention_reference(
            q, k, v, causal=causal, lengths=lens), reps=5)
        # yardstick only: SDPA with the equivalent boolean mask (none for
        # a non-causal call without lengths), K/V expanded to the query
        # heads outside the timed call
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous()
        kpos = torch.arange(S, device="cuda")
        mask = None
        if lens is not None:
            mask = (kpos[None, :] < lens.long()[:, None])[:, None, None, :]
        if causal:
            qpos = torch.arange(T, device="cuda") + (S - T)
            cm = (qpos[:, None] >= kpos[None, :])[None, None]
            mask = cm if mask is None else mask & cm
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask))
        del qt, kt, vt, mask
        host = timer.host(lambda: fa.flash_attention(
            q, k, v, causal=causal, lengths=lens))
        n_bytes, flops = _flash_work(B, T, S, H, Hkv, D, lengths, causal)
        bms, by = bound_ms(n_bytes, flops)
        line.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                    library_ms=lib, host_ms=host)
    log("flash_attention: " + json.dumps(line))
    return line


def _paged_case(torch, gen, B, H, Hkv, D, bs, N, M, lengths):
    q = torch.randn(B, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    perm = torch.randperm(N, generator=gen, device="cuda")
    tables = perm[: B * M].reshape(B, M).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def _paged_work(B, H, Hkv, D, bs, M, lengths):
    n_bytes = 2 * (2 * B * H * D) + 4 * B  # q in, o out, lengths
    toks = 0
    for n in lengths:
        live = min(n, M * bs)
        toks += live
        n_bytes += 4 * (-(-live // bs))    # the live table entries
    n_bytes += 2 * (2 * toks * Hkv * D)    # live K and V
    return n_bytes, 4 * D * H * toks


def _device_us_by_kernel(torch, fn, calls: int = 20):
    """``{kernel: (device us, launches)}`` per call of ``fn``, from a
    ``torch.profiler`` trace of ``calls`` calls (empty when the profiler
    records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us:
            t, n = out.get(e.key, (0.0, 0.0))
            out[e.key] = (t + us / calls, n + e.count / calls)
    return out


def _paged_plan_choices(torch, timer, pa, rpa, q, kp, vp, tables, lens):
    """B2 at one shape under each split count, with the decode CTA's last
    split merging (key ``"s"``) or a second launch merging (``"s+merge"``),
    and the second launch's share of the device time at the plan's split
    count (profiler, warm L2); returns a dict of the times."""
    rows, H, _ = q.shape
    _, bs, Hkv, _ = kp.shape
    planned = rpa.decode_plan(rows, H, Hkv, bs, tables.shape[1],
                              torch.cuda.get_device_properties(
                                  q.device).multi_processor_count)[1]
    times = {}
    for s in sorted({1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, planned}):
        for merge_in_kernel in (True, False):
            if s == 1 and not merge_in_kernel:
                continue
            times[(s, merge_in_kernel)] = timer(lambda: rpa._launch(
                pa.paged_decode_attention, q, kp, vp, tables, lens, None,
                None, None, 1, splits=s, merge_in_kernel=merge_in_kernel))
    by_kernel = _device_us_by_kernel(torch, lambda: rpa._launch(
        pa.paged_decode_attention, q, kp, vp, tables, lens, None, None, None,
        1, splits=planned, merge_in_kernel=False))
    merge_us = sum(us for k, (us, _) in by_kernel.items()
                   if "merge_kernel" in k)
    walk_us = sum(us for k, (us, _) in by_kernel.items()
                  if "decode_kernel" in k or "merge_kernel" in k)
    line = {"planned_splits": planned,
            "ms_by_splits": {f"{s}{'' if m else '+merge'}": t
                             for (s, m), t in times.items()},
            "second_launch_us": merge_us, "walk_us": walk_us,
            "second_launch_share": merge_us / walk_us if walk_us else None}
    log("paged_decode_attention plan: " + json.dumps(line))
    return line


def phase_paged(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    timer = ctx["timer"]
    D, bs, N = 128, 16, 1024
    long = [1, 17, 255, 512, 1000, 1500, 2047, 2048]
    # (label, B, H, Hkv, M, lengths, timed): decode shapes, a pool of N
    # shuffled blocks, lengths from 1 to 2048 (= M * bs); one truncated
    # context bucket; serve's decode step (its 8 prompts of 24 to 297
    # bytes, 8 tokens into decode, in its 32-block bucket); LLaVA-1.5-7B's
    # decode step, 32 heads over 32 (a group of one)
    cases = [
        ("B=1 M=128", 1, 32, 8, 128, [2048], True),
        ("B=8 M=128", 8, 32, 8, 128, long, True),
        ("B=8 M=64", 8, 32, 8, 64, [1, 16, 33, 300, 512, 777, 1000, 1024],
         False),
        ("serve B=8 M=32", 8, 32, 8, 32,
         [32, 71, 110, 149, 188, 227, 266, 305], True),
        ("MHA B=8 M=128", 8, 32, 32, 128, long, True),
    ]
    # (D, B, H, Hkv, M, bs, lengths): other head dims, block sizes 8 and
    # 24, groups of 32 heads (two m16 tiles), groups of one (MHA, the
    # soft-prefix VLM's Llama-2), each but two with a length-0 row
    small = [(64, 4, 4, 1, 32, 16, [1, 40, 0, 511]),
             (128, 3, 32, 32, 16, 16, [0, 77, 256]),
             (64, 2, 16, 16, 8, 24, [5, 190]),
             (192, 2, 8, 2, 8, 16, [70, 3]),
             (256, 2, 16, 2, 8, 16, [5, 128]),
             (128, 3, 32, 8, 16, 8, [0, 100, 128]),
             (128, 3, 32, 8, 10, 24, [0, 239, 240]),
             (128, 3, 32, 1, 16, 16, [0, 77, 256]),
             (256, 2, 32, 1, 8, 16, [0, 128])]
    worst = 0.0
    rows = {}
    for label, B, H, Hkv, M, lengths, timed in cases:
        q, kp, vp, tables, lens = _paged_case(torch, gen, B, H, Hkv, D, bs,
                                              N, M, lengths)
        out = pa.paged_decode_attention(q, kp, vp, tables, lens)
        f32 = (q.float(), kp.float(), vp.float(), tables)
        ref = pa.paged_decode_attention_reference(*f32, lens)
        dropped = pa.paged_decode_attention_reference(*f32, _cut(lens))
        torch.cuda.synchronize()
        shape = (f"B={B} H={H} Hkv={Hkv} D={D} bs={bs} N={N} M={M} "
                 f"lengths={lengths}")
        err, share, d_share = _check_close(
            f"paged_decode_attention {shape}", out, ref, dropped)
        del f32
        worst = max(worst, err)
        line = {"shape": shape, "max_abs_err": err, "tol_share": share,
                "dropped_keys_tol_share": d_share}
        if timed:
            ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, tables,
                                                         lens))
            plain = timer(lambda: pa.paged_decode_attention_reference(
                q, kp, vp, tables, lens), reps=5)
            host = timer.host(lambda: pa.paged_decode_attention(
                q, kp, vp, tables, lens))
            n_bytes, flops = _paged_work(B, H, Hkv, D, bs, M, lengths)
            bms, by = bound_ms(n_bytes, flops)
            line.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=None, host_ms=host)
            line["ms_clean_l2"] = timer(lambda: pa.paged_decode_attention(
                q, kp, vp, tables, lens), clean=True)
            line["plan"] = _paged_plan_choices(torch, timer, pa, rpa, q, kp,
                                               vp, tables, lens)
        if label == "B=8 M=128":
            _check_b2_is_b3(torch, pa, rpa, q, kp, vp, tables, lens)
        rows[label] = line
        log("paged_decode_attention: " + json.dumps(line))
    for D_, B, H_, Hkv_, M, bs_, lengths in small:
        q, kp, vp, tables, lens = _paged_case(torch, gen, B, H_, Hkv_, D_,
                                              bs_, B * M, M, lengths)
        out = pa.paged_decode_attention(q, kp, vp, tables, lens)
        f32 = (q.float(), kp.float(), vp.float(), tables)
        ref = pa.paged_decode_attention_reference(*f32, lens)
        dropped = pa.paged_decode_attention_reference(*f32, _cut(lens))
        err, share, d_share = _check_close(
            f"paged_decode_attention D={D_} bs={bs_}", out, ref, dropped)
        worst = max(worst, err)
        if 0 in lengths and bool(out[lengths.index(0)].any()):
            raise AssertionError("paged_decode_attention: a length-0 row is "
                                 "not 0")
        log(f"paged_decode_attention: D={D_} G={H_ // Hkv_} bs={bs_} "
            f"lengths={lengths} max |err| {err:.3e}, {share:.3f} of the "
            f"tolerance (dropped keys: {d_share:.2f})")
    # the llama unit's dense cache, seen as B2's pool (no copy)
    ctx["paged_dense"] = []
    for label, n_slots, lengths in DENSE_PAGED:
        line = _dense_paged_row(ctx, torch, gen, pa, n_slots, lengths)
        worst = max(worst, line["max_abs_err"])
        ctx["paged_dense"].append(line)
    # one tensor-parallel rank's heads (TP_PLANS) at the B=8 decode shape
    ctx["paged_ranks"] = []
    for (H_, Hkv_), labels in _rank_heads().items():
        line = _paged_rank_row(ctx, torch, gen, pa, H_, Hkv_, long)
        line["plans"] = labels
        worst = max(worst, line["max_abs_err"])
        ctx["paged_ranks"].append(line)
    # speculative verify's shape: 8 sequences x (k + 1) query rows over
    # their tables repeated k + 1 times
    ctx["paged_verify"] = _verify_case(torch, gen, timer, pa, rpa, "paged",
                                       False)
    # the summary row: the batch-8 decode step over a 128-block bucket
    ctx["paged"] = dict(rows["B=8 M=128"], max_abs_err=worst)
    ctx["paged_mha"] = rows["MHA B=8 M=128"]


def _dense_paged_row(ctx, torch, gen, pa, n_slots, lengths):
    """B2 over a dense cache's layer (``models.llama.init_cache``, one row
    of ``n_slots`` slots at Llama-3-8B widths, filled with normals) seen as
    its pool of ``DENSE_BLOCK``-slot blocks, held against its plain
    version and timed beside its bound and SDPA's call on the same
    cache."""
    import dataclasses

    from scalable_hw_agnostic_inference_tpu_torch.models import llama

    timer = ctx["timer"]
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=1)
    B, H, Hkv, D = len(lengths), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cache = llama.init_cache(cfg, B, n_slots, device="cuda")
    layer = cache.layer(0)
    layer.k.normal_(generator=gen)
    layer.v.normal_(generator=gen)
    kp, vp = layer.pools()
    tables = layer.tables
    q = torch.randn(B, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = pa.paged_decode_attention(q, kp, vp, tables, lens)
    f32 = (q.float(), kp.float(), vp.float(), tables)
    ref = pa.paged_decode_attention_reference(*f32, lens)
    dropped = pa.paged_decode_attention_reference(*f32, _cut(lens))
    torch.cuda.synchronize()
    bs, M = llama.DENSE_BLOCK, tables.shape[1]
    shape = (f"dense B={B} H={H} Hkv={Hkv} D={D} n_slots={n_slots} "
             f"bs={bs} M={M} lengths={lengths}")
    err, share, d_share = _check_close(f"paged_decode_attention {shape}",
                                       out, ref, dropped)
    # the library's call for the same function: the cache is contiguous
    # and the tables are the identity, so SDPA over each row's slots up to
    # the longest length (GQA in the call, K/V read as stored; a key mask
    # when the rows' lengths differ), held to the same reference
    L = max(lengths)
    kt = layer.k[:, :L].transpose(1, 2)
    vt = layer.v[:, :L].transpose(1, 2)
    mask = None
    if min(lengths) != L:
        mask = (torch.arange(L, device="cuda")[None, :]
                < lens.long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err, lib_share, _ = _check_close(f"SDPA on the dense cache {shape}",
                                         library()[:, :, 0], ref, dropped)
    del f32, ref, dropped
    ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, tables, lens))
    plain = timer(lambda: pa.paged_decode_attention_reference(
        q, kp, vp, tables, lens), reps=5)
    lib = timer(library)
    n_bytes, flops = _paged_work(B, H, Hkv, D, bs, M, lengths)
    bms, by = bound_ms(n_bytes, flops)
    line = {"shape": shape, "max_abs_err": err, "tol_share": share,
            "dropped_keys_tol_share": d_share, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "library": "SDPA (enable_gqa)", "library_max_abs_err": lib_err,
            "library_tol_share": lib_share,
            "host_ms": timer.host(lambda: pa.paged_decode_attention(
                q, kp, vp, tables, lens))}
    log("paged_decode_attention: " + json.dumps(line))
    return line


def _check_b2_is_b3(torch, pa, rpa, q, kp, vp, tables, lens):
    """B2 on a bf16 pool is B3's decode CTA with one table row per query
    row on B2's own tables: the same output bit for bit, each call raising
    its own wrapper's counter by one."""
    pa.paged_decode_attention.launches = 0
    rpa.ragged_paged_attention.launches = 0
    b2 = pa.paged_decode_attention(q, kp, vp, tables, lens)
    b3 = rpa.ragged_paged_attention(q, kp, vp, tables, lens,
                                    rows_per_table=1)
    torch.cuda.synchronize()
    counts = (pa.paged_decode_attention.launches,
              rpa.ragged_paged_attention.launches)
    if not torch.equal(b2, b3) or counts != (1, 1):
        raise AssertionError(f"paged_decode_attention is not B3 with "
                             f"rows_per_table=1 (equal {torch.equal(b2, b3)}"
                             f", launches B2/B3 {counts})")
    log("paged_decode_attention: B2 returned B3's output (rows_per_table=1) "
        "bit for bit; launches B2 1, B3 1")


#: speculative verify's attention shape (``runner.make_verify``): a batch
#: bucket of 8 sequences, k = 4 drafts, so 40 query rows, each sequence's
#: table repeated k + 1 times and its rows at lengths pos0 + 1 ... pos0 + 5;
#: the pos0 below span lengths 1 to 2048 over a 128-block window
VERIFY_BB, VERIFY_K = 8, 4
VERIFY_POS0 = (0, 16, 254, 511, 999, 1499, 2000, 2043)


def _verify_case(torch, gen, timer, pa, rpa, which: str, quant: bool):
    """B2 (``which`` "paged", bf16) or B3 ("ragged", bf16 or int8) at the
    verify shape against its plain version (fp32), timed beside the plain
    version and a bound that counts the UNIQUE bytes read: each sequence's
    live blocks and table once, though k + 1 rows walk them."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_kv_blocks,
    )

    H, Hkv, D, bs, N, M = 32, 8, 128, 16, 2048, 128
    T = VERIFY_K + 1
    rows = VERIFY_BB * T
    q = torch.randn(rows, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    ks = vs = None
    if quant:
        kp, ks = quantize_kv_blocks(kp)
        vp, vs = quantize_kv_blocks(vp)
    perm = torch.randperm(N, generator=gen, device="cuda")
    tables = perm[:VERIFY_BB * M].reshape(VERIFY_BB, M).to(torch.int32)
    rep = tables.repeat_interleave(T, dim=0).contiguous()
    lengths = [p + t + 1 for p in VERIFY_POS0 for t in range(T)]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if which == "paged":
        def run():
            return pa.paged_decode_attention(q, kp, vp, rep, lens)

        def plain(qq, ll):
            return pa.paged_decode_attention_reference(qq, kp, vp, rep, ll)
    else:
        def run():
            return rpa.ragged_paged_attention(q, kp, vp, rep, lens, ks, vs)

        def plain(qq, ll):
            return rpa.ragged_paged_attention_reference(qq, kp, vp, rep, ll,
                                                        ks, vs)
    out = run()
    ref = plain(q.float(), lens)
    dropped = plain(q.float(), _cut(lens))
    torch.cuda.synchronize()
    kind = "int8" if quant else "bf16"
    shape = (f"verify Bb={VERIFY_BB} k={VERIFY_K} ({rows} rows, tables "
             f"repeated {T}x) {kind}: H={H} Hkv={Hkv} D={D} bs={bs} N={N} "
             f"M={M} lengths 1..{max(lengths)}")
    name = ("paged_decode_attention" if which == "paged"
            else "ragged_paged_attention")
    err, share, d_share = _check_close(f"{name} {shape}", out, ref, dropped)
    del ref, dropped
    n_bytes, flops = _ragged_work(tables.cpu(), lens.cpu(), H, Hkv, D, bs,
                                  quant, row_table=[r // T
                                                    for r in range(rows)])
    bms, by = bound_ms(n_bytes, flops)
    line = {"shape": shape, "max_abs_err": err, "tol_share": share,
            "dropped_keys_tol_share": d_share, "ms": timer(run),
            "plain_ms": timer(lambda: plain(q, lens), reps=5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "host_ms": timer.host(run),
            "splits": rpa.ragged_plan(rows, 1, H, Hkv, bs, M, rpa.sm_count(
                q.device.index))[1]}
    log(f"{name}: " + json.dumps(line))
    return line


def _ragged_inputs(torch, gen, rows, H, Hkv, D, bs, N, M, lengths, quant,
                   tables_mode):
    """A shuffled pool of ``N`` blocks (int8 through the port's
    ``quantize_kv_blocks`` when ``quant``) and its tables: one table per
    row (``"own"``), one table copied to every row (``"repeated"``, the
    continuation layout as the TPU kernel takes it), or one table row
    that every row shares (``"shared"``, passed with ``rows_per_table``)."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_kv_blocks,
    )

    q = torch.randn(rows, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    perm = torch.randperm(N, generator=gen, device="cuda")
    tables = {"own": lambda: perm[: rows * M].reshape(rows, M),
              "repeated": lambda: perm[:M].repeat(rows, 1),
              "shared": lambda: perm[:M][None]}[tables_mode]()
    tables = tables.to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ks = vs = None
    if quant:
        kp, ks = quantize_kv_blocks(kp)
        vp, vs = quantize_kv_blocks(vp)
    return q, kp, vp, ks, vs, tables, lens


def _ragged_work(tables, lengths, H, Hkv, D, bs, quant, rows_per_table=1,
                 row_table=None):
    """Bytes each input read once / output written once and FLOPs over the
    live keys, for B3 on these tables and lengths: q in and out, the
    lengths, each table row's live entries once, the live tokens of each
    distinct live K/V block once (int8 at 1 byte, bf16 at 2) and, for
    int8, each such block's two f32 scales; 4·D·H FLOPs per live key.
    ``row_table``: each row's table row (row groups), else row //
    ``rows_per_table``."""
    tab, lens = tables.tolist(), lengths.tolist()
    rows, M = len(lens), len(tab[0])
    n_bytes = 2 * (2 * rows * H * D) + 4 * rows
    live_tok, live_entries = {}, {}
    toks = 0
    for r in range(rows):
        n = min(max(lens[r], 0), M * bs)
        toks += n
        nb = -(-n // bs)
        tr = r // rows_per_table if row_table is None else row_table[r]
        live_entries[tr] = max(live_entries.get(tr, 0), nb)
        for j in range(nb):
            blk = tab[tr][j]
            live_tok[blk] = max(live_tok.get(blk, 0), min(bs, n - j * bs))
    n_bytes += 4 * sum(live_entries.values())
    n_bytes += 2 * sum(live_tok.values()) * Hkv * D * (1 if quant else 2)
    if quant:
        n_bytes += 2 * 4 * Hkv * len(live_tok)
    return n_bytes, 4 * D * H * toks


def phase_ragged(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    timer = ctx["timer"]
    H, Hkv, D, bs, N = 32, 8, 128, 16, 2048
    # (label, rows, lengths, M, tables mode): Llama-3-8B heads over the
    # full window M of a shuffled pool; decode at M = 128 (lengths 1 to
    # 2048) and at M = 256, serve_ragged's window (lengths to 4096); the
    # continuation layout of a 512-token chunk at start 1024, with the
    # table copied per row and with one shared table row
    # (rows_per_table = 512); a 441-row tail chunk at start 2560, M = 256
    cont = [1024 + t + 1 for t in range(512)]
    cases = [
        ("decode B=8", 8, [1, 17, 255, 512, 1000, 1500, 2047, 2048], 128,
         "own"),
        ("decode B=1", 1, [2048], 128, "own"),
        ("continuation 512 rows, start 1024", 512, cont, 128, "repeated"),
        ("continuation 512 rows, start 1024, rows_per_table=512", 512, cont,
         128, "shared"),
        ("tail chunk 441 rows, start 2560, rows_per_table=441", 441,
         [2560 + t + 1 for t in range(441)], 256, "shared"),
        ("decode B=8 M=256", 8, [1, 300, 1000, 2047, 2500, 3333, 4000, 4096],
         256, "own"),
        ("decode B=1 M=256", 1, [4096], 256, "own"),
    ]
    # (D, H, Hkv, M, bs, lengths): other head dims and groups, length-0
    # rows, and the largest block size in deploy/'s ConfigMaps
    small = [(64, 4, 1, 32, 16, [1, 40, 0, 511]),
             (192, 8, 2, 8, 16, [70, 0]),
             (256, 16, 2, 8, 16, [0, 128]),
             (128, 32, 8, 4, 1024, [4096, 0, 1500])]
    worst = 0.0
    rows = {}
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        for label, R, lengths, M, mode in cases:
            q, kp, vp, ks, vs, tables, lens = _ragged_inputs(
                torch, gen, R, H, Hkv, D, bs, N, M, lengths, quant, mode)
            rpt = R if mode == "shared" else 1
            args = (q, kp, vp, tables, lens, ks, vs)
            out = rpa.ragged_paged_attention(*args, rows_per_table=rpt)
            qf = q.float()
            ref = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, lens, ks, vs, rows_per_table=rpt)
            dropped = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, _cut(lens), ks, vs, rows_per_table=rpt)
            torch.cuda.synchronize()
            shape = (f"{label} {kind}: H={H} Hkv={Hkv} D={D} bs={bs} N={N} "
                     f"M={M} lengths "
                     + (f"{lengths[0]}..{lengths[-1]}" if R > 8
                        else str(lengths)))
            err, share, d_share = _check_close(
                f"ragged_paged_attention {shape}", out, ref, dropped)
            del qf, ref, dropped
            worst = max(worst, err)
            ms = timer(lambda: rpa.ragged_paged_attention(
                *args, rows_per_table=rpt))
            plain = timer(lambda: rpa.ragged_paged_attention_reference(
                *args, rows_per_table=rpt), reps=5)
            host = timer.host(lambda: rpa.ragged_paged_attention(
                *args, rows_per_table=rpt))
            n_bytes, flops = _ragged_work(tables.cpu(), lens.cpu(), H, Hkv,
                                          D, bs, quant, rpt)
            bms, by = bound_ms(n_bytes, flops)
            plan = rpa.ragged_plan(
                R, rpt, H, Hkv, bs, M, torch.cuda.get_device_properties(
                    q.device).multi_processor_count)
            line = {"shape": shape, "max_abs_err": err, "tol_share": share,
                    "dropped_keys_tol_share": d_share, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": None, "host_ms": host,
                    "rows_per_tile": plan[0], "splits": plan[1]}
            if label == "decode B=8" and not quant:
                # B2 on the same inputs, in the same call
                line["b2_ms"] = timer(lambda: pa.paged_decode_attention(
                    q, kp, vp, tables, lens))
            if label == "decode B=8" and quant:
                _check_b2_delegates(torch, pa, rpa, q, kp, vp, ks, vs,
                                    tables, lens, bs)
            rows[(label, kind)] = line
            log("ragged_paged_attention: " + json.dumps(line))
            del q, kp, vp, ks, vs, tables, lens, args, out
        for D_, H_, Hkv_, M_, bs_, lengths in small:
            R = len(lengths)
            q, kp, vp, ks, vs, tables, lens = _ragged_inputs(
                torch, gen, R, H_, Hkv_, D_, bs_, R * M_, M_, lengths, quant,
                "own")
            out = rpa.ragged_paged_attention(q, kp, vp, tables, lens, ks, vs)
            qf = q.float()
            ref = rpa.ragged_paged_attention_reference(qf, kp, vp, tables,
                                                       lens, ks, vs)
            dropped = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, _cut(lens), ks, vs)
            err, share, d_share = _check_close(
                f"ragged_paged_attention D={D_} bs={bs_} {kind}", out, ref,
                dropped)
            worst = max(worst, err)
            if bool(out[lengths.index(0)].any()):
                raise AssertionError("ragged_paged_attention: a length-0 row "
                                     "is not 0")
            log(f"ragged_paged_attention: D={D_} G={H_ // Hkv_} bs={bs_} "
                f"{kind} lengths={lengths} max |err| {err:.3e}, {share:.3f} "
                f"of the tolerance (dropped keys: {d_share:.2f})")
    worst = max(worst, _mixed_rows(ctx, torch, rpa, timer, gen))
    # one tensor-parallel rank's heads (TP_PLANS) at the B=8 decode shape,
    # bf16 and int8 pools
    ctx["ragged_ranks"] = []
    for (H_, Hkv_), labels in _rank_heads().items():
        for quant in (False, True):
            line = _ragged_rank_row(ctx, torch, gen, rpa, H_, Hkv_, quant)
            line["plans"] = labels
            worst = max(worst, line["max_abs_err"])
            ctx["ragged_ranks"].append(line)
    ctx["ragged_verify"] = {
        kind: _verify_case(torch, gen, timer, pa, rpa, "ragged", quant)
        for kind, quant in (("bf16", False), ("int8", True))}
    # the summary row: the int8 batch-8 decode step, the serving path's
    # most frequent launch
    ctx["ragged"] = dict(rows[("decode B=8", "int8")], max_abs_err=worst)


def _mixed_rows(ctx, torch, rpa, timer, gen) -> float:
    """B3 over the fused step's mixed rows (``mixed_phase_ragged_attention``,
    one launch over row groups) at the fused serve shape: B=8 decode rows
    (lengths 1 to 4096) and a C=512 chunk at starts 0, 512 and 2560, M=256,
    block 16, Llama-3-8B heads, over bf16 and int8 pools. Each against the
    plain version (the same tolerance and dropped-keys check as every B3
    case), timed from a flushed L2 beside its bytes bound and the two B3
    launches it replaces (the decode rows alone, the chunk alone with
    ``rows_per_table`` 512). Returns the largest error."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.attention import (
        mixed_phase_groups,
        mixed_phase_ragged_attention,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_kv_blocks,
    )

    H, Hkv, D, bs, M, B, C = 32, 8, 128, 16, 256, 8, 512
    N = (B + 1) * M + 1
    dec_lens = [1, 300, 1000, 2047, 2500, 3333, 4000, 4096]
    worst, out_rows = 0.0, []
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        for start in (0, 512, 2560):
            # B + C query rows over B + 1 table rows of a shuffled pool
            q = torch.randn(B + C, H, D, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            kp, vp = (torch.randn(N, bs, Hkv, D, generator=gen,
                                  device="cuda", dtype=torch.bfloat16)
                      for _ in range(2))
            perm = torch.randperm(N, generator=gen, device="cuda")
            tables = perm[:(B + 1) * M].reshape(B + 1, M).to(
                torch.int32).contiguous()
            ks = vs = None
            if quant:
                kp, ks = quantize_kv_blocks(kp)
                vp, vs = quantize_kv_blocks(vp)
            q_dec, q_chunk = q[:B].contiguous(), q[B:].contiguous()
            t_dec, c_table = tables[:B].contiguous(), tables[B:].contiguous()
            pos_dec = torch.tensor([n - 1 for n in dec_lens],
                                   dtype=torch.int32, device="cuda")
            c_pos = torch.arange(start, start + C, dtype=torch.int32,
                                 device="cuda")
            lens = torch.cat([pos_dec, c_pos]) + 1
            groups = mixed_phase_groups(B, C)
            args = (q_dec, q_chunk, kp, vp, t_dec, c_table, pos_dec, c_pos,
                    ks, vs)
            o_dec, o_chk = mixed_phase_ragged_attention(*args)
            out = torch.cat([o_dec, o_chk])
            qf = q.float()
            ref = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, lens, ks, vs, groups=groups)
            dropped = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, _cut(lens), ks, vs, groups=groups)
            torch.cuda.synchronize()
            shape = (f"mixed rows {kind}: B={B} decode rows (lengths "
                     f"{dec_lens[0]}..{dec_lens[-1]}) + a C={C} chunk at "
                     f"start {start}, H={H} Hkv={Hkv} D={D} bs={bs} M={M}")
            err, share, d_share = _check_close(
                f"ragged_paged_attention {shape}", out, ref, dropped)
            del qf, ref, dropped, out
            worst = max(worst, err)
            lens_dec = lens[:B].contiguous()
            lens_chk = lens[B:].contiguous()
            ms = timer(lambda: mixed_phase_ragged_attention(*args))
            dec_ms = timer(lambda: rpa.ragged_paged_attention(
                q_dec, kp, vp, t_dec, lens_dec, ks, vs))
            chk_ms = timer(lambda: rpa.ragged_paged_attention(
                q_chunk, kp, vp, c_table, lens_chk, ks, vs,
                rows_per_table=C))
            plain = timer(lambda: rpa.ragged_paged_attention_reference(
                q, kp, vp, tables, lens, ks, vs, groups=groups), reps=3)
            n_bytes, flops = _ragged_work(
                tables.cpu(), lens.cpu(), H, Hkv, D, bs, quant,
                row_table=[min(r, B) for r in range(B + C)])
            bms, by = bound_ms(n_bytes, flops)
            plan = rpa.groups_plan(groups, H, Hkv, bs, M,
                                   torch.cuda.get_device_properties(
                                       q.device).multi_processor_count)
            line = {"shape": shape, "max_abs_err": err, "tol_share": share,
                    "dropped_keys_tol_share": d_share, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": None, "decode_alone_ms": dec_ms,
                    "chunk_alone_ms": chk_ms,
                    "two_launches_ms": dec_ms + chk_ms,
                    "rows_per_tile": plan[0], "decode_splits": plan[1]}
            out_rows.append(line)
            log("ragged_paged_attention mixed: " + json.dumps(line))
            del q, kp, vp, ks, vs, tables, args
    # the summary row: the int8 chunk at 2560 beside 8 decode rows
    ctx["ragged_mixed"] = out_rows[-1]
    return worst


def _check_b2_delegates(torch, pa, rpa, q, kp, vp, ks, vs, tables, lens,
                        bs):
    """B2 given int8 scales returns B3 on the caller's truncated tables,
    as the TPU kernel's int8 branch does: the same output as B3 called
    directly, with B3's counter rising and B2's not."""
    cut_t = tables[:, :64].contiguous()
    cut_l = lens.clamp_max(64 * bs)
    pa.paged_decode_attention.launches = 0
    rpa.ragged_paged_attention.launches = 0
    via_b2 = pa.paged_decode_attention(q, kp, vp, cut_t, cut_l, ks, vs)
    direct = rpa.ragged_paged_attention(q, kp, vp, cut_t, cut_l, ks, vs)
    torch.cuda.synchronize()
    counts = (pa.paged_decode_attention.launches,
              rpa.ragged_paged_attention.launches)
    if not torch.equal(via_b2, direct) or counts != (0, 2):
        raise AssertionError(f"paged_decode_attention with scales is not B3 "
                             f"(equal {torch.equal(via_b2, direct)}, "
                             f"launches B2/B3 {counts})")
    log("ragged_paged_attention: B2 with int8 scales returned B3's output "
        "exactly; launches B2 0, B3 2")


def _step_wall_ms(torch, fn, reps: int = 20) -> float:
    """Median wall ms of one call of ``fn`` from the host's enqueue to the
    device's end (a synchronize after each call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_step(torch, fn, calls: int = 10):
    """``(device ms, kernel launches)`` per call of ``fn`` (profiler);
    ``(None, None)`` when the profiler records no device activity."""
    by_kernel = _device_us_by_kernel(torch, fn, calls)
    if not by_kernel:
        return None, None
    return (sum(us for us, _ in by_kernel.values()) / 1e3,
            sum(n for _, n in by_kernel.values()))


def _graph_fixture(ctx, torch, B, M, quant, seed, rows):
    """What a captured graph case runs over: the generator (seeded), a pool
    of ``B * M + 1`` random blocks (int8 with random scales when
    ``quant``), ``B`` shuffled tables of ``M`` blocks, and a graph pool
    whose split scratch is reserved for ``rows`` attention rows."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.cache import (
        PagedKVCache,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
        GraphPool,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        ragged_paged_attention as rpa,
    )

    cfg, _ = _engine_model(ctx)
    N, bs = B * M + 1, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = PagedKVCache(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, N, bs,
                         M, dtype=torch.bfloat16, device="cuda", quant=quant)
    for lay in cache.kv:
        for name, t in lay.items():
            if name in ("ks", "vs"):
                t.uniform_(0.5 / 127, 3.0 / 127, generator=gen)
            elif quant:
                t.random_(-127, 128, generator=gen)
            else:
                t.normal_(generator=gen)
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = perm[: B * M].reshape(B, M).to(torch.int32)
    pool = GraphPool(torch.device("cuda", torch.cuda.current_device()))
    pool.reserve([rpa.split_scratch_size(
        rows, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, bs, M,
        rpa.sm_count(torch.cuda.current_device()))])
    return gen, cache, tables, pool


def _decode_graph_case(ctx, torch, what, lengths, ragged, quant, M):
    """One decode key at full width: a pool of random blocks behind
    shuffled tables, 8 rows at ``lengths`` (half greedy, half sampled),
    captured as a graph and held against the eager call of the same decode
    function on the same inputs and draws."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
        DecodeGraph,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.runner import (
        make_decode,
    )

    cfg, model = _engine_model(ctx)
    B, bs = len(lengths), 16
    gen, cache, tables, pool = _graph_fixture(ctx, torch, B, M, quant, 11, B)
    decode = make_decode(cfg, bs, M, B, ctx_blocks=M, ragged=ragged,
                         kv_quant=quant, feedback=True)
    g = DecodeGraph((M, B), decode, model, cache.kv, B, M, cfg.vocab_size,
                    device="cuda", pool=pool)
    a = g.inputs
    a["tokens"].copy_(torch.randint(3, cfg.vocab_size, (B,), generator=gen,
                                    device="cuda", dtype=torch.int32))
    a["pos"].copy_(torch.tensor(lengths, device="cuda") - 1)
    a["tables"].copy_(tables)
    a["temp"].copy_(torch.tensor([0, 0, 0, 0, 1, 1, 0.7, 0.7],
                                 device="cuda")[:B])
    a["topk"].copy_(torch.tensor([0, 0, 0, 0, 0, 50, 0, 0],
                                 device="cuda")[:B])
    a["topp"].copy_(torch.tensor([1, 1, 1, 1, 1, 1, 0.9, 1.0],
                                 device="cuda")[:B])
    _reset_counters()
    g.capture()
    captured = _read_counters()
    from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
        OUTPUTS,
    )

    name = ("ragged_paged_attention" if ragged or quant
            else "paged_decode_attention")
    want = {name: cfg.n_layers}
    if model.quantized:   # 7 projections a layer and the lm_head
        want["int8_matmul"] = 7 * cfg.n_layers + 1
    if g.launches != want:
        raise AssertionError(f"{what}: the graph holds launches "
                             f"{g.launches}, want {want}")
    # the eager call and the replay on the same inputs and draws: the
    # replay's decode writes each row's key and value again (the same
    # values), so it attends the same pool
    gen_u = torch.Generator(device="cuda").manual_seed(5)
    g.draw(gen_u)
    eager_outs = dict(zip(OUTPUTS, g.eager()))
    _reset_counters()
    g.replay()
    torch.cuda.synchronize()
    replay_counts = _read_counters()
    # tokens, positions and the three logprob readouts, bit for bit
    equal = {n: torch.equal(getattr(g, n), e) for n, e in eager_outs.items()}
    exact = all(equal.values())
    diff = (g.top_lp - eager_outs["top_lp"]).abs().max().item()
    if not (bool(torch.isfinite(g.top_lp).all())
            and bool(torch.isfinite(g.tok_lp).all())):
        raise AssertionError(f"{what}: non-finite logprobs")
    # a greedy row's token is its readout's top id, or ties with it: its
    # logprob is the top logprob bit for bit (bf16 logits tie, and argmax
    # and top-k need not pick the same one of equal values)
    if not torch.equal(g.tok_lp[:4], g.top_lp[:4, 0]):
        raise AssertionError(f"{what}: greedy tokens are not the top ids")
    greedy_equal = torch.equal(g.nxt[:4], eager_outs["nxt"][:4])
    # consecutive replays draw afresh: a sampled row's uniforms change
    u0 = g.uniforms.clone()
    first = g.nxt.clone()
    g.draw(gen_u)
    g.replay()
    torch.cuda.synchronize()
    redrawn = not torch.equal(u0, g.uniforms)
    resampled = not torch.equal(first[4:], g.nxt[4:])
    still_greedy = torch.equal(first[:4], g.nxt[:4])

    def eager_step():
        g.draw(gen_u)
        g.eager()

    def replay_step():
        g.draw(gen_u)
        g.replay()

    wall_eager = _step_wall_ms(torch, eager_step)
    wall_replay = _step_wall_ms(torch, replay_step)
    dev_eager, launches_eager = _device_step(torch, eager_step)
    dev_replay, launches_replay = _device_step(torch, replay_step)
    line = {
        "case": what, "B": B, "M": M, "lengths": lengths,
        "ragged": ragged, "int8": quant,
        "bit_exact": exact, "outputs_equal": equal,
        "max_abs_top_lp_diff": diff,
        "greedy_tokens_equal": greedy_equal,
        "redrawn": redrawn, "sampled_rows_changed": resampled,
        "greedy_rows_unchanged": still_greedy,
        "graph_launches": g.launches, "capture_counts": captured,
        "replay_counts": replay_counts,
        "capture_s": g.capture_seconds, "pool_bytes": pool.bytes(),
        "wall_ms_eager": wall_eager, "wall_ms_replay": wall_replay,
        "device_ms_eager": dev_eager, "device_ms_replay": dev_replay,
        "kernels_per_eager_step": launches_eager,
        "kernels_per_replay": launches_replay,
    }
    log("decode_graph: " + json.dumps(line))
    del g, cache
    gc.collect()
    torch.cuda.empty_cache()
    if any(replay_counts[k] != n for k, n in want.items()):
        raise AssertionError(f"{what}: one replay counted {replay_counts}")
    if not exact:
        raise AssertionError(f"{what}: the replay is not the eager call bit "
                             f"for bit ({equal}, max top-logprob diff "
                             f"{diff}, greedy tokens equal {greedy_equal})")
    if not (redrawn and resampled and still_greedy):
        raise AssertionError(f"{what}: draws {redrawn}, sampled rows changed "
                             f"{resampled}, greedy rows kept {still_greedy}")
    return line


def _verify_graph_case(ctx, torch, what, pos0, ragged, quant, M):
    """One speculative verify key at full width (``runner.make_verify``,
    k = ``VERIFY_K``): 8 rows of a pending token and 4 drafts at ``pos0``
    over a pool of random blocks, half greedy and half sampled, captured as
    a graph (``DecodeGraph(verify_k=...)``) and held against the eager call
    of the same verify function on the same inputs and both sets of draws,
    every output bit for bit; its B2 or B3 launches one per layer over
    ``8 * (k + 1)`` rows."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
        VERIFY_OUTPUTS,
        DecodeGraph,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.runner import (
        make_verify,
    )

    cfg, model = _engine_model(ctx)
    B, bs, k = len(pos0), 16, VERIFY_K
    gen, cache, tables, pool = _graph_fixture(ctx, torch, B, M, quant, 13,
                                              B * (k + 1))
    verify = make_verify(cfg, bs, M, B, k, ctx_blocks=M, ragged=ragged,
                         kv_quant=quant)
    g = DecodeGraph(("verify", M, B), verify, model, cache.kv, B, M,
                    cfg.vocab_size, device="cuda", pool=pool, verify_k=k)
    a = g.inputs
    a["tokens"].copy_(torch.randint(3, cfg.vocab_size, (B, k + 1),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32))
    a["pos"].copy_(torch.tensor(pos0, device="cuda"))
    a["tables"].copy_(tables)
    a["temp"].copy_(torch.tensor([0, 0, 0, 0, 1, 1, 0.7, 0.7],
                                 device="cuda")[:B])
    a["topk"].copy_(torch.tensor([0, 0, 0, 0, 0, 50, 0, 0],
                                 device="cuda")[:B])
    a["topp"].copy_(torch.tensor([1, 1, 1, 1, 1, 1, 0.9, 1.0],
                                 device="cuda")[:B])
    _reset_counters()
    g.capture()
    name = ("ragged_paged_attention" if ragged or quant
            else "paged_decode_attention")
    want = {name: cfg.n_layers}
    if model.quantized:   # M = 40 rows: B4's decode instantiation
        want["int8_matmul"] = 7 * cfg.n_layers + 1
    if g.launches != want:
        raise AssertionError(f"{what}: the graph holds launches "
                             f"{g.launches}, want {want}")
    # the eager call and each replay start from the same pool: an int8
    # block requantized once per written token rounds its earlier tokens
    # again when the scale grows, so writing the same k + 1 tokens twice
    # does not give the same blocks (T = 1 decode does)
    saved = [{n: t.clone() for n, t in lay.items()} for lay in cache.kv]

    def restore():
        for lay, was in zip(cache.kv, saved):
            for n, t in lay.items():
                t.copy_(was[n])

    gen_u = torch.Generator(device="cuda").manual_seed(7)
    g.draw(gen_u)
    eager_outs = dict(zip(VERIFY_OUTPUTS, g.eager()))
    restore()
    _reset_counters()
    g.replay()
    torch.cuda.synchronize()
    replay_counts = _read_counters()
    equal = {n: torch.equal(getattr(g, n), e) for n, e in eager_outs.items()}
    exact = all(equal.values())
    if not all(bool(torch.isfinite(getattr(g, n)).all()) for n in (
            "accept_p", "o_lp", "d_lp", "top_lp")):
        raise AssertionError(f"{what}: non-finite verify outputs")
    # a greedy row's o is its readout's top logprob at every position
    greedy_top = torch.equal(g.o_lp[:4], g.top_lp[:4, :, 0])
    u0 = [u.clone() for u in g.draws]
    first = g.o.clone()
    g.draw(gen_u)
    restore()
    g.replay()
    torch.cuda.synchronize()
    redrawn = not any(torch.equal(a, b) for a, b in zip(u0, g.draws))
    resampled = not torch.equal(first[4:], g.o[4:])
    still_greedy = torch.equal(first[:4], g.o[:4])

    def eager_step():
        g.draw(gen_u)
        g.eager()

    def replay_step():
        g.draw(gen_u)
        g.replay()

    line = {
        "case": what, "B": B, "k": k, "rows": B * (k + 1), "M": M,
        "pos0": list(pos0), "ragged": ragged, "int8": quant,
        "bit_exact": exact, "outputs_equal": equal,
        "greedy_o_is_top": greedy_top, "redrawn": redrawn,
        "sampled_rows_changed": resampled,
        "greedy_rows_unchanged": still_greedy,
        "graph_launches": g.launches, "replay_counts": replay_counts,
        "capture_s": g.capture_seconds, "pool_bytes": pool.bytes(),
        "uniform_bytes": sum(u.nbytes for u in g.draws),
        "wall_ms_eager": _step_wall_ms(torch, eager_step),
        "wall_ms_replay": _step_wall_ms(torch, replay_step),
    }
    line["device_ms_replay"], line["kernels_per_replay"] = _device_step(
        torch, replay_step)
    log("decode_graph: verify " + json.dumps(line))
    del g, cache, saved
    gc.collect()
    torch.cuda.empty_cache()
    if any(replay_counts[kk] != n for kk, n in want.items()):
        raise AssertionError(f"{what}: one replay counted {replay_counts}")
    if not exact:
        raise AssertionError(f"{what}: the verify replay is not the eager "
                             f"call bit for bit ({equal})")
    if not (greedy_top and redrawn and resampled and still_greedy):
        raise AssertionError(f"{what}: greedy o is top {greedy_top}, draws "
                             f"{redrawn}, sampled rows changed {resampled}, "
                             f"greedy rows kept {still_greedy}")
    return line


def _readout_cost(ctx, torch, B: int = 8) -> dict:
    """The logprob readout alone (``runner.token_logprobs``: a log-softmax,
    a top-5 and a gather over ``[B, V]`` f32 logits) at serve's decode
    shape: CUDA-event time of one call with a cold L2, its kernels and
    device time from the profiler, and its bytes bound (the logits read
    once, the outputs written once)."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.runner import (
        K_LOGPROBS,
        token_logprobs,
    )

    cfg, _ = _engine_model(ctx)
    gen = torch.Generator(device="cuda").manual_seed(12)
    logits = torch.randn(B, cfg.vocab_size, generator=gen, device="cuda")
    toks = logits.argmax(-1).to(torch.int32)
    ms = ctx["timer"](lambda: token_logprobs(logits, toks))
    by_kernel = _device_us_by_kernel(torch, lambda: token_logprobs(logits,
                                                                   toks))
    n_bytes = 4 * B * cfg.vocab_size + 4 * B + B * (2 * 4 * K_LOGPROBS + 4)
    line = {"B": B, "V": cfg.vocab_size, "ms": ms,
            "bound_ms": bound_ms(n_bytes, 0)[0],
            "device_us_by_kernel": {k: round(us, 2) for k, (us, _)
                                    in by_kernel.items()},
            "device_ms": (sum(us for us, _ in by_kernel.values()) / 1e3
                          if by_kernel else None)}
    log("decode_graph: logprob readout " + json.dumps(line))
    return line


def phase_decode_graph(ctx):
    import torch

    ctx["readout"] = _readout_cost(ctx, torch)
    ctx["decode_graph"] = [
        # serve's bucketed decode step: its 32-block bucket, bf16 pool
        _decode_graph_case(ctx, torch, "serve bucketed bf16",
                           [32, 71, 110, 149, 188, 227, 266, 305], False,
                           False, 32),
        # serve_ragged's: the full 256-block window over an int8 pool
        _decode_graph_case(ctx, torch, "ragged int8 full window",
                           [1, 17, 255, 512, 1000, 2047, 3000, 4096], True,
                           True, 256),
    ]
    # one verify key of each: the same windows, each row's five positions
    # ending where the decode row's one did
    ctx["verify_graph"] = [
        _verify_graph_case(ctx, torch, "verify bucketed bf16",
                           [27, 66, 105, 144, 183, 222, 261, 300], False,
                           False, 32),
        _verify_graph_case(ctx, torch, "verify ragged int8 full window",
                           [0, 12, 250, 507, 995, 2042, 2995, 4091], True,
                           True, 256),
    ]
    for dec, ver in zip(ctx["decode_graph"], ctx["verify_graph"]):
        log(f"decode_graph: {ver['case']}: replay device "
            f"{ver['device_ms_replay']} ms against the decode key's "
            f"{dec['device_ms_replay']} ms, wall {ver['wall_ms_replay']:.3f} "
            f"against {dec['wall_ms_replay']:.3f} ms")


KERNELS = ("flash_attention", "paged_decode_attention",
           "ragged_paged_attention", "int8_matmul", "int8_matmul_wide")


def _counters():
    """``{kernel: (wrapper, counter attribute)}``: the W8A16 wrapper counts
    its decode and its wide instantiation apart."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
        int8_matmul as i8,
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    return {"flash_attention": (fa.flash_attention, "launches"),
            "paged_decode_attention": (pa.paged_decode_attention,
                                       "launches"),
            "ragged_paged_attention": (rpa.ragged_paged_attention,
                                       "launches"),
            "int8_matmul": (i8.int8_matmul, "launches"),
            "int8_matmul_wide": (i8.int8_matmul, "wide_launches")}


def _reset_counters():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counters():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def _check_counters(what: str, counts, expect) -> None:
    """Exactly the kernels in ``expect`` were launched in the run."""
    wrong = [k for k in KERNELS if bool(counts[k]) != (k in expect)]
    if wrong:
        raise AssertionError(f"{what}: launches {counts}; expected exactly "
                             f"{sorted(expect)} to rise")


def _engine_model(ctx):
    """The engine phases' model, built once: Llama-3-8B widths,
    ``ENGINE_LAYERS`` layers, seeded N(0, 0.02) bf16 weights."""
    if "engine_model" not in ctx:
        import dataclasses

        from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
            LlamaConfig,
            LlamaForCausalLM,
            random_params,
        )

        cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                                  n_layers=ENGINE_LAYERS)
        t0 = time.monotonic()
        ctx["engine_model"] = cfg, LlamaForCausalLM.from_state_dict(
            cfg, random_params(cfg, seed=0, std=0.02, device="cuda"))
        log(f"engine model: Llama-3-8B widths, {cfg.n_layers} of 32 layers, "
            f"seeded N(0, 0.02) weights, built in "
            f"{time.monotonic() - t0:.1f} s")
    return ctx["engine_model"]


def _drop_engine_model(ctx) -> None:
    import torch

    ctx.pop("engine_model", None)
    ctx.pop("engine_model_int8", None)
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _plain_int8():
    """Send every int8 projection through the W8A16 kernel's plain version
    (the reference's expression), then restore the kernel."""
    from scalable_hw_agnostic_inference_tpu_torch.ops import quant
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        int8_matmul as i8,
    )

    saved = quant.int8_matmul
    quant.int8_matmul = i8.int8_matmul_reference
    try:
        yield
    finally:
        quant.int8_matmul = saved


@contextlib.contextmanager
def _plain_attention():
    """Swap every kernel the engine and the scoring forward call for its
    plain PyTorch version (attention with an fp32 softmax, the int8
    projections as the reference's expression), then restore them."""
    from scalable_hw_agnostic_inference_tpu_torch.engine import runner
    from scalable_hw_agnostic_inference_tpu_torch.models import llama
    from scalable_hw_agnostic_inference_tpu_torch.ops import attention
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    def flash(q, k, v, *, causal=False, scale=None, lengths=None):
        return fa.flash_attention_reference(q, k, v, causal=causal,
                                            scale=scale, lengths=lengths)

    def paged(q, kp, vp, tables, lengths, k_scale=None, v_scale=None, *,
              scale=None):
        if k_scale is not None:
            return rpa.ragged_paged_attention_reference(
                q, kp, vp, tables, lengths, k_scale, v_scale, scale=scale)
        return pa.paged_decode_attention_reference(q, kp, vp, tables,
                                                   lengths, scale=scale)

    ragged = rpa.ragged_paged_attention_reference
    swaps = [(attention, "flash_attention", flash),
             (attention, "_ragged_kernel", ragged),
             (runner, "ragged_kernel", ragged),
             (runner, "paged_decode_attention", paged),
             (llama, "paged_decode_attention", paged)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        with _plain_int8():
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _graphs(eng):
    """Every captured graph of the engine: the decode keys, the verify
    keys, and under the fused step the fused keys and the chunk-only
    graph."""
    return eng.graphs()


def _replays(eng):
    return {g.key: g.replays for g in _graphs(eng)}


def _count_chunks(eng):
    """Count the engine's continuation chunks from here on (each ragged
    chunk launches B3 once per layer); returns the counter list."""
    calls = []
    inner = eng._continue_prefill

    def counted(s):
        calls.append(1)
        return inner(s)

    eng._continue_prefill = counted
    return calls


def _expected_walk(eng, before, chunks):
    """B2's and B3's exact launch counts since ``before`` (the graphs'
    replay counts then): each replay adds the launches its graph captured,
    and each laddered ragged continuation chunk launches B3 once per
    layer (under the fused step every chunk rides a replay)."""
    out = {"paged_decode_attention": 0, "ragged_paged_attention": 0}
    for g in _graphs(eng):
        n = g.replays - before.get(g.key, 0)
        for name, per in g.launches.items():
            if name in out:
                out[name] += per * n
    if eng._ragged and not eng._fused:
        out["ragged_paged_attention"] += eng.cfg.n_layers * len(chunks)
    return out


def _check_walk(what: str, counts, expect) -> None:
    got = {k: counts[k] for k in expect}
    if got != expect:
        raise AssertionError(f"{what}: B2/B3 launches {got}, the decode "
                             f"replays and chunks make {expect}")


def _generate(ctx, prompts, switches, all_lp=False,
              new_tokens=ENGINE_NEW_TOKENS, spec=0, sampled=(),
              measure=False):
    """One engine run of greedy requests under the engine switches (async
    decode unless they say otherwise), its closed set warmed first; the
    even rows (``all_lp``: every row) ask for 5 logprobs. ``spec`` > 0:
    speculative decoding with that many drafts (``[ngram]``, lookup 4 to
    1); the rows in ``sampled`` sample (temperature 0.8, top-k 50) instead;
    ``measure``: also the device time of one verify replay and one decode
    replay of the largest verify key. Returns the finished requests, the
    launch counts, the seconds, the continuation keys it compiled, its
    leaked blocks and a dict of the pipeline's numbers."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
        SamplingParams,
    )

    cfg, model = _engine_model(ctx)
    ecfg = EngineConfig(max_model_len=2048, max_num_seqs=4, block_size=16,
                        context_encoding_buckets=(128, 512),
                        max_new_tokens=new_tokens,
                        quantization="int8" if model.quantized else None,
                        speculative_model="[ngram]" if spec else "",
                        num_speculative_tokens=spec,
                        ngram_prompt_lookup_max=4, ngram_prompt_lookup_min=1)
    env = {"SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "",
           "SHAI_ASYNC_DECODE": "1", **switches}
    with _env(env):
        eng = LLMEngine(cfg, model, ecfg, device="cuda")
        t0 = time.monotonic()
        n_warm = eng.warm_executables()
        warm_s = time.monotonic() - t0
        before = _replays(eng)
        chunks = _count_chunks(eng)
        _reset_counters()
        t0 = time.monotonic()
        ids = [eng.add_request(p, SamplingParams(
            temperature=0.8 if i in sampled else 0.0,
            top_k=50 if i in sampled else 0, max_new_tokens=new_tokens,
            logprobs=0 if i % 2 and not all_lp else 5))
            for i, p in enumerate(prompts)]
        done = {}
        while set(ids) - set(done):
            for f in eng.step():
                done[f.req_id] = f
        fins = [done[i] for i in ids]
        eng.finish_pending()
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        counts = _read_counters()
    for i, f in enumerate(fins):
        if len(f.token_ids) != new_tokens:
            raise AssertionError(f"{len(f.token_ids)} tokens, want "
                                 f"{new_tokens}")
        if f.logprobs and [e["token"] for e in f.logprobs] != f.token_ids:
            raise AssertionError("the logprob entries do not name the "
                                 "returned tokens")
    conts = sorted(k for k in eng._prefill if k[0] in ("cont", "rcont"))
    info = {"async": eng._async, "warmed": n_warm, "warm_s": warm_s,
            "recompiles": eng.obs.recompiles,
            "replays": sum(_replays(eng).values()) - sum(before.values()),
            "chunks": len(chunks),
            "flushes": eng.obs.flush_reasons(),
            "walk": _expected_walk(eng, before, chunks),
            "fused": eng._fused,
            "chunk_only_replays": (eng._fused_chunk.replays
                                   - before.get(eng._fused_chunk.key, 0)
                                   if eng._fused_chunk is not None else 0),
            "per_replay": sorted({n for g in _graphs(eng)
                                  for k, n in g.launches.items()
                                  if k not in ("int8_matmul",
                                               "int8_matmul_wide")}),
            "int8_per_replay": sorted({g.launches.get("int8_matmul", 0)
                                       for g in _graphs(eng)}),
            "wide_per_replay": sorted({g.launches.get("int8_matmul_wide", 0)
                                       for g in _graphs(eng)}),
            "graph_pool_bytes": eng._graphs.bytes()}
    if eng.tpot.count:
        tpot = eng.tpot.report()
        info["tpot_ms"] = {"p50": tpot["p50"] * 1e3,
                           "p99": tpot["p99"] * 1e3}
    if eng.spec is not None:
        after = _replays(eng)
        info["spec"] = eng.spec.as_dict()
        info["rollback_tokens"] = eng.cache.rollback_tokens
        info["rollback_blocks"] = eng.cache.rollback_blocks
        info["verify_replays"] = sum(
            after[g.key] - before.get(g.key, 0)
            for g in eng._verify_fns.values())
        info["decode_replays"] = sum(
            after[g.key] - before.get(g.key, 0)
            for g in eng._decode_fns.values())
        info["verify_walk"] = {
            name: sum(g.launches.get(name, 0)
                      * (after[g.key] - before.get(g.key, 0))
                      for g in eng._verify_fns.values())
            for name in ("paged_decode_attention", "ragged_paged_attention")}
        info["verify_uniform_bytes"] = sum(
            u.nbytes for g in eng._verify_fns.values() for u in g.draws)
    # one replay of the largest batch key, host enqueue to device end: a
    # fused key computes its whole chunk window even when it is the null
    # one (its inputs are the last step's; the pool is free by now)
    big = max((g for g in _graphs(eng)
               if g.key != ("chunk", 1) and not g.verify_k),
              key=lambda g: g.inputs["tokens"].shape[0])
    with torch.inference_mode():
        if eng._fused:
            big.load_window(None)
        info["replay_ms"] = _step_wall_ms(torch, big.replay)
        if measure and eng._verify_fns:
            # a verify replay against the decode replay of the same key
            key = max(eng._verify_fns, key=lambda kk: kk[1])
            for name, g in (("verify", eng._verify_fns[key]),
                            ("decode", eng._decode_fns[key])):
                info[f"{name}_key"] = list(key)
                info[f"{name}_wall_ms"] = _step_wall_ms(torch, g.replay)
                info[f"{name}_device_ms"], info[f"{name}_kernels"] = \
                    _device_step(torch, g.replay)
    return fins, counts, seconds, conts, eng.cache.leaked_blocks, info


def _score(model, prompts, fins, crosses=None, prefixes=None):
    """Score each run's tokens with the full-sequence scoring forward,
    through B1 and through B1's plain version: ``{"b1": (argmax hits,
    worst logit deficit), "plain": (hits, worst), "tokens": n, "eps":
    eps, "lp_err": e, "lp_err_shifted": s}``, where eps is the largest
    logit change between the two, e the largest distance of a returned
    logprob from the plain forward's log-softmax at its token, and s the
    same distance one position off (what a misaligned readout would
    show). ``crosses``: an mllama model's per-request ``(states [Lv, dim],
    cross_len)``, or None for a text-only request; ``prefixes``: a
    soft-prefix model's per-request ``[P, dim]`` image tokens (scored over
    ``[prefix; prompt; tokens]``), or None."""
    import torch

    score = {"b1": (0, 0.0), "plain": (0, 0.0), "tokens": 0, "eps": 0.0,
             "lp_err": 0.0, "lp_err_shifted": 0.0}
    crosses = crosses or [None] * len(prompts)
    prefixes = prefixes or [None] * len(prompts)
    # an int8 model scores through its projections' plain route
    with torch.inference_mode(), _plain_int8():
        for p, f, cr, pre in zip(prompts, fins, crosses, prefixes):
            ids = torch.tensor([p + f.token_ids], device="cuda")
            cross = None
            if cr is not None:
                cross = (model.project_cross(cr[0][None]),
                         torch.ones(1, device="cuda"),
                         torch.tensor([cr[1]], device="cuda"))
            kw = {} if pre is None else {"prefix": pre[None]}
            start = len(p) - 1 + (0 if pre is None else pre.shape[0])
            # each token's logits
            logits = model(ids, cross=cross, **kw)[0, start: -1].float()
            with _plain_attention():
                plain = model(ids, cross=cross, **kw)[0, start: -1].float()
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("non-finite scoring logits")
            score["eps"] = max(score["eps"],
                               (logits - plain).abs().max().item())
            tok = torch.tensor(f.token_ids, device="cuda")
            if f.logprobs:
                got = torch.tensor([e["logprob"] for e in f.logprobs],
                                   device="cuda")
                lsm = torch.log_softmax(plain, -1)
                want = lsm.gather(1, tok[:, None])[:, 0]
                score["lp_err"] = max(score["lp_err"],
                                      (got - want).abs().max().item())
                off = lsm[1:].gather(1, tok[:-1, None])[:, 0]
                score["lp_err_shifted"] = max(
                    score["lp_err_shifted"],
                    (got[:-1] - off).abs().max().item())
            for key, lg in (("b1", logits), ("plain", plain)):
                deficit = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
                hits, worst = score[key]
                score[key] = (hits + int((lg.argmax(-1) == tok).sum()),
                              max(worst, deficit.max().item()))
            score["tokens"] += len(f.token_ids)
    return score


def _run_engine(ctx, what, prompt_lens, switches, expect, cont_key, rule):
    """Generate ``ENGINE_NEW_TOKENS`` greedy tokens for prompts of
    ``prompt_lens`` tokens under the engine switches ``switches`` and
    score them: ``rule`` "tie" holds the worst deficit against the plain
    scoring forward to ``TIE_TOL``, "noise" the worst against the scoring
    forward through B1 to ``NOISE_TIES * eps``, and "int8" to that too
    and also the argmax hits to those of the same engine run through the
    kernels' plain versions less ``INT8_SLACK``. "tie" and "int8" log that
    plain run's own deficits. The run must chunk (``cont_key`` names the
    continuation it compiles), launch exactly the kernels ``expect`` and
    leak no block. Returns the async run's numbers and launch counts and
    the lock-step run's numbers."""
    import torch

    cfg, model = _engine_model(ctx)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in prompt_lens]
    fins, counts, seconds, conts, leaked, info = _generate(ctx, prompts,
                                                          switches)
    _check_walk(what, counts, info["walk"])
    # the same requests lock-step: the same tokens, the same device work
    sync = _generate(ctx, prompts, {**switches, "SHAI_ASYNC_DECODE": "0"})
    if not info["async"] or sync[5]["async"]:
        raise AssertionError(f"{what}: async {info['async']} / lock-step "
                             f"{not sync[5]['async']}")
    if [f.token_ids for f in fins] != [f.token_ids for f in sync[0]]:
        raise AssertionError(f"{what}: async and lock-step tokens differ")
    if [f.logprobs for f in fins] != [f.logprobs for f in sync[0]]:
        raise AssertionError(f"{what}: async and lock-step logprob entries "
                             f"differ")
    _check_walk(f"{what} lock-step", sync[1], sync[5]["walk"])
    log(f"{what}: async {seconds:.2f} s, lock-step {sync[2]:.2f} s, tokens "
        f"and logprob entries equal; async {json.dumps(info)}; lock-step "
        f"{json.dumps(sync[5])}")
    s = _score(model, prompts, fins)
    (exact, worst), (p_hits, p_worst), total = s["b1"], s["plain"], \
        s["tokens"]
    eps = s["eps"]
    log(f"{what}: {switches or 'default switches'}; prompts "
        f"{list(prompt_lens)} x {ENGINE_NEW_TOKENS} greedy tokens in "
        f"{seconds:.2f} s; {exact}/{total} equal the scoring argmax, worst "
        f"logit deficit {worst:.4f} ({p_hits}/{total} and {p_worst:.4f} "
        f"against the plain scoring forward), eps {eps:.4f}; logprobs "
        f"within {s['lp_err']:.4f} of the plain forward's log-softmax (one "
        f"position off: {s['lp_err_shifted']:.4f}); continuations "
        f"{conts}; launches {counts}; leaked blocks {leaked}")
    if rule == "tie" and p_worst > TIE_TOL:
        raise AssertionError(f"{what}: worst deficit {p_worst:.4f} against "
                             f"the plain scoring forward over the tie "
                             f"tolerance {TIE_TOL}")
    if rule == "tie" and s["lp_err"] > LP_TOL:
        raise AssertionError(f"{what}: a logprob is {s['lp_err']:.4f} from "
                             f"the plain scoring forward's, over {LP_TOL}")
    if rule in ("noise", "int8") and worst > NOISE_TIES * eps:
        raise AssertionError(f"{what}: worst deficit {worst:.4f} over "
                             f"{NOISE_TIES} * eps = {NOISE_TIES * eps:.4f}")
    if rule in ("tie", "int8"):
        with _plain_attention():
            p_fins, p_counts, _, _, _, _ = _generate(ctx, prompts,
                                                     switches)
        ps = _score(model, prompts, p_fins)
        log(f"{what}: the same engine through the kernels' plain versions: "
            f"{ps['b1'][0]}/{total} equal the scoring argmax, worst deficit "
            f"{ps['b1'][1]:.4f} ({ps['plain'][0]}/{total} and "
            f"{ps['plain'][1]:.4f} against the plain scoring forward); "
            f"launches {p_counts}")
        _check_counters(f"{what} plain", p_counts, ())
        if rule == "int8" and exact < ps["b1"][0] - INT8_SLACK * total:
            raise AssertionError(f"{what}: {exact}/{total} tokens are the "
                                 f"scoring argmax, the plain versions' run "
                                 f"{ps['b1'][0]}/{total}")
    if leaked:
        raise AssertionError(f"{what}: leaked KV blocks")
    if cont_key not in conts:
        raise AssertionError(f"{what}: no chunk ran through {cont_key}")
    _check_counters(what, counts, expect)
    return info, counts, sync[5]


def phase_engine(ctx):
    # bucketed bf16: prefill, static-start continuation and scoring through
    # B1, decode through B2
    _run_engine(ctx, "engine", (5, 37, 120, 300, 1300), {},
                {"flash_attention", "paged_decode_attention"},
                ("cont", 32, 512), "tie")


def _tie_diverge(got, want, tie_gap=TIE_GAP):
    """``tests/parity.py``'s greedy tie rule: each of ``got``'s token
    streams equals ``want``'s, or parts from it where ``want``'s top-2
    logprobs are within ``tie_gap`` (``TIE_GAP``: a near-tie of bf16
    rounding). Returns the gaps at the partings; raises at a decisive
    one."""
    gaps = []
    for g, w in zip(got, want):
        if g.token_ids == w.token_ids:
            continue
        i = next((n for n, (a, b) in enumerate(zip(g.token_ids, w.token_ids))
                  if a != b), min(len(g.token_ids), len(w.token_ids)))
        if i >= len(w.logprobs):
            continue
        top = w.logprobs[i]["top_logprobs"]
        gap = float(top[0]) - float(top[1])
        gaps.append(gap)
        if gap >= tie_gap:
            raise AssertionError(f"diverged at token {i} with a decisive "
                                 f"margin {gap:.4f} >= {tie_gap}: "
                                 f"{g.token_ids} != {w.token_ids}")
    return gaps


def _run_fused(ctx, what, switches):
    """The fused engine (``SHAI_FUSED_STEP=1``) on the engine_ragged
    prompts, async and lock-step, against the laddered ragged engine under
    the same switches: the tie rule on the tokens, async equal to
    lock-step, B3 exactly the layers times the fused and chunk-only
    replays (no eager continuation launch, no continuation function),
    no leaked block; over int8 weights the int8 kernel rises too."""
    cfg, model = _engine_model(ctx)
    import torch

    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in ENGINE_PROMPTS]
    fused_sw = {**switches, "SHAI_FUSED_STEP": "1"}
    fins, counts, seconds, conts, leaked, info = _generate(ctx, prompts,
                                                           fused_sw)
    _check_walk(what, counts, info["walk"])
    if not info["fused"] or conts or info["per_replay"] != [cfg.n_layers]:
        raise AssertionError(f"{what}: fused {info['fused']}, continuation "
                             f"functions {conts}, B3 launches per replay "
                             f"{info['per_replay']}")
    sync = _generate(ctx, prompts, {**fused_sw, "SHAI_ASYNC_DECODE": "0"})
    if [f.token_ids for f in fins] != [f.token_ids for f in sync[0]]:
        raise AssertionError(f"{what}: async and lock-step tokens differ")
    _check_walk(f"{what} lock-step", sync[1], sync[5]["walk"])
    lad = _generate(ctx, prompts, {**switches, "SHAI_FUSED_STEP": "0"},
                    all_lp=True)
    gaps = _tie_diverge(fins, lad[0])
    same = sum(f.token_ids == w.token_ids for f, w in zip(fins, lad[0]))
    log(f"{what}: {switches}; fused async {seconds:.2f} s, lock-step "
        f"{sync[2]:.2f} s, laddered {lad[2]:.2f} s; {same}/{len(fins)} "
        f"token streams equal the laddered run's (tie gaps at the partings "
        f"{gaps}); async {json.dumps(info)}; lock-step "
        f"{json.dumps(sync[5])}; laddered {json.dumps(lad[5])}; launches "
        f"{counts}; leaked blocks {leaked}")
    if leaked or sync[4] or lad[4]:
        raise AssertionError(f"{what}: leaked KV blocks")
    _check_counters(what, counts, {"flash_attention", "ragged_paged_attention"}
                    | ({"int8_matmul", "int8_matmul_wide"} if model.quantized
                       else set()))
    ctx.setdefault("engine_fused", {})[what] = {
        "equal_streams": same, "streams": len(fins), "tie_gaps": gaps,
        "chunks": info["chunks"],
        "chunk_only_replays": info["chunk_only_replays"],
        "b3_launches": counts["ragged_paged_attention"],
        "fused_replay_ms": info["replay_ms"],
        "laddered_replay_ms": lad[5]["replay_ms"],
        "fused_graph_pool_bytes": info["graph_pool_bytes"],
        "laddered_graph_pool_bytes": lad[5]["graph_pool_bytes"],
        "int8_launches": counts["int8_matmul"],
        "wide_launches": counts["int8_matmul_wide"]}


def phase_engine_fused(ctx):
    # (a) bf16, (b) int8: decode and every chunk through the fused graphs'
    # mixed-row B3 launches (the serve phases drop the model)
    _run_fused(ctx, "engine_fused (a)", {"SHAI_RAGGED_ATTENTION": "1"})
    _run_fused(ctx, "engine_fused (b)", {"SHAI_RAGGED_ATTENTION": "1",
                                          "SHAI_KV_QUANT": "int8"})


#: engine_spec: k drafts, 32 greedy tokens a request
SPEC_K = 4
SPEC_NEW_TOKENS = 32


#: engine_spec's quoting prompt: bench.py's repetitive shape (a 16-token
#: base repeated, here to 1,024 tokens), preceded by the first
#: ``SPEC_QUOTE`` tokens of the model's own greedy continuation of it
SPEC_REPEAT_LEN = 1024
SPEC_QUOTE = 16


def _greedy_scored(model, ids, n):
    """``n`` greedy tokens after ``ids`` by the full-sequence scoring
    forward (no cache: one forward a token)."""
    import torch

    out = []
    with torch.inference_mode():
        for _ in range(n):
            logits = model(torch.tensor([ids + out], device="cuda"))[0, -1]
            out.append(int(logits.float().argmax()))
    return out


def _spec_prompts(ctx):
    """The engine phases' prompts, then a quoting prompt, then a sampled
    request (the 37-token prompt again, at temperature 0.8).

    The seeded random model's greedy tokens are close to uniform over the
    128,256 ids and unrelated to its context, so the drafter would almost
    never find one in a random prompt and no verify step would run. The
    quoting prompt is the regime prompt lookup is for, an output that
    quotes its input: bench.py's repetitive shape (a seeded 16-token base
    repeated to ``SPEC_REPEAT_LEN`` tokens), preceded by the first
    ``SPEC_QUOTE`` tokens of the model's own greedy continuation of it
    (``_greedy_scored``). Where the engine continues with a quoted token,
    the drafter proposes the ones after it, and verification accepts those
    the model still continues with: the prefix itself moves this model's
    flat logits, so that is the first token and seldom more (acceptance
    stays low, as on any random-weight model). Returns the prompts and a
    log line: how many of the quoted tokens the scoring forward continues
    with."""
    import numpy as np
    import torch

    cfg, model = _engine_model(ctx)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in ENGINE_PROMPTS]
    base = np.random.default_rng(0).integers(3, cfg.vocab_size, 16).tolist()
    rep = (base * (SPEC_REPEAT_LEN // 16))[:SPEC_REPEAT_LEN]
    quote = _greedy_scored(model, rep, SPEC_QUOTE)
    again = _greedy_scored(model, quote + rep, SPEC_QUOTE)
    kept = next((i for i, (a, b) in enumerate(zip(quote, again)) if a != b),
                SPEC_QUOTE)
    return (prompts + [quote + rep, prompts[1]],
            f"quoting prompt: the scoring forward continues it with "
            f"{kept} of the {SPEC_QUOTE} quoted tokens")


def _partings(got, want):
    """Where each of ``got``'s token streams first parts from ``want``'s:
    ``want``'s top-2 logprob gap there (the tie rule's measure), and the
    largest difference between the two runs' logprobs (the sampled
    token's and the top 5) at the positions up to it, where both read the
    same tokens: the rounding change between the two paths."""
    gaps, noise = [], 0.0
    for g, w in zip(got, want):
        n = next((i for i, (a, b) in enumerate(zip(g.token_ids, w.token_ids))
                  if a != b), min(len(g.token_ids), len(w.token_ids)))
        for a, b in zip(g.logprobs[:n + 1], w.logprobs[:n + 1]):
            noise = max([noise, abs(a["logprob"] - b["logprob"])] + [
                abs(x - y) for x, y in zip(a["top_logprobs"],
                                           b["top_logprobs"])])
        if g.token_ids != w.token_ids and n < len(w.logprobs):
            top = w.logprobs[n]["top_logprobs"]
            gaps.append(float(top[0]) - float(top[1]))
    return gaps, noise


def _run_spec(ctx, what, switches, expect, cont_key, rule):
    """Speculative decoding (``[ngram]``, k = ``SPEC_K``) on the engine
    phase's model: the async run against its lock-step run (every token
    and logprob entry, the sampled row too) and against the spec-off
    engine, and its greedy tokens against the scoring forward. ``rule``
    "tie": the spec-off tokens by the tie rule and the plain scoring
    forward by ``TIE_TOL``. The tie rule's gap is ``TIE_GAP``, or
    ``NOISE_TIES`` times the rounding change measured between the two
    runs where it is larger (``_partings``: verify runs its projections at
    Bb * (k + 1) rows where decode runs them at Bb, other cuBLAS kernels,
    other bf16 roundings, and B2 at another split). "int8": the int8 rule
    (the worst deficit against the scoring forward through B1 within
    ``NOISE_TIES * eps``, the argmax hits at least the spec-off run's less
    ``INT8_SLACK``: rejected drafts write the int8 blocks too, and a
    block's scale only grows). B2's or B3's launches are exactly the
    layers times the decode and verify replays (and the continuation
    chunks); 0 recompiles, no leaked block, a rollback. Every number is
    logged before the checks."""
    cfg, model = _engine_model(ctx)
    prompts, found = _spec_prompts(ctx)
    log(f"{what}: {found}")
    sampled = {len(prompts) - 1}
    greedy = list(range(len(prompts) - 1))
    kw = dict(new_tokens=SPEC_NEW_TOKENS, sampled=sampled, all_lp=True)
    fins, counts, seconds, conts, leaked, info = _generate(
        ctx, prompts, switches, spec=SPEC_K, measure=True, **kw)
    sync = _generate(ctx, prompts, {**switches, "SHAI_ASYNC_DECODE": "0"},
                     spec=SPEC_K, **kw)
    off = _generate(ctx, prompts, switches, **kw)
    g_on = [fins[i] for i in greedy]
    g_off = [off[0][i] for i in greedy]
    g_prompts = [prompts[i] for i in greedy]
    same = sum(a.token_ids == b.token_ids for a, b in zip(g_on, g_off))
    gaps, noise = _partings(g_on, g_off)
    s = _score(model, g_prompts, g_on)
    so = _score(model, g_prompts, g_off)
    st = info["spec"]
    row = {
        "switches": switches, "acceptance": st["spec_acceptance_rate"],
        "tokens_per_verify": st["spec_tokens_per_verify"], "spec": st,
        "greedy_streams_equal_spec_off": same, "streams": len(greedy),
        "parting_gaps": gaps, "spec_off_noise": noise,
        "tie_gap": max(TIE_GAP, NOISE_TIES * noise),
        "worst_deficit_plain": s["plain"][1],
        "worst_deficit_b1": s["b1"][1], "eps": s["eps"],
        "argmax_hits": s["b1"][0], "argmax_hits_spec_off": so["b1"][0],
        "worst_deficit_plain_spec_off": so["plain"][1],
        "tokens": s["tokens"],
        "verify_replays": info["verify_replays"],
        "decode_replays": info["decode_replays"],
        "verify_walk": info["verify_walk"], "walk": info["walk"],
        "rollback_tokens": info["rollback_tokens"],
        "rollback_blocks": info["rollback_blocks"],
        "verify_device_ms": info.get("verify_device_ms"),
        "decode_device_ms": info.get("decode_device_ms"),
        "verify_wall_ms": info.get("verify_wall_ms"),
        "decode_wall_ms": info.get("decode_wall_ms"),
        "replay_key": info.get("verify_key"),
        "tpot_ms_spec_on": info.get("tpot_ms"),
        "tpot_ms_spec_off": off[5].get("tpot_ms"),
        "seconds_spec_on": seconds, "seconds_spec_off": off[2],
        "graph_pool_bytes_spec_on": info["graph_pool_bytes"],
        "graph_pool_bytes_spec_off": off[5]["graph_pool_bytes"],
        "verify_uniform_bytes": info["verify_uniform_bytes"],
        "flushes": info["flushes"], "recompiles": info["recompiles"],
        "launches": counts}
    log(f"{what}: " + json.dumps(row))
    _check_walk(what, counts, info["walk"])
    _check_walk(f"{what} lock-step", sync[1], sync[5]["walk"])
    if [(f.token_ids, f.logprobs) for f in fins] != \
            [(f.token_ids, f.logprobs) for f in sync[0]]:
        raise AssertionError(f"{what}: async and lock-step differ")
    if rule == "tie":
        bad = [g for g in gaps if g >= row["tie_gap"]]
        if bad:
            raise AssertionError(f"{what}: parted from spec off at decisive "
                                 f"gaps {bad} >= {row['tie_gap']:.4f}")
        if s["plain"][1] > TIE_TOL:
            raise AssertionError(f"{what}: worst deficit {s['plain'][1]:.4f}"
                                 f" against the plain scoring forward over "
                                 f"{TIE_TOL}")
    else:
        if s["b1"][1] > NOISE_TIES * s["eps"]:
            raise AssertionError(f"{what}: worst deficit {s['b1'][1]:.4f} "
                                 f"over {NOISE_TIES} * eps")
        if s["b1"][0] < so["b1"][0] - INT8_SLACK * s["tokens"]:
            raise AssertionError(f"{what}: {s['b1'][0]}/{s['tokens']} "
                                 f"argmax hits, spec off {so['b1'][0]}")
    bad = [k for k, ok in (
        ("verify steps", st["spec_verify_steps"] > 0),
        ("recompiles", info["recompiles"] == sync[5]["recompiles"] == 0),
        ("leaked blocks", not (leaked or sync[4] or off[4])),
        ("rollback", info["rollback_tokens"] > 0),
        ("chunk", cont_key in conts)) if not ok]
    if bad:
        raise AssertionError(f"{what}: failed {bad}")
    _check_counters(what, counts, expect)
    ctx.setdefault("engine_spec", {})[what] = row


def phase_engine_spec(ctx):
    # (a) bucketed bf16: verify through B2 over repeated tables
    _run_spec(ctx, "engine_spec (a)", {},
              {"flash_attention", "paged_decode_attention"},
              ("cont", 32, 512), "tie")
    # (b) ragged + int8 KV: verify through B3, the int8 requantize unrolled
    # k + 1 times
    _run_spec(ctx, "engine_spec (b)", {"SHAI_RAGGED_ATTENTION": "1",
                                       "SHAI_KV_QUANT": "int8"},
              {"flash_attention", "ragged_paged_attention"},
              ("rcont", 512), "int8")


def phase_engine_ragged(ctx):
    # (a) ragged bf16: decode and the continuation through B3
    _run_engine(ctx, "engine_ragged (a)", ENGINE_PROMPTS,
                {"SHAI_RAGGED_ATTENTION": "1"},
                {"flash_attention", "ragged_paged_attention"},
                ("rcont", 512), "noise")
    # (b) ragged int8
    _run_engine(ctx, "engine_ragged (b)", ENGINE_PROMPTS,
                {"SHAI_RAGGED_ATTENTION": "1", "SHAI_KV_QUANT": "int8"},
                {"flash_attention", "ragged_paged_attention"},
                ("rcont", 512), "int8")
    # (c) bucketed int8: decode through B2's delegation to B3, the static
    # continuation through B1 on the dequantized prior blocks
    _run_engine(ctx, "engine_ragged (c)", ENGINE_PROMPTS,
                {"SHAI_KV_QUANT": "int8"},
                {"flash_attention", "ragged_paged_attention"},
                ("cont", 32, 512), "int8")


def _http(url: str, payload=None, timeout: float = 300.0, headers=None,
          raw: bool = False):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return r.status, (body.decode() if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _serve_prompts(long_bytes=()):
    """``SERVE_REQUESTS`` prompts of mixed length (prefill buckets 128 and
    512); the last ``len(long_bytes)`` are about that many bytes long
    instead (the tokenizer is byte-level)."""
    prompts = [f"request {i}: " + "tell me more " * (3 * i + 1)
               for i in range(SERVE_REQUESTS)]
    for j, n in enumerate(long_bytes):
        i = SERVE_REQUESTS - len(long_bytes) + j
        text = f"request {i}: " + "tell me more about paged attention. " * (
            n // 36 + 1)
        prompts[i] = text[:n]
    return prompts


def _send_concurrent(base: str, prompts, new_tokens: int = 16):
    """One concurrent greedy ``POST /generate`` of ``new_tokens`` per
    prompt (a string, or a payload dict holding its ``prompt``); returns
    the responses and the wall seconds."""
    results = [None] * len(prompts)

    def one(i):
        p = prompts[i]
        payload = {"prompt": p} if isinstance(p, str) else dict(p)
        results[i] = _http(base + "/generate", {
            **payload, "temperature": 0.0, "max_new_tokens": new_tokens})

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, time.monotonic() - t0


def _stream_completion(base: str, prompt: str):
    """One streamed greedy ``POST /v1/completions``: ``(status, seconds to
    the first SSE chunk, seconds to the end, the data payloads)``."""
    return _sse(base, "/v1/completions", {"prompt": prompt, "max_tokens": 16,
                                          "temperature": 0, "stream": True})


def _sse(base: str, route: str, payload):
    """One ``stream: true`` request to ``route``: ``(status, seconds to
    the first SSE chunk, seconds to the end, the data payloads)``."""
    body = json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data=body,
                                 headers={"content-type": "application/json"})
    t0 = time.monotonic()
    first, events = None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        status = r.status
        while True:
            line = r.readline()   # the chunked framing is undone here
            if not line:
                break
            if line.startswith(b"data: "):
                if first is None:
                    first = time.monotonic() - t0
                events.append(line[len(b"data: "):].strip().decode())
    return status, first, time.monotonic() - t0, events


def _pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


#: the ``/metrics`` families of the serving contract (the reference's
#: names and types): requests and latency, the engine's histograms,
#: gauges and counters
METRIC_FAMILIES = {
    "shai_requests_total": "counter",
    "shai_request_latency_seconds": "histogram",
    "shai_ttft_seconds": "histogram", "shai_tpot_seconds": "histogram",
    "shai_queue_wait_seconds": "histogram",
    "shai_engine_step_gap_seconds": "histogram",
    **{f"shai_engine_{g}": "gauge" for g in (
        "running", "waiting", "chunking", "kv_utilization", "kv_occupancy",
        "kv_blocks_free", "pad_fraction")},
    **{f"shai_engine_{c}_total": "counter" for c in (
        "steps", "preemptions", "recompiles", "requests_finished",
        "pipeline_flushes")},
}


def _openai_round(ctx, what, base, eng, prompts, expect):
    """The OpenAI routes on the served engine: ``len(prompts)`` concurrent
    streamed completions (client time to the first SSE chunk beside the
    engine's TTFT), ``n=2``, ``logprobs: 5`` on the zero-weight tier
    (uniform: every logprob ``-log(vocab)``), an expired deadline (504)
    and a ``/metrics`` scrape. Exactly the kernels ``expect`` rise, B2/B3
    exactly 32 per replay."""
    import math

    from scalable_hw_agnostic_inference_tpu_torch.utils.latency import (
        LatencyCollector,
    )

    eng.ttft = LatencyCollector()
    before = _replays(eng)
    chunks = _count_chunks(eng)
    _reset_counters()
    results = [None] * len(prompts)

    def one(i):
        results[i] = _stream_completion(base, prompts[i])

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    bad = [r for r in results if r is None or r[0] != 200
           or r[3][-1] != "[DONE]"]
    if bad:
        raise AssertionError(f"{what}: failed streams {bad[:2]}")
    finals = [json.loads(r[3][-2])["choices"][0]["finish_reason"]
              for r in results]
    firsts, ends = [r[1] for r in results], [r[2] for r in results]
    ttft = eng.ttft.report()
    line = {"streams": len(prompts), "wall_s": wall,
            "client_first_chunk_ms": {"p50": _pct(firsts, 0.5) * 1e3,
                                      "p99": _pct(firsts, 0.99) * 1e3},
            "client_done_ms": {"p50": _pct(ends, 0.5) * 1e3,
                               "p99": _pct(ends, 0.99) * 1e3},
            "engine_ttft_ms": {"p50": ttft["p50"] * 1e3,
                               "p99": ttft["p99"] * 1e3},
            "chunks_per_stream": [len(r[3]) - 1 for r in results],
            "finish_reasons": finals}
    # n = 2: two choices of one prompt
    status, out = _http(base + "/v1/completions", {
        "prompt": prompts[0], "max_tokens": 8, "temperature": 0, "n": 2})
    if status != 200 or len(out["choices"]) != 2 or \
            out["usage"]["completion_tokens"] != 16:
        raise AssertionError(f"{what}: n=2 gave {status} {out}")
    # logprobs on the zero-weight tier: a uniform distribution
    status, out = _http(base + "/v1/completions", {
        "prompt": prompts[1], "max_tokens": 8, "temperature": 0,
        "logprobs": 5})
    uniform = -math.log(eng.cfg.vocab_size)
    lps = out["choices"][0]["logprobs"] if status == 200 else None
    lp_err = max(abs(v - uniform) for v in lps["token_logprobs"]
                 + [x for d in lps["top_logprobs"] for x in d.values()]) \
        if lps else None
    if lps is None or len(lps["token_logprobs"]) != 8 or \
            lp_err > GEOMETRY_LP_ATOL:
        raise AssertionError(f"{what}: logprobs {status} {out}, max "
                             f"|lp + log V| {lp_err}")
    line["logprobs_max_err_vs_uniform"] = lp_err
    # a budget of 1 ms: the deadline passes before the first step
    status, out = _http(base + "/v1/completions", {
        "prompt": prompts[2], "max_tokens": 8}, headers={
        "X-SHAI-Deadline-Ms": "1"})
    if status != 504:
        raise AssertionError(f"{what}: an expired deadline gave {status} "
                             f"{out}")
    line["deadline_504"] = out["detail"]
    counts = _read_counters()
    exact = _expected_walk(eng, before, chunks)
    _check_counters(f"{what} OpenAI round", counts, expect)
    _check_walk(f"{what} OpenAI round", counts, exact)
    line.update(launches=counts, walk=exact)
    # the /metrics page: the contract families, with their types
    status, text = _http(base + "/metrics", raw=True)
    types_ = dict(ln.split()[2:4] for ln in text.splitlines()
                  if ln.startswith("# TYPE "))
    missing = {n: t for n, t in METRIC_FAMILIES.items()
               if types_.get(n) != t}
    if status != 200 or missing:
        raise AssertionError(f"{what}: /metrics {status}, missing or "
                             f"mistyped {missing}")
    line["metric_families"] = len(types_)
    log(f"{what}: OpenAI round " + json.dumps(line))
    ctx.setdefault("openai", {})[what] = line


#: the kernel class of PyTorch's own attention kernels (SDPA), which no
#: serve phase may launch
LIBRARY_ATTENTION = "library attention (SDPA)"


def _kernel_class(name: str, walk: str) -> str:
    """The kernel class of a device event. ``walk`` names the wrapper whose
    launches the shared walk's kernels (tile, decode CTA, merge and row
    groups) are in this phase: B2 in ``serve``, B3 in ``serve_ragged`` and
    ``serve_fused``; each phase runs only one of the two."""
    if "flash_kernel" in name:
        return "B1 flash_attention"
    if any(k in name.lower() for k in ("fmha", "flash_fwd", "attention_kernel",
                                       "efficient_attention")):
        return LIBRARY_ATTENTION
    if any(k in name for k in ("ragged_kernel", "decode_kernel",
                               "merge_kernel", "groups_kernel")):
        return walk
    if any(k in name.lower() for k in ("fprop", "convolve", "conv2d",
                                       "cudnn", "nchwtonhwc", "nhwctonchw")):
        return "convolution (cuDNN)"
    if "int8_matmul_kernel<128" in name:
        return "B4 int8_matmul (wide)"
    if "int8_matmul_kernel" in name:
        return "B4 int8_matmul (decode)"
    if any(w in name.lower() for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    if "LogSoftMax" in name or "topk" in name.lower():
        return "logprob readout (log-softmax, top-k)"
    return "other (elementwise, norms, rope, sampling, scatter, copies)"


def _profile(torch, fn, walk: str) -> None:
    """Run ``fn`` once more under ``torch.profiler`` and print the device's
    busy share of the wall time and its time by kernel class. The trace
    goes to a temporary directory and is not kept. A second pass of the
    same work, so the timed pass above runs without the profiler."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    dev = sorted((e["ts"], e["ts"] + e["dur"], e) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "dur" in e)
    if not dev:
        log("profile: the profiler recorded no device activity; device "
            "busy share not measured")
        return None
    busy, end = 0.0, float("-inf")
    for a, b, _ in dev:     # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_class, by_name = {}, {}
    for a, b, e in dev:
        name = e.get("name", "") if e["cat"] == "kernel" else e["cat"]
        c = _kernel_class(name, walk)
        by_class[c] = by_class.get(c, 0.0) + (b - a)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    total = sum(by_class.values())
    log(f"profile: traced pass {wall_us / 1e6:.2f} s wall, device busy "
        f"{busy / 1e6:.3f} s = {busy / wall_us:.1%} of the wall; "
        f"{len(dev)} device events")
    for c, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {c}: {us / 1e3:.1f} ms = {us / total:.1%} of "
            f"device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:     {us / 1e3:.1f} ms {name[:100]}")
    if LIBRARY_ATTENTION in by_class:
        raise AssertionError("profile: a library attention kernel ran")
    return {"wall_s": wall_us / 1e6, "busy_s": busy / 1e6,
            "busy_share": busy / wall_us}


def _serve(ctx, what, env, prompts, expect, walk, openai=False, then=None,
           new_tokens=16):
    """Serve ``llama-8b-geometry`` over HTTP under ``env`` and send
    ``prompts`` concurrently: all must answer 200, exactly the kernels
    ``expect`` must rise, no block may leak. Prints TTFT/TPOT, ``/stats``
    and a profiled second pass; with ``openai``, then runs the OpenAI
    round; ``then(base, eng)`` runs last, before the recompile and leak
    checks. Each request asks for ``new_tokens``; a speculative engine's
    verify replays' B2/B3 launches are kept apart in
    ``ctx["verify_launches"]``. Returns the /generate responses. While it
    serves,
    ``ctx["serving"]`` holds the app, the service and the JSON-line push
    stream (kept off stdout)."""
    import torch

    _drop_engine_model(ctx)
    env = {"DEVICE": "cuda", "MODEL_ID": "llama-8b-geometry",
           "BATCH_SIZE": str(SERVE_REQUESTS), "PORT": "0", **env}
    with _env(env):
        from scalable_hw_agnostic_inference_tpu_torch.serve.app import (
            create_app,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import (
            Server,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
            MetricsPublisher,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
            VllmService,
        )
        from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
            ServeConfig,
        )
        from scalable_hw_agnostic_inference_tpu_torch.utils.latency import (
            LatencyCollector,
        )

        cfg = ServeConfig.from_env()
        service = VllmService(cfg)
        push = io.StringIO()
        app = create_app(cfg, service, publisher=MetricsPublisher(
            cfg.app, cfg.nodepool, cfg.pod_name, stream=push))
        ctx["serving"] = {"app": app, "service": service, "push": push}
        server = Server(app, host="127.0.0.1", port=0)
        host, port = server.start_background()
        base = f"http://{host}:{port}"
        try:
            t0 = time.monotonic()
            while True:
                status, body = _http(base + "/readiness")
                if status == 200:
                    break
                if status == 500 or time.monotonic() - t0 > 600:
                    raise AssertionError(f"{what}: not ready: {status} "
                                         f"{body}")
                time.sleep(0.5)
            eng = service._engine
            graphs = _graphs(eng)
            log(f"{what}: {cfg.model_id} ready in "
                f"{time.monotonic() - t0:.1f} s (load + warmup); engine "
                f"max_model_len {eng.ecfg.max_model_len}, buckets "
                f"{list(eng.ecfg.context_encoding_buckets)}, ragged "
                f"{eng._ragged}, int8 KV {eng._kv_quant}, async "
                f"{eng._async}; warmed {eng.obs.warmed_executables} "
                f"executables in {service.warm_seconds:.2f} s before "
                f"readiness: graphs {[g.key for g in graphs]}, capture s "
                f"{[round(g.capture_seconds, 3) for g in graphs]}, launches "
                f"per replay {graphs[0].launches}, graph pool "
                f"{eng._graphs.bytes()} bytes, KV pool "
                f"{eng.cache.pool_bytes} bytes")
            # async unless the caller's environment asks for lock-step
            want_async = os.environ.get("SHAI_ASYNC_DECODE", "1") != "0"
            if eng._async != want_async or not all(g.captured
                                                   for g in graphs):
                raise AssertionError(f"{what}: async {eng._async}, captured "
                                     f"{[g.captured for g in graphs]}")
            # latency instruments count from here: the warmup request is out
            eng.ttft, eng.tpot = LatencyCollector(), LatencyCollector()
            before = _replays(eng)
            chunks = _count_chunks(eng)
            _reset_counters()
            results, wall = _send_concurrent(base, prompts, new_tokens)
            counts = _read_counters()
            exact = _expected_walk(eng, before, chunks)
            after = _replays(eng)
            ctx.setdefault("verify_launches", {})[what] = {
                name: sum(g.launches.get(name, 0)
                          * (after[g.key] - before.get(g.key, 0))
                          for g in eng._verify_fns.values())
                for name in ("paged_decode_attention",
                             "ragged_paged_attention")}
            steps = sum(_replays(eng).values()) - sum(before.values())
            ctx.setdefault("launches", {})[what] = counts
            bad = [r for r in results if r is None or r[0] != 200]
            if bad:
                raise AssertionError(f"{what}: failed responses {bad[:2]}")
            n_prompt = [r[1]["n_prompt"] for r in results]
            n_tok = [r[1]["n_tokens"] for r in results]
            stats = _http(base + "/stats")[1]
            ttft = eng.ttft.report()
            tpot = eng.tpot.report()
            log(f"{what}: {len(prompts)} concurrent /generate -> 200 in "
                f"{wall:.2f} s, prompt tokens {n_prompt}, tokens {n_tok}; "
                f"launches {counts}; {steps} graph replays, "
                f"{len(chunks)} continuation chunks")
            log(f"{what}: TTFT p50 {ttft['p50'] * 1e3:.1f} ms p99 "
                f"{ttft['p99'] * 1e3:.1f} ms; TPOT p50 "
                f"{tpot['p50'] * 1e3:.2f} ms p99 {tpot['p99'] * 1e3:.2f} ms "
                f"(engine instruments); /stats {json.dumps(stats)}")
            busy = _profile(torch, lambda: _send_concurrent(base, prompts,
                                                            new_tokens),
                            walk)
            ctx.setdefault("serve_summary", {})[what] = {
                "ttft_ms": {"p50": ttft["p50"] * 1e3,
                            "p99": ttft["p99"] * 1e3},
                "tpot_ms": {"p50": tpot["p50"] * 1e3,
                            "p99": tpot["p99"] * 1e3},
                "traced_pass": busy,
                "step_gap_mean_ms": stats.get("step_gap_mean_ms"),
                "pipeline_flushes": eng.obs.flush_reasons(),
                "graph_pool_bytes": eng._graphs.bytes(),
                "kv_pool_bytes": eng.cache.pool_bytes,
                "spec": eng.spec.as_dict() if eng.spec is not None else None,
                "graphs": len(graphs)}
            _check_counters(what, counts, expect)
            _check_walk(what, counts, exact)
            if openai:
                _openai_round(ctx, what, base, eng, prompts, expect)
            if then is not None:
                then(base, eng)
            log(f"{what}: recompiles after warmup {eng.obs.recompiles}, "
                f"executables {eng.n_executables} (warmed "
                f"{eng.obs.warmed_executables}), pipeline flushes "
                f"{eng.obs.flush_reasons()}")
            if eng.obs.recompiles or \
                    eng.n_executables != eng.obs.warmed_executables:
                raise AssertionError(f"{what}: {eng.obs.recompiles} "
                                     f"recompiles after warmup")
            if eng.cache.leaked_blocks:
                raise AssertionError(f"{what}: leaked KV blocks")
            return results
        finally:
            ctx.pop("serving", None)
            server.stop()
            service.close()
            del service, app
            gc.collect()
            torch.cuda.empty_cache()


def phase_serve(ctx):
    # no engine ConfigMap: the unit derives its engine shapes from the
    # env, as a pod without one does (buckets 128 and 512, no chunking)
    _serve(ctx, "serve", {
        "VLLM_CONFIG": os.path.join(REPO, "no-vllm-config.yaml"),
        "SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": ""},
        _serve_prompts(), {"flash_attention", "paged_decode_attention"},
        "B2 paged_decode_attention", openai=True)


def phase_serve_ragged(ctx):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vllm_config.yaml")
        with open(path, "w") as f:
            json.dump(SERVE_RAGGED_CONFIG, f)   # JSON is YAML too
        results = _serve(ctx, "serve_ragged", {
            "VLLM_CONFIG": path, "SHAI_RAGGED_ATTENTION": "1",
            "SHAI_KV_QUANT": "int8"}, _serve_prompts((1500, 3000)),
            {"flash_attention", "ragged_paged_attention"},
            "B3 ragged_paged_attention")
    chunked = [r[1]["n_prompt"] for r in results if r[1]["n_prompt"] > 512]
    if len(chunked) != 2:
        raise AssertionError(f"serve_ragged: {len(chunked)} prompts past the "
                             f"512 bucket, want 2")


#: serve_spec's engine ConfigMap: serve's shapes for 128-token prompts and
#: 128-token outputs, with and without speculation
SERVE_SPEC_CONFIG = {"max_model_len": 1024, "block_size": 16,
                     "max_num_seqs": SERVE_REQUESTS,
                     "context_encoding_buckets": [128, 512],
                     "max_new_tokens": 128}
SERVE_SPEC_KEYS = {"speculative_model": "[ngram]",
                   "num_speculative_tokens": SPEC_K,
                   "ngram_prompt_lookup_max": 4, "ngram_prompt_lookup_min": 1}


def _spec_round(ctx, what, base, eng) -> None:
    """Two more requests asking for their token ids (``logprobs: 1``): the
    geometry tier's zero weights give all-equal logits, so every greedy
    token is id 0 with and without speculation; then, on a speculative
    pod, ``/stats`` carries the counters and ``/metrics`` the
    ``shai_spec_*`` families."""
    prompt = _spec_serve_prompts()[0]
    toks = []
    for _ in range(2):
        status, body = _http(base + "/generate", {
            "prompt": prompt, "temperature": 0.0, "max_new_tokens": 128,
            "logprobs": 1})
        if status != 200:
            raise AssertionError(f"{what}: {status} {body}")
        toks.append([e["token"] for e in body["logprobs"]])
    if toks[0] != [0] * 128 or toks[1] != toks[0]:
        raise AssertionError(f"{what}: tokens {toks[0][:8]}..., want 128 "
                             f"zeros")
    ctx.setdefault("spec_tokens", {})[what] = toks[0]
    if eng.spec is None:
        return
    stats = _http(base + "/stats")[1]
    svc = stats.get("service", stats)
    status, text = _http(base + "/metrics", raw=True)
    samples = {}
    for line in text.splitlines():
        if line.startswith("shai_spec_"):
            name, value = line.rsplit(" ", 1)
            samples[name.split("{")[0]] = float(value)
    want = {"shai_spec_drafted_total": eng.spec.drafted,
            "shai_spec_accepted_total": eng.spec.accepted,
            "shai_spec_committed_total": eng.spec.committed,
            "shai_spec_acceptance_rate": eng.spec.as_dict()[
                "spec_acceptance_rate"]}
    got = {k: samples.get(k) for k in want}
    if got != {k: float(v) for k, v in want.items()} or \
            svc.get("spec_verify_steps") != eng.spec.verify_steps:
        raise AssertionError(f"{what}: /metrics {got} against the engine's "
                             f"{want}; /stats verify steps "
                             f"{svc.get('spec_verify_steps')}")
    log(f"{what}: /metrics {got}; /stats "
        f"{ {k: v for k, v in svc.items() if k.startswith('spec_')} }")


def _spec_serve_prompts():
    """``SERVE_REQUESTS`` repetitive prompts of 128 tokens (127 bytes and
    the BOS): bench.py's shape, a 16-byte base repeated."""
    return [(f"{i:02d} base repeats " * 9)[:127]
            for i in range(SERVE_REQUESTS)]


def phase_serve_spec(ctx):
    import tempfile

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for what, keys in (("serve_spec", SERVE_SPEC_KEYS),
                           ("serve_spec off", {})):
            path = os.path.join(tmp, f"vllm_config_{len(keys)}.yaml")
            with open(path, "w") as f:
                json.dump({**SERVE_SPEC_CONFIG, **keys}, f)
            results = _serve(
                ctx, what, {"VLLM_CONFIG": path,
                            "SHAI_RAGGED_ATTENTION": "0",
                            "SHAI_KV_QUANT": ""},
                _spec_serve_prompts(),
                {"flash_attention", "paged_decode_attention"},
                "B2 paged_decode_attention", new_tokens=128,
                then=lambda base, eng, w=what: _spec_round(ctx, w, base,
                                                           eng))
            if any(r[1]["n_tokens"] != 128 or r[1]["n_prompt"] != 128
                   for r in results):
                raise AssertionError(f"{what}: {[r[1] for r in results]}")
            runs[what] = ctx["serve_summary"][what]
    on, off = runs["serve_spec"], runs["serve_spec off"]
    if on["spec"] is None or on["spec"]["spec_verify_steps"] == 0 or \
            off["spec"] is not None:
        raise AssertionError(f"serve_spec: spec {on['spec']}, off "
                             f"{off['spec']}")
    if ctx["verify_launches"]["serve_spec"]["paged_decode_attention"] == 0:
        raise AssertionError("serve_spec: no verify replay launched B2")
    log("serve_spec: " + json.dumps({
        "tokens_per_verify": on["spec"]["spec_tokens_per_verify"],
        "acceptance": on["spec"]["spec_acceptance_rate"],
        "tpot_ms": {"spec": on["tpot_ms"], "off": off["tpot_ms"]},
        "ttft_ms": {"spec": on["ttft_ms"], "off": off["ttft_ms"]},
        "busy": {"spec": on["traced_pass"], "off": off["traced_pass"]},
        "graph_pool_bytes": {"spec": on["graph_pool_bytes"],
                             "off": off["graph_pool_bytes"]},
        "graphs": {"spec": on["graphs"], "off": off["graphs"]},
        "verify_launches": ctx["verify_launches"]["serve_spec"]}))


def _fanout_round(ctx, base, eng) -> None:
    """One ``POST /v1/completions`` with ``n=4``, not streamed, on a prompt
    inside the 512 bucket: the group is admitted whole as one prefill with
    three copy-on-write forks, B3 exactly the layers times the fused
    replays, four choices, no leaked block."""
    cow0 = (eng.cache.cow_forks, eng.cache.cow_copies)
    before = _replays(eng)
    _reset_counters()
    status, out = _http(base + "/v1/completions", {
        "prompt": "fan me out: " + "tell me more " * 8, "max_tokens": 8,
        "temperature": 0, "n": 4})
    counts = _read_counters()
    exact = _expected_walk(eng, before, [])
    forks = eng.cache.cow_forks - cow0[0]
    copies = eng.cache.cow_copies - cow0[1]
    line = {"status": status, "choices": len(out.get("choices", [])),
            "usage": out.get("usage"), "cow_forks": forks,
            "cow_copies": copies, "launches": counts, "walk": exact,
            "leaked_blocks": eng.cache.leaked_blocks}
    log("serve_fused: n=4 round " + json.dumps(line))
    if status != 200 or line["choices"] != 4 or forks != 3:
        raise AssertionError(f"serve_fused: n=4 gave {status}, "
                             f"{line['choices']} choices, {forks} forks")
    _check_walk("serve_fused n=4", counts, exact)
    ctx["fanout"] = line


def phase_serve_fused(ctx):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vllm_config.yaml")
        with open(path, "w") as f:
            json.dump(SERVE_RAGGED_CONFIG, f)   # JSON is YAML too
        results = _serve(ctx, "serve_fused", {
            "VLLM_CONFIG": path, "SHAI_RAGGED_ATTENTION": "1",
            "SHAI_KV_QUANT": "int8", "SHAI_FUSED_STEP": "1",
            "SHAI_KV_COW": "1"}, _serve_prompts((1500, 3000)),
            {"flash_attention", "ragged_paged_attention"},
            "B3 ragged_paged_attention",
            then=lambda base, eng: _fanout_round(ctx, base, eng))
    chunked = [r[1]["n_prompt"] for r in results if r[1]["n_prompt"] > 512]
    if len(chunked) != 2:
        raise AssertionError(f"serve_fused: {len(chunked)} prompts past the "
                             f"512 bucket, want 2")
    summary = ctx["serve_summary"]
    log("serve_fused beside serve_ragged: " + json.dumps(
        {k: summary.get(k) for k in ("serve_ragged", "serve_fused")}))


#: the operating layer's settings for serve_ops (``SHAI_PERF_PROJECTED_TOK_S``
#: is a threshold the phase sets, not a measurement: serve decodes 8 rows
#: at hundreds of tokens a second); ``SHAI_WATCHDOG_MULT=2`` keeps the
#: watchdog's leash at its 2 s floor after the sentinel round's 0.25 s
#: steps entered the step ring (30 x their p99 would be some 8 s); the
#: SLO targets are generous ones that wire the SLO engine (and its
#: ``shai_slo_*`` families) without a breach
SERVE_OPS_ENV = {"MAX_INFLIGHT": "8", "SHAI_TRACE": "1",
                 "SHAI_FAULTS_ENDPOINT": "1",
                 "SHAI_PERF_PROJECTED_TOK_S": "50", "SHAI_PERF_WINDOW_S": "5",
                 "SHAI_WATCHDOG_MIN_S": "2", "SHAI_WATCHDOG_MULT": "2",
                 "DRAIN_BUDGET_S": "60", "SHAI_SLO_TTFT_MS": "10000",
                 "SHAI_SLO_TPOT_MS": "1000"}
#: the /metrics families the operating layer adds (prometheus names)
OPS_FAMILIES = ("shai_shed_total", "shai_service_", "shai_tenant_",
                "shai_hbm_", "shai_slo_", "shai_perf_", "shai_idemp_")


def _http_full(url: str, payload=None, headers=None, timeout: float = 300.0):
    """``(status, lowercased headers, JSON body or text)``."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, hdrs, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, e.headers, e.read()
    hdrs = {k.lower(): v for k, v in hdrs.items()}
    if hdrs.get("content-type", "").startswith("application/json"):
        return status, hdrs, json.loads(body or b"{}")
    return status, hdrs, body.decode()


def _ops_generate(base: str, i: int, n: int = 16, headers=None):
    return _http_full(base + "/generate", {
        "prompt": f"ops {i}: " + "tell me more " * (i % 5 + 1),
        "temperature": 0.0, "max_new_tokens": n}, headers=headers)


def _ops_concurrent(fn, n: int):
    res = [None] * n
    threads = [threading.Thread(target=lambda i=i: res.__setitem__(i, fn(i)))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(r is None for r in res):
        raise AssertionError("serve_ops: a request never returned")
    return res


def _shed_total(base: str) -> float:
    status, _, text = _http_full(base + "/metrics")
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("shai_shed_total{"))


def _set_faults(base: str, spec: str) -> None:
    status, _, body = _http_full(base + "/debug/faults", {"spec": spec})
    if status != 200:
        raise AssertionError(f"serve_ops: POST /debug/faults {spec!r} gave "
                             f"{status} {body}")


def _ops_hbm(ctx, base, eng, line) -> None:
    """The HBM ledger against the card: one tick with the engine idle,
    ``memory_allocated`` read right after it, then ``/debug/conformance``."""
    import torch

    t0 = time.monotonic()
    while eng.has_work or eng._pipe is not None:   # the loop goes idle
        if time.monotonic() - t0 > 30:
            raise AssertionError("serve_ops: the engine never went idle")
        time.sleep(0.01)
    eng._sample_hbm()
    allocated = torch.cuda.memory_allocated(eng.device)
    status, _, conf = _http_full(base + "/debug/conformance")
    hbm = conf["hbm"]
    weights = sum(p.nbytes for p in eng.model.parameters())
    total = torch.cuda.get_device_properties(eng.device).total_memory
    want = {"limit_bytes": float(total), "weights_bytes": float(weights),
            "kv_pool_bytes": float(eng.cache.pool_bytes),
            "used_bytes": float(allocated), "leak_suspect": 0.0,
            "device_stats": 1.0}
    got = {k: hbm.get(k) for k in want}
    line["hbm"] = {k: hbm[k] for k in (
        "used_bytes", "attributed_bytes", "unattributed_bytes",
        "weights_bytes", "kv_pool_bytes", "resident_bytes",
        "graph_pool_bytes", "split_scratch_bytes", "peak_bytes",
        "headroom_bytes", "limit_bytes")}
    line["hbm"]["unexplained_share"] = (hbm["unattributed_bytes"]
                                        / hbm["used_bytes"])
    log("serve_ops: HBM ledger " + json.dumps(line["hbm"]))
    if status != 200 or got != want:
        raise AssertionError(f"serve_ops: HBM ledger {got} != {want}")


def _ops_shed(base, eng, line) -> None:
    before = _shed_total(base)
    res = _ops_concurrent(lambda i: _ops_generate(base, i), 16)
    codes = [r[0] for r in res]
    n429 = codes.count(429)
    rose = _shed_total(base) - before
    no_ra = [r for r in res if r[0] == 429 and "retry-after" not in r[1]]
    line["shedding"] = {"codes": sorted(codes), "shed_total_rose": rose,
                        "retry_after": sorted({r[1].get("retry-after")
                                               for r in res if r[0] == 429})}
    log("serve_ops: 16 concurrent /generate under MAX_INFLIGHT=8 "
        + json.dumps(line["shedding"]))
    if set(codes) - {200, 429} or not n429 or no_ra or rose != n429 \
            or eng.cache.leaked_blocks:
        raise AssertionError(f"serve_ops: shedding {line['shedding']}, "
                             f"leaked {eng.cache.leaked_blocks}")


def _ops_idempotency(base, eng, line) -> None:
    key = {"X-SHAI-Idempotency-Key": "chip-smoke-ops-1"}
    admitted0 = eng.obs.queue_wait.count
    # the original and a duplicate at once (a join), then two replays
    res = _ops_concurrent(lambda i: _ops_generate(base, 1, headers=key), 2)
    res += [_ops_generate(base, 1, headers=key) for _ in range(2)]
    admitted = eng.obs.queue_wait.count - admitted0
    bodies = []
    for status, _, body in res:
        body = dict(body)
        body.pop("idempotent_replay", None)
        bodies.append(json.dumps(body, sort_keys=True))
    idem = _http_full(base + "/stats")[2].get("idempotency", {})
    line["idempotency"] = {"codes": [r[0] for r in res],
                           "replays": sum(bool(r[2].get("idempotent_replay"))
                                          for r in res),
                           "engine_admitted": admitted, "cache": idem}
    log("serve_ops: one key four times " + json.dumps(line["idempotency"]))
    if [r[0] for r in res] != [200] * 4 or len(set(bodies)) != 1 \
            or admitted != 1:
        raise AssertionError(f"serve_ops: idempotency {line['idempotency']}"
                             f", {len(set(bodies))} distinct bodies")


def _ops_tracing(base, line) -> None:
    from scalable_hw_agnostic_inference_tpu_torch.obs.trace import (
        well_formed_problems,
    )

    tid = os.urandom(16).hex()
    tp = f"00-{tid}-{os.urandom(8).hex()}-01"
    status, hdrs, _ = _ops_generate(base, 2, headers={"traceparent": tp})
    back = hdrs.get("traceparent", "")
    t_status, _, traced = _http_full(base + f"/trace/{tid}")
    spans = [s["name"] for t in traced.get("traces", []) for s in t["spans"]]
    problems = [p for t in traced.get("traces", [])
                for p in well_formed_problems(t)]
    flight = _http_full(base + "/debug/flight")[2]
    in_flight = tid in {r["trace_id"] for r in flight["requests"]}
    line["tracing"] = {"status": status, "traceparent_back": back,
                       "trace_status": t_status, "spans": spans,
                       "in_flight_recorder": in_flight,
                       "engine_steps_dumped": len(flight["engine_steps"])}
    log("serve_ops: traced request " + json.dumps(line["tracing"]))
    if status != 200 or back.split("-")[1:2] != [tid] or t_status != 200 \
            or problems or "model_infer" not in spans or not in_flight:
        raise AssertionError(f"serve_ops: tracing {line['tracing']} "
                             f"{problems}")


def _ops_sentinel(base, line) -> None:
    perf0 = _http_full(base + "/debug/conformance")[2]["perf"]
    _set_faults(base, "engine.step=delay(0.25)")
    res = _ops_concurrent(lambda i: _ops_generate(base, i), 8)
    slow = _http_full(base + "/debug/conformance")[2]["perf"]
    _set_faults(base, "")
    time.sleep(5.5)   # SHAI_PERF_WINDOW_S and a margin
    after = _http_full(base + "/debug/conformance")[2]["perf"]
    line["sentinel"] = {"before": perf0, "slowed": slow, "after": after,
                        "codes": [r[0] for r in res]}
    log("serve_ops: sentinel " + json.dumps(line["sentinel"]))
    if perf0["degraded"] or perf0["conformance"] < 1.0 \
            or not slow["degraded"] or slow["live_per_s"] > 32.0 \
            or after["degraded"] or [r[0] for r in res] != [200] * 8:
        raise AssertionError(f"serve_ops: sentinel {line['sentinel']}")


def _ops_watchdog(base, eng, line) -> None:
    replays0 = sum(_replays(eng).values())
    _set_faults(base, "engine.step=stall(3)#1")
    box = {}
    t = threading.Thread(target=lambda: box.setdefault(
        "r", _ops_generate(base, 3)))
    t0 = time.monotonic()
    t.start()
    stuck = None
    while time.monotonic() - t0 < 10.0 and stuck is None:
        h = _http_full(base + "/health")
        if h[0] == 503:
            stuck = (round(time.monotonic() - t0, 3), h[2])
        time.sleep(0.05)
    t.join(timeout=120)
    _set_faults(base, "")
    health = _http_full(base + "/health")
    replays = sum(_replays(eng).values()) - replays0
    line["watchdog"] = {"stuck_at_s": stuck and stuck[0],
                        "health_503": stuck and stuck[1],
                        "request": box.get("r", (None,))[0],
                        "health_after": health[0], "replays": replays,
                        "recompiles": eng.obs.recompiles}
    log("serve_ops: step stall " + json.dumps(line["watchdog"]))
    if stuck is None or "stalled" not in stuck[1].get("error", "") \
            or box.get("r", (None,))[0] != 200 or health[0] != 200 \
            or not replays or eng.obs.recompiles:
        raise AssertionError(f"serve_ops: watchdog {line['watchdog']}")


def _ops_benchmark(ctx, base, line) -> None:
    b_status, _, bench = _http_full(base + "/benchmark", {"n_runs": 3})
    l_status, _, load = _http_full(base + "/load/2/infer/2")
    s_status, s_hdrs, page = _http_full(base + "/serve")
    line["benchmark"] = {"status": b_status, "report": bench.get("report"),
                         "card": ctx.get("card")}
    line["load"] = {"status": l_status, "rounds": load.get("rounds"),
                    "card": ctx.get("card")}
    log("serve_ops: POST /benchmark " + json.dumps(line["benchmark"]))
    log("serve_ops: GET /load/2/infer/2 " + json.dumps(line["load"]))
    if b_status != 200 or l_status != 200 or len(load["rounds"]) != 2 \
            or s_status != 200 or "/generate" not in page \
            or not s_hdrs["content-type"].startswith("text/html"):
        raise AssertionError(f"serve_ops: /benchmark {b_status}, /load "
                             f"{l_status}, /serve {s_status}")


def _ops_drain(base, app, service, eng, line) -> None:
    res = {}
    threads = [threading.Thread(target=lambda i=i: res.__setitem__(
        i, _ops_generate(base, i, n=64))) for i in range(4)]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    while app.state["status"]["inflight"] < 4:
        if time.monotonic() - t0 > 30:
            raise AssertionError("serve_ops: the drain round never went "
                                 "in flight")
        time.sleep(0.005)
    t_drain = time.monotonic()
    app.state["begin_drain"]()
    ready = None
    while time.monotonic() - t_drain < 1.0:
        ready = _http_full(base + "/readiness")
        if ready[0] == 503:
            break
        time.sleep(0.02)
    ready_s = time.monotonic() - t_drain
    shed = _http_full(base + "/generate", {"prompt": "late",
                                           "max_new_tokens": 4})
    for t in threads:
        t.join(timeout=600)
    while "drained" not in app.state["status"]:
        if time.monotonic() - t_drain > 90:
            raise AssertionError("serve_ops: the drain never returned")
        time.sleep(0.05)
    drained = app.state["status"]["drained"]
    line["drain"] = {"readiness": [ready[0], ready[2]],
                     "readiness_s": round(ready_s, 3),
                     "late_post": [shed[0], shed[1].get("retry-after")],
                     "inflight_codes": [res[i][0] for i in range(4)],
                     "clean": drained["clean"],
                     "seconds": drained["seconds"],
                     "loop_alive": service.loop.alive,
                     "replay_in_flight": eng._pipe is not None,
                     "leaked_blocks": eng.cache.leaked_blocks}
    log("serve_ops: drain " + json.dumps(line["drain"]))
    if ready[0] != 503 or ready[2] != {"status": "draining"} \
            or shed[0] != 503 or "retry-after" not in shed[1] \
            or line["drain"]["inflight_codes"] != [200] * 4 \
            or not drained["clean"] or drained["seconds"] > 60 \
            or service.loop.alive or eng._pipe is not None \
            or eng.cache.leaked_blocks:
        raise AssertionError(f"serve_ops: drain {line['drain']}")


def _ops_metrics(base, line) -> None:
    slo = _http_full(base + "/debug/conformance")[2]["slo"]
    line["slo"] = slo
    log("serve_ops: SLO burn " + json.dumps(slo))
    if slo is None or slo["breach"]:
        raise AssertionError(f"serve_ops: SLO {slo}")
    _, _, text = _http_full(base + "/metrics")
    fams = sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE ")
                   and ln.split()[2].startswith(OPS_FAMILIES)})
    line["metric_families"] = fams
    log("serve_ops: operating-layer /metrics families " + json.dumps(fams))
    missing = [p for p in OPS_FAMILIES
               if not any(f.startswith(p) for f in fams)]
    if missing:
        raise AssertionError(f"serve_ops: /metrics lacks {missing}")


def _serve_ops_round(ctx, base, eng) -> None:
    """The operating layer's ten checks, in order (the plain round ran in
    ``_serve``); nothing here catches its own failure."""
    from scalable_hw_agnostic_inference_tpu_torch.resilience import faults

    app = ctx["serving"]["app"]
    service = ctx["serving"]["service"]
    summary = ctx["serve_summary"]
    line = {"plain": {k: summary["serve_ops"][k] for k in (
        "ttft_ms", "tpot_ms", "step_gap_mean_ms")},
        "serve": {k: summary["serve"][k] for k in (
            "ttft_ms", "tpot_ms", "step_gap_mean_ms")}
        if "serve" in summary else "not run in this call",
        "card": ctx.get("card")}
    log("serve_ops: plain round beside serve " + json.dumps(line))
    try:
        _ops_hbm(ctx, base, eng, line)
        _ops_shed(base, eng, line)
        _ops_idempotency(base, eng, line)
        _ops_tracing(base, line)
        _ops_sentinel(base, line)
        _ops_watchdog(base, eng, line)
        _ops_benchmark(ctx, base, line)
        _ops_drain(base, app, service, eng, line)
        _ops_metrics(base, line)
    finally:
        faults.reset()   # the next phase starts from the env's schedule
    pushed = ctx["serving"]["push"].getvalue().splitlines()
    line["json_lines_pushed"] = len(pushed)
    if not pushed or "hw-agnostic-infer" not in pushed[0]:
        raise AssertionError("serve_ops: no JSON-line push")
    ctx["serve_ops"] = line


def phase_serve_ops(ctx):
    # serve's configuration (bucketed, B1 prefill, B2 decode, async, CUDA
    # graphs) under the operating layer's settings
    _serve(ctx, "serve_ops", {
        "VLLM_CONFIG": os.path.join(REPO, "no-vllm-config.yaml"),
        "SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "", **SERVE_OPS_ENV},
        _serve_prompts(), {"flash_attention", "paged_decode_attention"},
        "B2 paged_decode_attention",
        then=lambda base, eng: _serve_ops_round(ctx, base, eng))


# -- int8 weight-only projections (W8A16) ---------------------------------

#: the int8 kernel against its plain version (the reference's expression on
#: the same card): each output within INT8_ULPS bf16 ulps of the plain
#: output, the ulp taken at max(|plain|, K 2^-24 sum_k |x w s|). Both round
#: the fp32 sum to bf16, multiply by the bf16 scale and round again, so
#: their outputs differ by the fp32 sums' order plus those roundings (at
#: most an ulp and a half); below K 2^-24 sum|terms|, the worst-case fp32
#: error of a K-term sum in any order, an ulp is smaller than what two
#: orders may differ by. A plain version short of one 16-wide K slice moves
#: each output by some sqrt(16 / K) of its size, tens of ulps, and must
#: fail the same check.
INT8_ULPS = 2.0
#: (N, K) of Llama-3-8B's projections: q and o, k and v, gate and up,
#: down, and the lm_head; each at every decode batch in INT8_ROWS (the
#: decode instantiation) and every width in INT8_WIDE_ROWS (the wide one:
#: a chunk, a 512-token prefill, four of them)
INT8_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
               (128256, 4096))
INT8_ROWS = (1, 4, 8, 64)
INT8_WIDE_ROWS = (128, 512, 2048)
#: the rows of the kernels line: serve's decode batch on the gate/up shape
#: (the largest share of a decode step's weight bytes), and a 512-token
#: prefill call on the same shape
INT8_MAIN = (8, 14336, 4096)
INT8_WIDE_MAIN = (512, 14336, 4096)
#: one Llama-3-8B layer's projections (q, o, k, v, gate, up, down)
INT8_LAYER = [(4096, 4096)] * 2 + [(1024, 4096)] * 2 + \
    [(14336, 4096)] * 2 + [(4096, 14336)]


def _bf16_ulp(torch, a):
    _, e = torch.frexp(a.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(a), e - 8)


def _int8_ulps(torch, got, want, x, wq, scale) -> float:
    """The largest |got - want| in bf16 ulps (see ``INT8_ULPS``)."""
    K = x.shape[1]
    mag = (x.float().abs() @ wq.float().abs().T) * scale.abs()
    floor = mag * (K * 2.0 ** -24)
    err = (got.float() - want.float()).abs()
    ulp = _bf16_ulp(torch, torch.maximum(want.float().abs(), floor))
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((err / ulp).max())


def _ptxas(kernel: str):
    """``{instantiation: "registers, stack and spills"}`` of one kernel from
    the build log (``-Xptxas=-v``), named by its two template arguments."""
    import re

    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import _build

    out, name = {}, None
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"{kernel}ILi(\d+)ELi(\d+)E", line)
            name = f"{kernel}<{m.group(1)}, {m.group(2)}>" if m else None
        elif name and ("registers" in line or "spill" in line.lower()):
            out[name] = (out.get(name, "") + " "
                         + line.split(":", 1)[-1].strip()).strip()
    return out


def phase_int8_matmul(ctx):
    import torch

    # the plain version's bf16 product with fp32 reductions throughout
    # (restored for the later phases)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _int8_matmul_cases(ctx, torch, reduced)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _int8_matmul_cases(ctx, torch, reduced):
    import re

    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        int8_matmul as i8,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_weight,
    )

    gen = torch.Generator(device="cuda").manual_seed(21)
    timer = ctx["timer"]
    matmul = torch.backends.cuda.matmul
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst, failed = [], 0.0, []
    for N, K in INT8_SHAPES:
        w = torch.randn(N, K, generator=gen, device="cuda") * 0.02
        wq, scale = quantize_weight(w)
        wb = w.to(torch.bfloat16)   # the bf16 projection int8 must beat
        del w
        for M in INT8_ROWS + INT8_WIDE_ROWS:
            x = torch.randn(M, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            out = i8.int8_matmul(x, wq, scale)
            ref = i8.int8_matmul_reference(x, wq, scale)
            cut = i8.int8_matmul_reference(x[:, 16:], wq[:, 16:], scale)
            torch.cuda.synchronize()
            ulps = _int8_ulps(torch, out, ref, x, wq, scale)
            cut_ulps = _int8_ulps(torch, cut, ref, x, wq, scale)
            err = float((out.float() - ref.float()).abs().max())
            del out, cut
            ms = timer(lambda: i8.int8_matmul(x, wq, scale), clean=True)
            plain = timer(lambda: i8.int8_matmul_reference(x, wq, scale),
                          clean=True)
            linear = timer(lambda: torch.nn.functional.linear(x, wb),
                           clean=True)
            # the route the kernel replaces past 64 rows: the dequantized
            # copy and the GEMM under the serving default (bf16 reductions
            # allowed), as the engine ran it
            matmul.allow_bf16_reduced_precision_reduction = reduced
            replaced = timer(lambda: i8.int8_matmul_reference(x, wq, scale),
                             clean=True)
            matmul.allow_bf16_reduced_precision_reduction = False
            n_bytes = N * K + 4 * N + 2 * M * K + 2 * M * N
            bms, by = bound_ms(n_bytes, 2.0 * M * N * K)
            plan = i8.int8_plan(M, N, K, sms)
            line = {"shape": f"M={M} N={N} K={K}", "M": M, "N": N, "K": K,
                    "instantiation": "wide" if plan.wide else "decode",
                    "x_rows": plan.rows, "ctas": plan.ctas,
                    "split": plan.splits,
                    "max_abs_err": err, "max_ulps": ulps,
                    "dropped_slice_ulps": cut_ulps, "ms": ms,
                    "plain_ms": plain, "library_ms": linear,
                    "bf16_linear_ms": linear, "replaced_route_ms": replaced,
                    "bound_ms": bms, "bound_by": by,
                    "bound_share": bms / ms}
            log("int8_matmul: " + json.dumps(line))
            rows.append(line)
            worst = max(worst, err)
            if ulps > INT8_ULPS:
                failed.append(f"{line['shape']}: {ulps:.2f} ulps from the "
                              f"plain version")
            if cut_ulps <= INT8_ULPS:
                failed.append(f"{line['shape']}: the check misses a "
                              f"dropped K slice")
            del x, ref
        del wq, scale, wb
        torch.cuda.empty_cache()
    # one tensor-parallel rank's projections (TP_INT8_PLANS)
    ctx["int8_ranks"] = _int8_rank_rows(ctx, torch, i8, quantize_weight,
                                        gen, failed)
    if failed:
        raise AssertionError(f"int8_matmul: {failed}")
    # calls the kernel does not take raise: no quiet fallback on the card
    x = torch.randn(8, 4096, device="cuda").to(torch.bfloat16)
    wq = torch.zeros(1024, 4096, dtype=torch.int8, device="cuda")
    sc = torch.ones(1024, device="cuda")
    bad = {"float32 x": (x.float(), wq, sc),
           "no rows": (x[:0], wq, sc),
           "strided x": (torch.randn(8, 8192, device="cuda").to(
               torch.bfloat16)[:, ::2], wq, sc),
           "misaligned x": (torch.zeros(8 * 4096 + 8, dtype=torch.bfloat16,
                                        device="cuda")[1:1 + 8 * 4096]
                            .view(8, 4096), wq, sc),
           "N % 8": (x, wq[:1020], sc[:1020]),
           "K % 16": (x[:, :4088].contiguous(),
                      wq[:, :4088].contiguous(), sc),
           "mismatched K": (x, wq[:, :2048].contiguous(), sc),
           "float32 weight": (x, wq.float(), sc)}
    for what, args in bad.items():
        try:
            i8.int8_matmul(*args)
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"int8_matmul took a call its kernel does not "
                             f"({what})")
    regs = _ptxas("int8_matmul_kernel")
    log(f"int8_matmul: ptxas {json.dumps(regs)}; refused {sorted(bad)}")
    spills = {k: v for k, v in regs.items() if not re.search(
        r"\b0 bytes spill stores, 0 bytes spill loads", v)}
    if spills or len(regs) != 6:
        raise AssertionError(f"int8_matmul: ptxas {regs}")
    # a decode step's projections at each decode batch and a prefill's at
    # each wide width, summed over 32 layers (q, k, v, o, gate, up, down)
    # and the lm_head (decode) from the shapes above
    by = {(r["M"], r["N"], r["K"]): r for r in rows}
    sums = {}
    for M in INT8_ROWS + INT8_WIDE_ROWS:
        shapes = [(n, k, 32) for n, k in INT8_LAYER]
        if M in INT8_ROWS:
            shapes.append((128256, 4096, 1))
        sums[M] = {key: sum(c * by[(M, n, k)][key] for n, k, c in shapes)
                   for key in ("ms", "bf16_linear_ms", "replaced_route_ms",
                               "bound_ms")}
    log(f"int8_matmul: a Llama-3-8B step's projections (ms, summed from "
        f"the shapes above; the lm_head at decode widths only): "
        f"{json.dumps(sums)}")
    summary = [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                  "bf16_linear_ms", "replaced_route_ms",
                                  "bound_ms", "max_ulps")} for r in rows]
    ctx["int8"] = dict(by[INT8_MAIN], max_abs_err=worst, registers=regs,
                       step_ms=sums, all_shapes=summary)
    ctx["int8_wide"] = dict(by[INT8_WIDE_MAIN], max_abs_err=max(
        r["max_abs_err"] for r in rows if r["instantiation"] == "wide"))


def _int8_model(ctx):
    """The engine phases' model with every projection quantized at boot
    (``ops.quant.quantize_state_dict``, the unit's path); the bf16 model is
    dropped once it is made."""
    if "engine_model_int8" not in ctx:
        import torch
        from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
            LlamaForCausalLM,
        )
        from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
            quantize_state_dict,
        )

        cfg, model = _engine_model(ctx)
        t0 = time.monotonic()
        state = quantize_state_dict(dict(model.state_dict()))
        ctx["engine_model_int8"] = cfg, LlamaForCausalLM.from_state_dict(
            cfg, state)
        log(f"engine_int8: quantized at boot in {time.monotonic() - t0:.1f}"
            f" s, weights {sum(t.nbytes for t in state.values())} bytes")
        del model, state
        ctx.pop("engine_model", None)
        gc.collect()
        torch.cuda.empty_cache()
    return ctx["engine_model_int8"]


def phase_engine_int8(ctx):
    import torch

    cfg, qmodel = _int8_model(ctx)
    # the engine helpers read ctx["engine_model"]: the int8 model here
    ctx["engine_model"] = cfg, qmodel
    per = 7 * cfg.n_layers + 1
    try:
        # a captured decode step against its eager call, bit for bit, with
        # its 7 x n_layers + 1 int8 launches
        graph = _decode_graph_case(ctx, torch, "engine_int8 bucketed",
                                   [32, 71, 110, 149, 188, 227, 266, 305],
                                   False, False, 32)
        # and a captured verify step over the int8 weights: its 40 rows
        # through B4's decode instantiation, as many launches
        vgraph = _verify_graph_case(ctx, torch, "engine_int8 verify",
                                    [27, 66, 105, 144, 183, 222, 261, 300],
                                    False, False, 32)
        runs = {}
        for what, prompts, switches, expect, cont, rule in (
                # bucketed: prefill through B1, decode B2, projections
                # through B4's decode (decode, lm_head) and wide (prefill,
                # chunks) instantiations
                ("engine_int8 (a)", (5, 37, 120, 300, 1300), {},
                 {"flash_attention", "paged_decode_attention",
                  "int8_matmul", "int8_matmul_wide"}, ("cont", 32, 512),
                 "tie"),
                # ragged attention and int8 KV: B3, scored as
                # engine_ragged's int8 KV run is
                ("engine_int8 (b)", ENGINE_PROMPTS,
                 {"SHAI_RAGGED_ATTENTION": "1", "SHAI_KV_QUANT": "int8"},
                 {"flash_attention", "ragged_paged_attention",
                  "int8_matmul", "int8_matmul_wide"}, ("rcont", 512),
                 "int8")):
            info, counts, sync = _run_engine(ctx, what, prompts, switches,
                                             expect, cont, rule)
            # every graph of the async and the lock-step run holds 7 x
            # n_layers + 1 int8 launches, and the async run made that many
            # per replay
            bad = [r["int8_per_replay"] for r in (info, sync)
                   if r["int8_per_replay"] != [per]]
            if bad or counts["int8_matmul"] < per * info["replays"]:
                raise AssertionError(
                    f"{what}: int8 launches per replay {bad}, "
                    f"{counts['int8_matmul']} launches for "
                    f"{info['replays']} replays")
            runs[what] = {"int8_launches": counts["int8_matmul"],
                          "wide_launches": counts["int8_matmul_wide"],
                          "replays": info["replays"],
                          "per_replay": per, "replay_ms": info["replay_ms"]}
        # (c) the fused step over int8 weights: every fused replay's
        # 512-token window runs B4's wide instantiation inside the graph;
        # tokens held to the laddered run's by the tie rule
        _run_fused(ctx, "engine_int8 (c)", {"SHAI_RAGGED_ATTENTION": "1"})
        fused = ctx["engine_fused"]["engine_int8 (c)"]
        runs["engine_int8 (c)"] = fused
        log("engine_int8: " + json.dumps(runs))
        ctx["engine_int8"] = {"graph": {k: graph[k] for k in (
            "bit_exact", "graph_launches", "device_ms_replay",
            "wall_ms_replay", "pool_bytes")}, "verify_graph": {
                k: vgraph[k] for k in ("bit_exact", "graph_launches",
                                       "device_ms_replay", "wall_ms_replay",
                                       "pool_bytes")}, "runs": runs}
    finally:
        ctx.pop("engine_model", None)


# -- a Llama checkpoint directory ------------------------------------------

#: the checkpoint phase's text: the BPE merges are learned from it, and its
#: prompts come from it
CKPT_CORPUS = (
    "The paged engine serves Llama checkpoints from a local directory. "
    "Each tensor goes to the card one at a time; int8 halves the bytes "
    "a decode step reads. Café, déjà vu, 日本語, emoji 🚀, numbers 12345.")
#: special tokens, numbered right after the BPE vocabulary (as Llama-3's
#: follow its 128,000 entries; ``tokenizers`` renumbers added tokens so)
CKPT_SPECIAL = ("<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>")
#: the instruct tokenizer's header tokens, special in the chat checkpoint
#: as in Llama-3-Instruct's
CHAT_SPECIAL = ("<|start_header_id|>", "<|end_header_id|>")


#: meta-llama/Meta-Llama-3-8B-Instruct's chat template, as published
#: (``tests/chat_templates.py`` holds it against the published four)
LLAMA3_INSTRUCT_TEMPLATE = (
    r"{% set loop_messages = messages %}{% for message in loop_messages %}"
    r"{% set content = '<|start_header_id|>' + message['role'] + "
    r"'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    r"{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    r"{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    r"{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
#: llava-hf/llava-1.5-7b-hf's chat template, as published
LLAVA15_TEMPLATE = (
    r"{% for message in messages %}{% if message['role'] != 'system' %}"
    r"{{ message['role'].upper() + ': '}}{% endif %}"
    r"{# Render all images first #}{% for content in message['content'] | "
    r"selectattr('type', 'equalto', 'image') %}{{ '<image>\n' }}"
    r"{% endfor %}{# Render all text next #}"
    r"{% if message['role'] != 'assistant' %}{% for content in "
    r"message['content'] | selectattr('type', 'equalto', 'text') %}"
    r"{{ content['text'] + ' '}}{% endfor %}{% else %}{% for content in "
    r"message['content'] | selectattr('type', 'equalto', 'text') %}"
    r"{% generation %}{{ content['text'] + ' '}}{% endgeneration %}"
    r"{% endfor %}{% endif %}{% endfor %}{% if add_generation_prompt %}"
    r"{{ 'ASSISTANT:' }}{% endif %}")


def _write_tokenizer(path, merges_wanted: int = 200,
                     specials=CKPT_SPECIAL) -> None:
    """A byte-level BPE ``tokenizer.json`` in Llama-3's layout (its Split
    regex, the ByteLevel steps, the BOS template, ``specials`` after the
    vocabulary, BOS and EOS the first two), with merges learned here from
    ``CKPT_CORPUS``: the most frequent adjacent pair of the pre-tokenized
    pieces, merged, again."""
    from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
        BYTE_TO_CHAR,
        LLAMA3_SPLIT,
        pre_tokenize,
    )

    vocab = {BYTE_TO_CHAR[b]: i for i, b in enumerate(range(256))}
    words = [[BYTE_TO_CHAR[b] for b in piece.encode()]
             for piece in pre_tokenize(CKPT_CORPUS * 3)]
    merges = []
    while len(merges) < merges_wanted:
        pairs = {}
        for w in words:
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] = pairs.get((a, b), 0) + 1
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
        for w in words:
            i = 0
            while i < len(w) - 1:
                if (w[i], w[i + 1]) == (a, b):
                    w[i:i + 2] = [a + b]
                i += 1
    bos = specials[0]
    special = {t: len(vocab) + i for i, t in enumerate(specials)}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for t, i in special.items()],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [], "special_tokens": {bos: {
                 "id": bos, "ids": [special[bos]], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }
    (path / "tokenizer.json").write_text(json.dumps(spec))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": bos, "eos_token": specials[1],
        "clean_up_tokenization_spaces": True,
        "model_max_length": 131072,
        "tokenizer_class": "PreTrainedTokenizerFast"}))


def _write_checkpoint(path, state, cfg, specials=CKPT_SPECIAL) -> int:
    """The port's state dict as an HF Llama directory: ``config.json``, two
    safetensors shards under their HF names, the tokenizer with
    ``specials``. Returns the bytes of the shards."""
    from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
        save_sharded,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.convert import (
        hf_name,
    )

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
        "intermediate_size": cfg.mlp_dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                         "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192},
        "tie_word_embeddings": cfg.tie_embeddings, "hidden_act": "silu",
        "torch_dtype": "bfloat16"}))
    paths = save_sharded({hf_name(k): v for k, v in state.items()}, path, 2)
    _write_tokenizer(path, specials=specials)
    return sum(p.stat().st_size for p in paths)


def _seeded_1b_dir(ctx):
    """The seeded Llama-3.2-1B-width checkpoint directory (the checkpoint
    phase's weights, seed 9) that serve_disagg and serve_fleet serve:
    written once a run, removed when the run ends."""
    if "seeded_1b" not in ctx:
        import dataclasses
        import tempfile

        import torch
        from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
            LlamaConfig,
            random_params,
        )

        cfg = dataclasses.replace(LlamaConfig.llama32_1b(),
                                  max_seq_len=131072,
                                  rope_scaling=(32.0, 1.0, 4.0, 8192))
        state = random_params(cfg, seed=9, std=0.02, device="cuda")
        path = Path(tempfile.mkdtemp(prefix="shai-1b-")) / "llama-3.2-1b"
        t0 = time.monotonic()
        _write_checkpoint(path, state, cfg)
        ctx["seeded_1b_write_s"] = time.monotonic() - t0
        del state
        gc.collect()
        torch.cuda.empty_cache()
        ctx["seeded_1b"] = path
    return ctx["seeded_1b"]


def _ckpt_boot(ctx, path, quant: bool):
    """The unit on ``MODEL_ID=<path>`` behind the stdlib server; returns
    (service, base url, server)."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
        VllmService,
    )
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    env = {"DEVICE": "cuda", "MODEL_ID": str(path), "PORT": "0",
           "MAX_SEQ_LEN": "256", "MAX_NEW_TOKENS": "16", "BATCH_SIZE": "4",
           "QUANTIZATION": "int8" if quant else "",
           "VLLM_CONFIG": os.path.join(REPO, "no-vllm-config.yaml"),
           "SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": ""}
    with _env(env):
        cfg = ServeConfig.from_env()
        service = VllmService(cfg)
        server = Server(create_app(cfg, service), host="127.0.0.1", port=0)
        host, port = server.start_background()
        base = f"http://{host}:{port}"
        t0 = time.monotonic()
        while _http(base + "/readiness")[0] != 200:
            if time.monotonic() - t0 > 600 or \
                    _http(base + "/readiness")[0] == 500:
                raise AssertionError(f"checkpoint: not ready "
                                     f"{_http(base + '/readiness')}")
            time.sleep(0.2)
    return service, base, server


#: the chat round's conversation on a Llama-3 directory: several turns of
#: string content, a system message first
CHAT_TURNS = (
    {"role": "system", "content": "Be brief."},
    {"role": "user", "content": "What does a paged cache store?"},
    {"role": "assistant", "content": "Keys and values."},
    {"role": "user", "content": "Why int8?"})
#: the same on a LLaVA directory, as parts (llava-1.5's template renders
#: only parts), an image part first: the route is text only, so the image
#: is the ``<image>`` token and no pixels reach the engine
CHAT_PARTS = (
    {"role": "user", "content": [{"type": "image"},
                                 {"type": "text", "text": "What is this?"}]},
    {"role": "assistant", "content": [
        {"type": "text", "text": "A disc over a gradient."}]},
    {"role": "user", "content": [
        {"type": "text", "text": "Describe its colours in detail."}]})
#: chat and completions requests each, for the TTFT comparison
CHAT_TTFT_REPS = 3


def _chat_round(ctx, what, base, service, messages, new_tokens=16):
    """``/v1/chat/completions`` under the directory's chat template, once
    buffered and once streamed, each held to five things: it answers 200;
    the prompt ids the engine receives equal the port tokenizer's ids of
    its own render without special tokens; BOS is there once, at position
    0, where the template renders it (never a second: llava-1.5's renders
    none, so its prompt has none, as in the reference); its greedy tokens
    equal a ``/generate`` of the rendered text with
    ``"add_special_tokens": false``; and that ``/generate`` with the
    switch on has a prompt one token longer. Then the render's host ms
    (the best of five) and the engine's TTFT of the chat route beside
    ``/v1/completions``' on the same text. Every number is logged before
    the checks; returns the logged row."""
    from scalable_hw_agnostic_inference_tpu_torch.utils.latency import (
        LatencyCollector,
    )

    messages = [dict(m) for m in messages]
    tok, eng = service.tokenizer, service._engine
    renders = []
    for _ in range(5):
        t0 = time.perf_counter()
        text = tok.apply_chat_template(messages, add_generation_prompt=True)
        renders.append((time.perf_counter() - t0) * 1e3)
    want_ids = tok.encode(text, add_special_tokens=False)
    if len(want_ids) + 1 > eng.max_prompt_len:
        raise AssertionError(f"{what} chat: the rendered prompt's "
                             f"{len(want_ids)} tokens do not fit the "
                             f"engine's {eng.max_prompt_len}")
    seen = []
    submit = service.loop.submit

    def spy(ids, *a, **k):
        # the engine's view of each request: its prompt ids and tokens
        rec = {"ids": list(ids)}
        seen.append(rec)
        fut = submit(ids, *a, **k)
        fut.add_done_callback(lambda f: rec.setdefault(
            "tokens", None if f.exception() else list(f.result().token_ids)))
        return fut

    service.loop.submit = spy
    try:
        body = {"messages": messages, "max_tokens": new_tokens,
                "temperature": 0}
        s_chat, chat = _http(base + "/v1/chat/completions", body)
        s_stream, first_s, _, _ = _sse(base, "/v1/chat/completions",
                                       dict(body, stream=True))
        gen = {"prompt": text, "temperature": 0.0,
               "max_new_tokens": new_tokens}
        s_off, off = _http(base + "/generate",
                           dict(gen, add_special_tokens=False))
        s_on, on = _http(base + "/generate", gen)
        t0 = time.monotonic()
        while not all("tokens" in r for r in seen) and \
                time.monotonic() - t0 < 10:
            time.sleep(0.01)
    finally:
        del service.loop.submit
    ttft = {"chat": [], "completions": []}
    for _ in range(CHAT_TTFT_REPS):
        for route, path, payload in (
                ("chat", "/v1/chat/completions", body),
                ("completions", "/v1/completions",
                 {"prompt": text, "max_tokens": new_tokens,
                  "temperature": 0})):
            eng.ttft = LatencyCollector()
            status, _ = _http(base + path, payload)
            if status != 200:
                raise AssertionError(f"{what} chat: {path} {status}")
            ttft[route].append(eng.ttft.report()["p50"] * 1e3)
    bos = tok.bos_token_id
    bos_text = tok.special_tokens_map.get("bos_token") or ""
    want_bos = 1 if bos_text and text.startswith(bos_text) else 0
    chat_rec, stream_rec, off_rec = (seen + [{}] * 3)[:3]
    row = {"statuses": [s_chat, s_stream, s_off, s_on],
           "render_ms": min(renders), "render_ms_each": renders,
           "render_chars": len(text), "prompt_tokens": len(want_ids),
           "bos_in_prompt": chat_rec.get("ids", []).count(bos),
           "bos_rendered": want_bos,
           "n_prompt_switch_off_on": [off.get("n_prompt"),
                                      on.get("n_prompt")],
           "chat_tokens": chat_rec.get("tokens"),
           "chat_ttft_ms": ttft["chat"],
           "completions_ttft_ms": ttft["completions"],
           "stream_first_chunk_s": first_s}
    log(f"{what} chat: " + json.dumps(row))
    ids = [r.get("ids") for r in (chat_rec, stream_rec, off_rec)]
    toks = [r.get("tokens") for r in (chat_rec, stream_rec, off_rec)]
    bad = [k for k, ok in (
        ("200", row["statuses"] == [200] * 4),
        ("the prompt ids are the port's render's", len(seen) == 4
         and ids[0] == ids[1] == ids[2] == want_ids),
        ("BOS once, at 0, as rendered", row["bos_in_prompt"] == want_bos
         and (not want_bos or want_ids[0] == bos)),
        ("greedy tokens = /generate without special tokens",
         toks[0] is not None and toks[0] == toks[1] == toks[2]
         and len(toks[0]) == new_tokens),
        ("with special tokens one longer",
         on.get("n_prompt") == off.get("n_prompt", -2) + 1
         == len(want_ids) + 1)) if not ok]
    if bad:
        raise AssertionError(f"{what} chat: failed {bad}")
    return row


def phase_checkpoint(ctx):
    """A seeded Llama-3.2-1B-width checkpoint written here (bf16, tied
    embeddings, two shards, the tokenizer built here), served from its
    directory in bf16 and in int8: tensors as written, /generate and
    /v1/completions answering, greedy tokens equal to an engine built from
    the same state dict. Its ``tokenizer_config.json`` carries
    Meta-Llama-3-8B-Instruct's chat template, and its header tokens are
    special: the bf16 pod runs the chat round (``_chat_round``)."""
    import tempfile

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
        SamplingParams,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        random_params,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_state_dict,
    )

    _drop_engine_model(ctx)
    import dataclasses

    cfg = dataclasses.replace(LlamaConfig.llama32_1b(), max_seq_len=131072,
                              rope_scaling=(32.0, 1.0, 4.0, 8192))
    state = random_params(cfg, seed=9, std=0.02, device="cuda")
    prompts = [CKPT_CORPUS[:60], "Café déjà vu 🚀 " * 3,
               "<|begin_of_text|>numbers 12345 and more"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "llama-3.2-1b-seeded"
        t0 = time.monotonic()
        n_bytes = _write_checkpoint(path, state, cfg,
                                    CKPT_SPECIAL + CHAT_SPECIAL)
        out["write_s"] = time.monotonic() - t0
        conf = json.loads((path / "tokenizer_config.json").read_text())
        conf["chat_template"] = LLAMA3_INSTRUCT_TEMPLATE
        (path / "tokenizer_config.json").write_text(json.dumps(conf))
        out["bytes_on_disk"] = n_bytes
        for quant in (False, True):
            what = "int8" if quant else "bf16"
            service, base, server = _ckpt_boot(ctx, path, quant)
            try:
                eng = service._engine
                want = quantize_state_dict(state) if quant else state
                got = dict(eng.model.state_dict())
                if set(got) != set(want) or not all(
                        torch.equal(got[k], v) for k, v in want.items()):
                    raise AssertionError(f"checkpoint {what}: the loaded "
                                         f"tensors differ from the written")
                sums = sum(float(v.view(torch.uint8).sum(dtype=torch.int64))
                           for v in want.values())
                # the unit, one request at a time (batch 1, as the direct
                # engine below runs them)
                unit_tokens = []
                for p in prompts:
                    status, body = _http(base + "/generate", {
                        "prompt": p, "temperature": 0.0,
                        "max_new_tokens": 16, "logprobs": 1})
                    if status != 200:
                        raise AssertionError(f"checkpoint {what}: /generate "
                                             f"{status} {body}")
                    unit_tokens.append([e["token"] for e in body["logprobs"]])
                status, comp = _http(base + "/v1/completions", {
                    "prompt": prompts[0], "max_tokens": 8, "temperature": 0})
                if status != 200 or not comp.get("choices"):
                    raise AssertionError(f"checkpoint {what}: "
                                         f"/v1/completions {status} {comp}")
                chat = None if quant else _chat_round(
                    ctx, f"checkpoint {what}", base, service, CHAT_TURNS)
                ids = [service._encode(p) for p in prompts]
                service_eos = service.eos_id
                load_s = service.load_seconds
                ecfg = service.ecfg
                text = service._decode(unit_tokens[0])
            finally:
                server.stop()
                service.close()
            del service, eng, got
            gc.collect()
            torch.cuda.empty_cache()
            direct = LLMEngine(cfg, LlamaForCausalLM.from_state_dict(
                cfg, want), ecfg, device="cuda")
            direct.warm_executables()
            eos = service_eos
            direct_tokens = [direct.generate([i], SamplingParams(
                temperature=0.0, max_new_tokens=16, eos_id=eos))[0].token_ids
                for i in ids]
            del direct, want
            gc.collect()
            torch.cuda.empty_cache()
            line = {"load_s": load_s, "load_gb_s": n_bytes / load_s / 1e9,
                    "tensor_checksum": sums, "tensors_equal": True,
                    "prompt_tokens": [len(i) for i in ids],
                    "unit_tokens": unit_tokens,
                    "tokens_equal_direct_engine":
                        unit_tokens == direct_tokens,
                    "first_text": text,
                    "completion": comp["choices"][0].get("text"),
                    "chat": chat}
            out[what] = line
            log(f"checkpoint {what}: " + json.dumps(line))
            if unit_tokens != direct_tokens:
                raise AssertionError(f"checkpoint {what}: the unit's tokens "
                                     f"{unit_tokens} differ from the direct "
                                     f"engine's {direct_tokens}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ctx["checkpoint"] = out


# -- engine_prefix -----------------------------------------------------------

#: engine_prefix's shapes: a 1,024-token shared prefix (64 blocks of 16)
#: with distinct tails, and a pool of PREFIX_BLOCKS blocks (2 MiB each at
#: 8B widths) that holds the first two prompts' runs and one filler, so the
#: second filler evicts (demotes) part of the shared prefix to the host
#: tier and the last prompt restores it. Cached admission reserves the warm
#: start's blocks, the restore's and the remainder's against the pool
#: (64 + the restored + 20 for a 1,300-token prompt), which a smaller pool
#: refuses
PREFIX_SHARED = 1024
#: the device hit's remainder (100) takes the 128-token chunk bucket, a
#: continuation key below the largest bucket; the cold run's last chunk
#: and the restore's take the 512-token one
PREFIX_TAILS = (200, 100, 276)
#: An int8 pool is held otherwise: a block's int8 scale only grows (the
#: reference's requantize), so a freshly allocated decode block starts
#: from the scale its last occupant left, and the numbers depend on which
#: physical blocks a run gets, which caching changes (two runs on the card
#: parted from the cache-off engine 2 tokens after a prompt's decode
#: entered a fresh block, at top-2 gaps of 0.031 and 0.219). The int8 run
#: is scored as engine_ragged's int8 run is (``_score``): its worst logit
#: deficit within ``NOISE_TIES`` x eps of the scoring forward, and as many
#: argmax hits as the cache-off run less ``INT8_SLACK``.
PREFIX_FILLER = 1300
PREFIX_BLOCKS = 160
#: the host tier's capacity: 1 GiB, some 500 blocks at 8B widths
PREFIX_TIER_BYTES = 1 << 30


def _count_calls(eng):
    """Count each eager prefill and continuation call by its key from here
    on (each B1 call is one launch per layer; each ragged continuation
    ``rcont`` one B3 launch per layer); returns the counter dict."""
    calls = {}
    for key, fn in list(eng._prefill.items()):
        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] = calls.get(_key, 0) + 1
            return _fn(*a, **k)
        eng._prefill[key] = counted
    return calls


def _prefix_walk(eng, before, calls):
    """B1's, B2's and B3's exact launch counts since ``before``: the
    layers times each eager prefill and static continuation call (B1),
    times each ragged continuation call (B3), and each graph replay's
    captured launches (B2 or B3; the chunk-only replays of cached
    admission under the fused step included)."""
    L = eng.cfg.n_layers
    out = {"flash_attention": L * sum(n for k, n in calls.items()
                                      if k[0] != "rcont"),
           "paged_decode_attention": 0,
           "ragged_paged_attention": L * sum(n for k, n in calls.items()
                                             if k[0] == "rcont")}
    for g in _graphs(eng):
        n = g.replays - before.get(g.key, 0)
        for name, per in g.launches.items():
            if name in out:
                out[name] += per * n
    return out


def _prefix_prompts(cfg):
    import torch

    gen = torch.Generator().manual_seed(11)

    def draw(n):
        return torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()

    shared = draw(PREFIX_SHARED)
    p0, p1, p2 = (shared + draw(t) for t in PREFIX_TAILS)
    # cold, device hit, the fillers that demote the shared run, restore
    return [("cold", p0), ("device_hit", p1),
            ("filler", draw(PREFIX_FILLER)),
            ("filler_2", draw(PREFIX_FILLER)), ("restore", p2)]


def _prefix_run(ctx, switches, caching: bool):
    """One engine (the engine phase's model) with ``switches``, warmed,
    serving the prefix prompts one after another, every request greedy
    with 2 logprobs. Returns its Finished per prompt, the launch counts,
    the expected walk, and the numbers."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
        SamplingParams,
    )

    cfg, model = _engine_model(ctx)
    ecfg = EngineConfig(max_model_len=2048, max_num_seqs=4, block_size=16,
                        context_encoding_buckets=(128, 512),
                        max_new_tokens=ENGINE_NEW_TOKENS,
                        num_blocks=PREFIX_BLOCKS,
                        enable_prefix_caching=caching)
    env = {"SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "",
           "SHAI_FUSED_STEP": "0", "SHAI_ASYNC_DECODE": "1",
           "SHAI_KVTIER": "1", "SHAI_KVTIER_ASYNC": "1",
           "SHAI_KVTIER_BYTES": str(PREFIX_TIER_BYTES), **switches}
    with _env(env):
        eng = LLMEngine(cfg, model, ecfg, device="cuda")
        n_warm = eng.warm_executables()
        warmed = sorted(str(k) for k in eng._prefill)
        before = _replays(eng)
        calls = _count_calls(eng)
        _reset_counters()
        fins, ttft = [], {}
        for what, p in _prefix_prompts(cfg):
            [f] = eng.generate([p], SamplingParams(
                temperature=0.0, max_new_tokens=ENGINE_NEW_TOKENS,
                logprobs=2))
            if eng.cache.tier is not None:
                # the async copy-outs publish before the next admission
                # probes the tier (the serving layer's prefill pod does so
                # before it answers the handoff)
                eng.cache.tier.drain()
            fins.append(f)
            ttft[what] = (f.timing["t_first"] - f.timing["t_submit"]) * 1e3
        eng.finish_pending()
        torch.cuda.synchronize()
        counts = _read_counters()
    tier = eng.cache.tier.snapshot() if eng.cache.tier is not None else {}
    restore = fins[4].timing
    info = {"async": eng._async, "fused": eng._fused, "warmed": n_warm,
            "warmed_keys": warmed, "recompiles": eng.obs.recompiles,
            "executables": eng.n_executables,
            "calls": {str(k): n for k, n in calls.items()},
            "ttft_ms": ttft, "tier": tier,
            "restore_blocks": restore.get("kv_restore_blocks", 0.0),
            "restore_s": restore.get("kv_restore_s", 0.0),
            "recompute_tokens": [f.timing.get("recompute_tokens")
                                 for f in fins],
            "flushes": eng.obs.flush_reasons(),
            "leaked": eng.cache.leaked_blocks,
            "walk": _prefix_walk(eng, before, calls)}
    return eng, fins, counts, info


def _tier_moves(ctx, eng):
    """Time the tier's moves on the engine left by the last run: a restore
    of up to 64 of the tier's blocks (the host copy, then
    one in-place copy per layer and pool tensor) and the demotion of the
    same blocks (the gathers, the device->host copies and the publish),
    each with the device synchronized around it, with pinned and with
    pageable host staging. Returns GB/s and ms per run."""
    import torch

    cache, tier = eng.cache, eng.cache.tier
    # up to 64 resident blocks, from the tier's advertised runs (a run
    # list needs no chain order: the walk takes every resident hash)
    hashes = [h for adv in tier.advertisement()
              for h in tier.run_hashes(adv["head"])][:64]
    run = tier.get_run(hashes)
    if len(run) < 16:
        raise AssertionError(f"engine_prefix: the tier holds {len(run)} "
                             f"blocks")
    out = {"blocks": len(run), "block_nbytes": tier.block_nbytes}
    blocks = cache._alloc(len(run))
    try:
        for pinned in (True, False):
            cache.pin_host = pinned
            name = "pinned" if pinned else "pageable"
            times_w, times_d = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cache._tier_write(blocks, run)
                torch.cuda.synchronize()
                times_w.append(time.perf_counter() - t0)
                # the demotion of the same blocks, published synchronously
                # (a fresh tier of the same geometry, so nothing is
                # already resident)
                probe = type(tier)(
                    n_layers=tier.n_layers, block_size=tier.block_size,
                    n_kv_heads=tier.n_kv_heads, head_dim=tier.head_dim,
                    dtype=tier.dtype, capacity_bytes=tier.capacity_bytes,
                    async_copy=False, quant=tier.quant)
                saved = cache.tier
                cache.tier = probe
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cache._demote(list(zip(hashes, blocks)))
                times_d.append(time.perf_counter() - t0)
                cache.tier = saved
                # byte-exact both ways: the restored blocks demote to the
                # bytes they were restored from
                for (h, *want), (h2, *got) in zip(run, probe.get_run(hashes)):
                    if h != h2 or any(a.tobytes() != b.tobytes()
                                      for a, b in zip(want, got)):
                        raise AssertionError("engine_prefix: a restored "
                                             "block is not byte-exact")
            nbytes = len(run) * tier.block_nbytes
            out[name] = {
                "restore_ms": min(times_w) * 1e3,
                "restore_gb_s": nbytes / min(times_w) / 1e9,
                "copy_out_ms": min(times_d) * 1e3,
                "copy_out_gb_s": nbytes / min(times_d) / 1e9}
    finally:
        cache.pin_host = True
        cache.allocator.free(blocks)
    return out


def _prefix_case(ctx, what, switches, expect):
    """The prefix prompts with the cache and the tier on, async and
    lock-step, against the same engine with the cache off: tokens equal
    or parting at a top-2 gap under ``TIE_GAP``, async equal to
    lock-step (tokens and logprob entries), the device hit and the restore
    taken, no leaked block, no recompile after warmup, and B1, B2 and B3
    exactly the walk's counts."""
    eng, fins, counts, info = _prefix_run(ctx, switches, True)
    _, sync_fins, sync_counts, sync_info = _prefix_run(
        ctx, {**switches, "SHAI_ASYNC_DECODE": "0"}, True)
    _, off_fins, _, off_info = _prefix_run(ctx, switches, False)
    for name, got, want in (("async", counts, info["walk"]),
                            ("lock-step", sync_counts, sync_info["walk"])):
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if wrong:
            raise AssertionError(f"{what} {name}: launches (got, walk) "
                                 f"{wrong}")
    _check_counters(what, counts, expect)
    if [f.token_ids for f in fins] != [f.token_ids for f in sync_fins] or \
            [f.logprobs for f in fins] != [f.logprobs for f in sync_fins]:
        raise AssertionError(f"{what}: async and lock-step differ")
    int8 = bool(switches.get("SHAI_KV_QUANT"))
    # the partings' gaps (an int8 run's are reported, not held)
    gaps = _tie_diverge(fins, off_fins, float("inf") if int8 else TIE_GAP)
    same = sum(f.token_ids == w.token_ids for f, w in zip(fins, off_fins))
    score = None
    if int8:
        cfg, model = _engine_model(ctx)
        prompts = [p for _, p in _prefix_prompts(cfg)]
        on, off = _score(model, prompts, fins), _score(model, prompts,
                                                       off_fins)
        score = {"hits": on["b1"][0], "off_hits": off["b1"][0],
                 "tokens": on["tokens"], "worst": on["b1"][1],
                 "eps": on["eps"]}
        if on["b1"][1] > NOISE_TIES * on["eps"] or \
                on["b1"][0] < off["b1"][0] - INT8_SLACK * on["tokens"]:
            raise AssertionError(f"{what}: the int8 run against the scoring "
                                 f"forward {score}")
    moves = _tier_moves(ctx, eng)
    line = {"switches": switches, "equal_streams": same,
            "streams": len(fins), "tie_gaps": gaps, "int8_score": score,
            "launches": counts,
            "async": info, "lock_step": {k: sync_info[k] for k in (
                "async", "calls", "ttft_ms", "recompiles", "leaked")},
            "cache_off": {k: off_info[k] for k in (
                "calls", "ttft_ms", "warmed", "leaked")},
            "tier_moves": moves}
    log(f"{what}: " + json.dumps(line))
    for i in (info, sync_info, off_info):
        if i["leaked"] or i["recompiles"] or \
                i["executables"] != i["warmed"]:
            raise AssertionError(f"{what}: leaked {i['leaked']}, recompiles "
                                 f"{i['recompiles']}, executables "
                                 f"{i['executables']} of {i['warmed']}")
    restored = info["tier"].get("restored", 0)
    hit = info["recompute_tokens"][1]
    if not restored or not info["restore_blocks"] or \
            hit != PREFIX_TAILS[1]:
        raise AssertionError(f"{what}: restored {restored} blocks (the "
                             f"restore admission {info['restore_blocks']}), "
                             f"device hit recomputed {hit} tokens")
    del eng
    ctx.setdefault("engine_prefix", {})[what] = line
    launches = ctx.setdefault("launches", {}).setdefault(
        "engine_prefix", {k: 0 for k in _counters()})
    for k, n in counts.items():
        launches[k] += n


def phase_engine_prefix(ctx):
    # (a) bucketed bf16: cached continuations ("cont", 64, 512) through B1
    # over the shared and restored blocks, decode through B2
    _prefix_case(ctx, "engine_prefix (a)", {},
                 {"flash_attention", "paged_decode_attention"})
    # (b) ragged int8: the cached continuation through B3 ("rcont", 512),
    # restored int8 blocks and their scale rows
    _prefix_case(ctx, "engine_prefix (b)", {"SHAI_RAGGED_ATTENTION": "1",
                                            "SHAI_KV_QUANT": "int8"},
                 {"flash_attention", "ragged_paged_attention"})
    # (c) fused bf16: cached admission through the chunk-only graph
    _prefix_case(ctx, "engine_prefix (c)", {"SHAI_RAGGED_ATTENTION": "1",
                                            "SHAI_FUSED_STEP": "1"},
                 {"flash_attention", "ragged_paged_attention"})
    _drop_engine_model(ctx)


# -- serve_disagg ------------------------------------------------------------

#: the pods' engine ConfigMap (each adds its role): prefix caching on, the
#: engine phase's shapes
DISAGG_CONFIG = {"max_model_len": 2048, "block_size": 16, "max_num_seqs": 4,
                 "context_encoding_buckets": [128, 512],
                 "max_new_tokens": 16, "enable_prefix_caching": True}


def _disagg_pod(tmp, path, role, config=None, env=None, name=None):
    """One unit on ``MODEL_ID=<path>`` with the given role, behind the
    stdlib server; returns (service, base url, server). ``config`` replaces
    ``DISAGG_CONFIG``, ``env`` adds to (or overrides) the pod's
    environment while it is built, ``name`` names its ConfigMap file."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
        VllmService,
    )
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    conf = tmp / f"{name or role}.yaml"
    conf.write_text(json.dumps({**(config or DISAGG_CONFIG), "role": role}))
    env = {"DEVICE": "cuda", "MODEL_ID": str(path), "PORT": "0",
           "VLLM_CONFIG": str(conf), "SHAI_KVTIER": "1",
           "SHAI_KVTIER_ASYNC": "1", "SHAI_RAGGED_ATTENTION": "0",
           "SHAI_KV_QUANT": "", "SHAI_FUSED_STEP": "0",
           "SHAI_ASYNC_DECODE": "1", "QUANTIZATION": "",
           "SHAI_KVFABRIC": "", "SHAI_KVFABRIC_PEERS": "",
           **(env or {})}
    with _env(env):
        cfg = ServeConfig.from_env()
        service = VllmService(cfg)
        server = Server(create_app(cfg, service), host="127.0.0.1", port=0)
        host, port = server.start_background()
        base = f"http://{host}:{port}"
        t0 = time.monotonic()
        while _http(base + "/readiness")[0] != 200:
            if time.monotonic() - t0 > 600 or \
                    _http(base + "/readiness")[0] == 500:
                raise AssertionError(f"serve_disagg {role}: not ready "
                                     f"{_http(base + '/readiness')}")
            time.sleep(0.2)
    return service, base, server


def _disagg_request(ctx, pods, prompt, pulls):
    """One request the disaggregated way: the prefill pod's handoff, then
    the decode pod with ``kv_peer``; and the monolithic pod. Returns the
    handoff, both answers and the seconds of each leg."""
    t0 = time.monotonic()
    status, handoff = _http(pods["prefill"][1] + "/generate",
                            {"prompt": prompt, "temperature": 0.0})
    t_pre = time.monotonic() - t0
    if status != 200 or not handoff.get("kv_ready"):
        raise AssertionError(f"serve_disagg: handoff {status} {handoff}")
    n_pull = len(pulls)
    t0 = time.monotonic()
    status, dec = _http(pods["decode"][1] + "/generate", {
        "prompt": prompt, "temperature": 0.0, "max_new_tokens": 16,
        "logprobs": 1, "kv_peer": pods["prefill"][1],
        "kv_hashes_len": handoff["hashes_len"],
        "kv_digest": handoff["digest"]})
    t_dec = time.monotonic() - t0
    if status != 200 or len(pulls) != n_pull + 1:
        raise AssertionError(f"serve_disagg: decode {status} {dec}; pulls "
                             f"{pulls}")
    status, mono = _http(pods["both"][1] + "/generate", {
        "prompt": prompt, "temperature": 0.0, "max_new_tokens": 16,
        "logprobs": 2})
    if status != 200:
        raise AssertionError(f"serve_disagg: monolithic {status} {mono}")
    return handoff, dec, mono, t_pre, t_dec


def phase_serve_disagg(ctx):
    """A prefill-role pod and a decode-role pod (and a monolithic pod) on
    one seeded Llama-3.2-1B-width checkpoint directory, written by the
    checkpoint phase's writer, in this process over localhost: the decode
    pod pulls each handoff's run over ``GET /kv/blocks`` and its greedy
    tokens equal the monolithic pod's; the frames equal the banked blocks
    byte for byte; an injected ``kvnet.fetch`` fault degrades to
    recompute with the request still answering 200."""
    import tempfile

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.kvnet import frames
    from scalable_hw_agnostic_inference_tpu_torch.kvnet.client import (
        KvNetClient,
        KvNetStats,
    )
    from scalable_hw_agnostic_inference_tpu_torch.resilience import (
        faults as rz_faults,
    )

    _drop_engine_model(ctx)
    path = _seeded_1b_dir(ctx)
    # some 1,300 tokens: the decode pod's warm start 1,024 leaves a
    # remainder past 128, so its continuation is the monolithic pod's last
    # chunk's ("cont", 64, 512) and the tokens are the same computation
    text = (CKPT_CORPUS + " ") * 26
    prompts = [f"disaggregated request {i}: " + text for i in range(3)]
    out = {}
    pods = {}
    pulls = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            for role in ("prefill", "decode", "both"):
                pods[role] = _disagg_pod(tmp, path, role)
            pre, dec = pods["prefill"][0], pods["decode"][0]
            if (pre.role, dec.role, pods["both"][0].role) != (
                    "prefill", "decode", "both"):
                raise AssertionError("serve_disagg: pod roles")
            inner = dec._pull_handoff

            def timed_pull(*a, **k):
                t0 = time.monotonic()
                n = inner(*a, **k)
                pulls.append((n, time.monotonic() - t0))
                return n

            dec._pull_handoff = timed_pull
            _reset_counters()
            rows = []
            for i, prompt in enumerate(prompts[:2]):
                handoff, got, mono, t_pre, t_dec = _disagg_request(
                    ctx, pods, prompt, pulls)
                toks = [e["token"] for e in got["logprobs"]]
                want = [e["token"] for e in mono["logprobs"]]
                n_pull, s_pull = pulls[-1]
                hashes = dec._engine.cache.prefix_hashes(
                    dec._encode(prompt))[:handoff["hashes_len"]]
                # the decode pod's TTFT: its engine's queue-to-first-token
                # of this request, after the pull
                ttft = dec._engine.ttft._samples[-1]
                banked = pre._engine.cache.tier.get_run(hashes)
                pulled = dec._engine.cache.tier.get_run(hashes)
                rows.append({
                    "prompt_tokens": got["n_prompt"],
                    "hashes_len": handoff["hashes_len"],
                    "banked": len(banked), "pulled_blocks": n_pull,
                    "tokens_equal_monolithic": toks == want,
                    "prefill_s": t_pre, "decode_request_s": t_dec,
                    "pull_s": s_pull, "decode_ttft_s": ttft,
                    # the handoff's share of the disaggregated TTFT: the
                    # prefill leg, the pull, the decode pod's first token
                    "pull_share_of_ttft": s_pull / (t_pre + s_pull + ttft)})
                if toks != want:
                    i = next(j for j, (a, b) in enumerate(zip(toks, want))
                             if a != b)
                    top = mono["logprobs"][i]["top_logprobs"]
                    raise AssertionError(
                        f"serve_disagg: decode pod tokens {toks} != "
                        f"monolithic {want} (parting at {i}, the "
                        f"monolithic top-2 gap {top[0] - top[1]:.4f}; "
                        f"prompt {got['n_prompt']} tokens)")
                if n_pull != handoff["hashes_len"] or len(banked) != n_pull \
                        or len(pulled) != n_pull:
                    raise AssertionError(f"serve_disagg: banked "
                                         f"{len(banked)}, pulled {n_pull}, "
                                         f"resident {len(pulled)} of "
                                         f"{handoff['hashes_len']}")
                for (h, *a), (h2, *b) in zip(banked, pulled):
                    if h != h2 or frames.wire_name(a[0].dtype) != \
                            "bfloat16" or any(x.tobytes() != y.tobytes()
                                              for x, y in zip(a, b)):
                        raise AssertionError("serve_disagg: a pulled block "
                                             "is not the banked block")
            # the wire itself: one GET's frames against the banked blocks
            wire = frames.decode_frames(urllib.request.urlopen(
                pods["prefill"][1] + "/kv/blocks?hashes="
                + ",".join(map(str, hashes[:64])), timeout=120).read())
            if [e[0] for e in wire] != [e[0] for e in banked[:64]] or any(
                    x.tobytes() != y.tobytes() for w, b in zip(wire, banked)
                    for x, y in zip(w[1:], b[1:])):
                raise AssertionError("serve_disagg: /kv/blocks frames differ "
                                     "from the banked blocks")
            # pull rate over localhost: a fresh tier of the decode pod's
            # geometry pulls the whole run
            t = dec._engine.cache.tier
            probe = type(t)(n_layers=t.n_layers, block_size=t.block_size,
                            n_kv_heads=t.n_kv_heads, head_dim=t.head_dim,
                            dtype=t.dtype, capacity_bytes=t.capacity_bytes,
                            async_copy=False, quant=t.quant)
            client = KvNetClient(probe, KvNetStats())
            t0 = time.monotonic()
            n = client.fetch_run(pods["prefill"][1], hashes)
            s = time.monotonic() - t0
            rate = {"blocks": n, "bytes": client.stats.snapshot()["bytes"],
                    "seconds": s,
                    "gb_s": client.stats.snapshot()["bytes"] / s / 1e9}
            # an injected transport fault: recompute, still a 200
            before = dec.kvnet_stats().snapshot()
            rz_faults.configure("kvnet.fetch=error", 0)
            try:
                handoff, got, mono, _, _ = _disagg_request(
                    ctx, pods, prompts[2], pulls)
            finally:
                rz_faults.reset()
            after = dec.kvnet_stats().snapshot()
            # (the run's leading blocks the two prompts share are resident
            # already; nothing crosses the wire)
            fault = {"resident": pulls[-1][0],
                     "fetched": after["fetched"] - before["fetched"],
                     "fallbacks": after["fallbacks"] - before["fallbacks"],
                     "tokens_equal_monolithic":
                         [e["token"] for e in got["logprobs"]]
                         == [e["token"] for e in mono["logprobs"]]}
            if fault["fetched"] or fault["fallbacks"] != 1 or \
                    not fault["tokens_equal_monolithic"]:
                raise AssertionError(f"serve_disagg: the fetch fault {fault}")
            stats = {r: _http(b + "/stats")[1].get("kvnet")
                     for r, (_, b, _) in pods.items()}
            metrics = _http(pods["decode"][1] + "/metrics", raw=True)[1]
            fams = sorted({ln.split("{")[0] for ln in metrics.splitlines()
                           if ln.startswith(("shai_kvnet_", "shai_kvtier_"))})
            counts = _read_counters()
            for role, (svc, _, _) in pods.items():
                eng = svc._engine
                if eng.cache.leaked_blocks or eng.obs.recompiles:
                    raise AssertionError(f"serve_disagg {role}: leaked "
                                         f"{eng.cache.leaked_blocks}, "
                                         f"recompiles {eng.obs.recompiles}")
            out = {"requests": rows, "pull_rate": rate, "fault": fault,
                   "kvnet": stats, "families": fams, "launches": counts}
            log("serve_disagg: " + json.dumps(out))
            ctx.setdefault("launches", {})["serve_disagg"] = counts
            if len(fams) != 18:
                raise AssertionError(f"serve_disagg: /metrics families "
                                     f"{fams}")
        finally:
            for svc, _, server in pods.values():
                server.stop()
                svc.close()
            pods.clear()
            gc.collect()
            torch.cuda.empty_cache()
    ctx["serve_disagg"] = out


# -- serve_fleet -------------------------------------------------------------

#: the fleet pods' engine ConfigMap: serve_disagg's shapes with room for
#: FLEET_NEW_TOKENS after a 1,250-token prompt
FLEET_CONFIG = {**DISAGG_CONFIG, "max_new_tokens": 512}
#: greedy tokens each migrated request asks for: more than the drain's
#: natural-completion window (FLEET_DRAIN_S less the reserve) can finish
FLEET_NEW_TOKENS = 256
#: requests in flight on the draining pod, and the tokens each has before
#: the drain begins
FLEET_REQUESTS = 4
FLEET_CUT_AFTER = 32
#: the draining pod's budget; the migrate reserve is half of it, so the
#: migrate phase starts 0.5 s after the drain
FLEET_DRAIN_S = 1.0


class _Fin:
    """A Finished-like view of a served answer with logprob entries (the
    tie rule's input)."""

    def __init__(self, out):
        self.logprobs = out["logprobs"]
        self.token_ids = [e["token"] for e in self.logprobs]


def _fleet_capture(svc):
    """Wrap a pod's ``loop.submit`` so each resumed request's engine
    ``Finished`` is kept by its resume handle (the unit's
    ``_resume_migrated`` submits on the calling thread) and every other
    one in order; returns ``(by_handle, plain)``."""
    tl = threading.local()
    by_handle, plain = {}, []
    submit, resume = svc.loop.submit, svc._resume_migrated

    def wrapped_submit(*a, **k):
        fut = submit(*a, **k)
        h = getattr(tl, "h", None)
        if h is None:
            plain.append(fut)
        else:
            by_handle[h] = fut
        return fut

    def wrapped_resume(rid):
        tl.h = rid
        try:
            return resume(rid)
        finally:
            tl.h = None

    svc.loop.submit = wrapped_submit
    svc._resume_migrated = wrapped_resume
    return by_handle, plain


def _fleet_ship_probe(svc):
    """Wrap a draining pod's ship: each POST's envelope bytes and seconds,
    and each handoff's cut instant by its resume handle."""
    posts, cuts = [], {}
    post, handoff = svc._kvnet._post_envelope, svc._migrated_handoff

    def wrapped_post(peer, payload):
        t0 = time.monotonic()
        out = post(peer, payload)
        posts.append({"bytes": len(payload),
                      "seconds": time.monotonic() - t0, "state": out[0]})
        return out

    def wrapped_handoff(fin):
        rec = handoff(fin)
        cuts[rec.get("resume") or f"cold-{fin.req_id}"] = (
            fin.timing["t_migrate_cut"], rec)
        return rec

    svc._kvnet._post_envelope = wrapped_post
    svc._migrated_handoff = wrapped_handoff
    return posts, cuts


def _fleet_accepts(svc):
    """Wrap a receiving pod's ``accept_migration``: seconds of each accept
    (decode checked, the run published into the tier)."""
    accepts = []
    accept = svc.accept_migration

    def wrapped(manifest, entries):
        t0 = time.monotonic()
        out = accept(manifest, entries)
        accepts.append({"seconds": time.monotonic() - t0,
                        "blocks": len(entries),
                        "restored": out["restored"]})
        return out

    svc.accept_migration = wrapped
    return accepts


def _fleet_drain(pods, src, dst, prompts, faults=""):
    """Drive ``prompts`` on pod ``src`` until each has FLEET_CUT_AFTER
    tokens, begin its drain (its migrate phase ships to ``dst``), replay
    every resume handle on ``dst`` at once, and replay a handoff without
    one (the cold rung) as the original request on ``dst``. Returns the
    handoffs, the answers in prompt order, the cut instants, the posts and
    the resumed requests' engine Finished by handle."""
    from scalable_hw_agnostic_inference_tpu_torch.resilience import (
        faults as rz_faults,
    )

    svc, base, _ = pods[src]
    eng = svc._engine
    posts, cuts = _fleet_ship_probe(svc)
    by_handle, _ = _fleet_capture(pods[dst][0])
    handoffs = [None] * len(prompts)

    def one(i):
        handoffs[i] = _http(base + "/generate", {
            "prompt": prompts[i], "temperature": 0.0,
            "max_new_tokens": FLEET_NEW_TOKENS, "logprobs": 1})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    while True:
        running = [s for s in eng.slots if s is not None
                   and s.prefill_cursor is None]
        if len(running) == len(prompts) and all(
                len(s.generated) >= FLEET_CUT_AFTER for s in running):
            break
        if time.monotonic() - t0 > 120:
            raise AssertionError(f"serve_fleet: {src} never reached "
                                 f"{FLEET_CUT_AFTER} tokens a request")
        time.sleep(0.002)
    if faults:
        rz_faults.configure(faults, 0)
    try:
        if not svc.wants_migration() or \
                not pods[src][2].app.state["begin_drain"]():
            raise AssertionError(f"serve_fleet: {src} did not drain armed")
        for t in threads:
            t.join(timeout=300)
    finally:
        rz_faults.reset()
    answers = [None] * len(prompts)

    def replay(i):
        st, rec = handoffs[i]
        if st != 200 or not rec.get("migrated"):
            raise AssertionError(f"serve_fleet: {src} answered {st} {rec}")
        payload = ({"resume": rec["resume"]} if rec["resume"] else {
            "prompt": prompts[i], "temperature": 0.0,
            "max_new_tokens": FLEET_NEW_TOKENS, "logprobs": 1})
        answers[i] = _http(pods[dst][1] + "/generate", payload)

    rt = [threading.Thread(target=replay, args=(i,))
          for i in range(len(prompts))]
    for t in rt:
        t.start()
    for t in rt:
        t.join(timeout=300)
    return [h for _, h in handoffs], answers, cuts, posts, by_handle


def _fleet_check(what, svc, prompts, answers, wants, int8):
    """Every answer a 200 with the whole output (the tokens before the cut
    included), held against the unmigrated pod's answers ``wants`` by the
    engine phases' rules: a resumed request recomputes part of its run by
    a continuation where the unmigrated one decoded it, so its tokens part
    from the unmigrated ones at near-ties of this random-weight model's
    flat logits. bf16: every greedy token within ``TIE_TOL`` of the
    scoring forward's maximum (through B1's plain version); int8 KV: within
    ``NOISE_TIES`` eps of it through B1, and as many argmax hits as the
    unmigrated int8 run less ``INT8_SLACK``. Returns the streams equal to
    the unmigrated ones, the gaps where the others part, and the
    scores."""
    for i, (st, out) in enumerate(answers):
        if st != 200 or out.get("stop_reason") not in ("length", "eos") \
                or len(out.get("logprobs") or ()) != out["n_tokens"]:
            raise AssertionError(f"serve_fleet {what}: answer {i} {st} "
                                 f"{out.get('stop_reason')} "
                                 f"{out.get('detail')}")
    fins = [_Fin(out) for _, out in answers]
    want = [_Fin(w) for w in wants]
    model = svc._engine.model
    ids = [svc._encode(p) for p in prompts]
    on = _score(model, ids, fins)
    score = {"tokens": on["tokens"], "worst_plain": on["plain"][1],
             "worst_b1": on["b1"][1], "hits": on["b1"][0], "eps": on["eps"]}
    if int8:
        off = _score(model, ids, want)
        score["unmigrated_hits"] = off["b1"][0]
        ok = (on["b1"][1] <= NOISE_TIES * on["eps"] and on["b1"][0]
              >= off["b1"][0] - INT8_SLACK * on["tokens"])
    else:
        ok = on["plain"][1] <= TIE_TOL
    if not ok:
        raise AssertionError(f"serve_fleet {what}: against the scoring "
                             f"forward {score}")
    return {"equal_streams": sum(f.token_ids == w.token_ids
                                 for f, w in zip(fins, want)),
            "streams": len(fins),
            "parting_gaps": _tie_diverge(fins, want, float("inf")),
            "score": score}


def _fleet_unmigrated(pods, name, prompts):
    """``prompts`` answered on pod ``name`` with no migration (logprobs 2,
    FLEET_NEW_TOKENS): the answers, and each one's TTFT from its engine's
    timing."""
    _, plain = _fleet_capture(pods[name][0])
    wants = [None] * len(prompts)

    def one(i):
        wants[i] = _http(pods[name][1] + "/generate", {
            "prompt": prompts[i], "temperature": 0.0,
            "max_new_tokens": FLEET_NEW_TOKENS, "logprobs": 2})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(st != 200 for st, _ in wants):
        raise AssertionError(f"serve_fleet: unmigrated answers "
                             f"{[st for st, _ in wants]}")
    ttft = [f.result(timeout=60).timing for f in plain]
    return [w for _, w in wants], [t["t_first"] - t["t_submit"]
                                   for t in ttft]


def _fleet_migration(ctx, pods, src, dst, prompts, wants, faults="",
                     int8=False):
    """One drain of pod ``src`` into ``dst``, held against the unmigrated
    answers ``wants``; returns the numbers of the run."""
    dsvc = pods[dst][0]
    accepts = _fleet_accepts(dsvc)
    before = _http(pods[dst][1] + "/stats")[1]["migrate"]
    handoffs, answers, cuts, posts, by_handle = _fleet_drain(
        pods, src, dst, prompts, faults)
    held = _fleet_check(src, dsvc, prompts, answers, wants, int8)
    mine = _http(pods[src][1] + "/stats")[1]["migrate"]
    theirs = _http(pods[dst][1] + "/stats")[1]["migrate"]
    resumed = []
    for h, fut in by_handle.items():
        fin = fut.result(timeout=60)
        t_cut, rec = cuts[h]
        tm = fin.timing
        resumed.append({
            "restored_blocks": rec["restored"],
            "kv_restore_s": tm.get("kv_restore_s"),
            "kv_restore_blocks": tm.get("kv_restore_blocks"),
            "recompute_tokens": tm.get("recompute_tokens"),
            "cut_to_next_token_s": tm["t_first"] - t_cut,
            "prompt_tokens": fin.n_prompt})
    for name in (src, dst):
        eng = pods[name][0]._engine
        if eng.cache.leaked_blocks or eng.obs.recompiles:
            raise AssertionError(f"serve_fleet {name}: leaked "
                                 f"{eng.cache.leaked_blocks}, recompiles "
                                 f"{eng.obs.recompiles}")
    ok_posts = [p for p in posts if p["state"] == "ok"]
    return {
        "handoffs": [{k: h[k] for k in ("restored", "n_sent", "peer")}
                     | {"resume": bool(h["resume"])} for h in handoffs],
        "tokens": held,
        "envelope_bytes": [p["bytes"] for p in ok_posts],
        "ship_s": [p["seconds"] for p in ok_posts],
        "ship_gb_s": [p["bytes"] / p["seconds"] / 1e9 for p in ok_posts],
        "accept_s": [a["seconds"] for a in accepts],
        "resumed": resumed,
        "drained": pods[src][2].app.state["status"].get("drained"),
        "src_migrate": mine,
        "dst_migrate": {k: theirs[k] - before[k] for k in theirs}}


def _fleet_fabric(ctx, pods, prompts):
    """Pod C's fabric against holder A and the fabric-off pod M: a warm
    admission pulled from A, a holder slice without the run, an injected
    probe fault; the step gap of C's running decode while the probe ran."""
    from scalable_hw_agnostic_inference_tpu_torch.resilience import (
        faults as rz_faults,
    )

    csvc, cbase, _ = pods["C"]
    abase, mbase = pods["A"][1], pods["M"][1]
    ceng = csvc._engine
    _, cplain = _fleet_capture(csvc)
    _, mplain = _fleet_capture(pods["M"][0])
    steps, probing = [], {"on": False}
    step, probe = ceng.step, ceng._fabric_probe

    def wrapped_probe(*a, **k):
        probing["on"] = True
        return probe(*a, **k)

    def wrapped_step():
        running = ceng.n_running
        t0 = time.monotonic()
        out = step()
        steps.append((time.monotonic() - t0, running, probing["on"]))
        probing["on"] = False
        return out

    ceng._fabric_probe, ceng.step = wrapped_probe, wrapped_step
    for p in prompts[::2]:               # A banks the warm and fault runs
        st, handoff = _http(abase + "/generate", {"prompt": p,
                                                  "temperature": 0.0})
        if st != 200 or not handoff.get("kv_ready"):
            raise AssertionError(f"serve_fleet: holder {st} {handoff}")
    time.sleep(1.1)                       # past C's directory TTL
    # a decode runs on C while the warm request's probe runs
    bg = {}
    t = threading.Thread(target=lambda: bg.setdefault("r", _http(
        cbase + "/generate", {"prompt": "a decode beside the probe: "
                              + prompts[0][:300], "temperature": 0.0,
                              "max_new_tokens": FLEET_NEW_TOKENS})))
    t.start()
    t0 = time.monotonic()
    while ceng.n_running == 0 and "r" not in bg:
        if time.monotonic() - t0 > 120:
            raise AssertionError("serve_fleet: C's decode never started")
        time.sleep(0.002)
    time.sleep(0.05)
    fab_before = _http(cbase + "/stats")[1]["kvfabric"]
    net0 = csvc.kvnet_stats().snapshot()
    n_fa = _read_counters()["flash_attention"]
    st, warm = _http(cbase + "/generate", {
        "prompt": prompts[0], "temperature": 0.0, "max_new_tokens": 16,
        "logprobs": 1})
    fa_warm = _read_counters()["flash_attention"] - n_fa
    net1 = csvc.kvnet_stats().snapshot()
    t.join(timeout=300)
    if st != 200 or bg["r"][0] != 200:
        raise AssertionError(f"serve_fleet: C answered {st} {warm}")
    warm_fin = cplain[-1].result(timeout=60)
    stats = _http(cbase + "/stats")[1]
    fab0 = dict(stats["kvfabric"])
    # a holder slice naming a pod without the run: a stale miss
    st, miss = _http(cbase + "/generate", {
        "prompt": prompts[1], "temperature": 0.0, "max_new_tokens": 16,
        "logprobs": 1, "kv_holders": [mbase]})
    fab1 = _http(cbase + "/stats")[1]["kvfabric"]
    # an injected probe fault: recompute, still a 200
    time.sleep(1.1)
    rz_faults.configure("kvfabric.probe=error", 0)
    try:
        st_f, fault = _http(cbase + "/generate", {
            "prompt": prompts[2], "temperature": 0.0, "max_new_tokens": 16,
            "logprobs": 1})
    finally:
        rz_faults.reset()
    fab2 = _http(cbase + "/stats")[1]["kvfabric"]
    wants = []
    for p in prompts:
        s, w = _http(mbase + "/generate", {"prompt": p, "temperature": 0.0,
                                           "max_new_tokens": 16,
                                           "logprobs": 2})
        wants.append(w)
    mono_fin = mplain[-3].result(timeout=60)
    gaps = _tie_diverge([_Fin(warm), _Fin(miss), _Fin(fault)],
                        [_Fin(w) for w in wants])
    probe_steps = [d for d, r, pr in steps if pr and r]
    decode_steps = [d for d, r, pr in steps if not pr and r]
    tm = warm_fin.timing
    blocks = tm.get("fabric_blocks", 0.0)
    moved = net1["bytes"] - net0["bytes"]
    out = {
        "fabric_probe_s": tm.get("fabric_probe_s"),
        "fabric_blocks": blocks, "fabric_bytes": moved,
        "fabric_gb_s": moved / tm["fabric_probe_s"] / 1e9
        if tm.get("fabric_probe_s") else None,
        "kv_restore_s": tm.get("kv_restore_s"),
        "recompute_tokens": tm.get("recompute_tokens"),
        "ttft_fabric_s": tm["t_first"] - tm["t_submit"],
        "ttft_fabric_off_s": mono_fin.timing["t_first"]
        - mono_fin.timing["t_submit"],
        "b1_launches_warm": fa_warm,
        "probe_step_s": probe_steps,
        "decode_step_median_s": statistics.median(decode_steps)
        if decode_steps else None,
        "tie_gaps": gaps, "kvfabric": [fab_before, fab0, fab1, fab2],
        "fault_status": st_f}
    if fab0["remote_hits"] != fab_before["remote_hits"] + 1 or blocks < 1 \
            or not tm.get("kv_restore_s"):
        raise AssertionError(f"serve_fleet: no fabric hit {out}")
    if fab1["stale_holders"] != fab0["stale_holders"] + 1 or \
            fab1["remote_misses"] != fab0["remote_misses"] + 1:
        raise AssertionError(f"serve_fleet: the stale miss {fab0} {fab1}")
    if st_f != 200 or fab2["remote_misses"] != fab1["remote_misses"] + 1 \
            or fab2["remote_hits"] != fab1["remote_hits"]:
        raise AssertionError(f"serve_fleet: the probe fault {st_f} {fab2}")
    if not fa_warm or not probe_steps:
        raise AssertionError(f"serve_fleet: the warm continuation ran no "
                             f"B1 ({fa_warm}) or no probe beside a decode "
                             f"({probe_steps})")
    return out


def phase_serve_fleet(ctx):
    """The fleet KV fabric and live migration on serve_disagg's seeded
    Llama-3.2-1B-width directory, every pod in this process over
    localhost with the prefix cache and the tier. (a) A prefill pod A
    banks 1,250-token runs; pod C (``SHAI_KVFABRIC_PEERS=A``) admits the
    same prompt warm from A through B1 while a decode runs, a holder slice
    naming M (without the run) recomputes (a counted stale miss), and an
    injected ``kvfabric.probe`` fault recomputes with a 200, all with the
    tokens of the fabric-off pod M. (b) Pod D (``SHAI_MIGRATE_PEER_URL``
    naming C) drains with FLEET_REQUESTS requests FLEET_CUT_AFTER tokens
    in: every request answers as a ``migrated`` handoff, replaying its
    handle on C returns the whole output, held by ``_fleet_check`` beside
    M's unmigrated answers; shipped, received and resumed each
    FLEET_REQUESTS, no leaked block. Then M drains two fresh prompts (which
    it first answers unmigrated) into C under one
    ``migrate.ship`` fault (the cold replay) and one
    ``migrate.restore`` fault (a recompute on C). Bucketed bf16 (B1, B2);
    then ragged with ``SHAI_KV_QUANT=int8`` (B3): pod Dq answers the
    prompts unmigrated, then drains them into Bq."""
    import tempfile

    import torch

    _drop_engine_model(ctx)
    path = _seeded_1b_dir(ctx)
    text = (CKPT_CORPUS + " ") * 26
    pods = {}
    out = {}
    quant = {"SHAI_RAGGED_ATTENTION": "1", "SHAI_KV_QUANT": "int8"}
    # a draining pod's budget; its ship has no connect retry, so that one
    # injected migrate.ship fault is one failed ship
    drains = {"DRAIN_BUDGET_S": str(FLEET_DRAIN_S),
              "SHAI_KVNET_RETRIES": "0"}

    def boot(tmp, path, name, role="both", **env):
        pods[name] = _disagg_pod(tmp, path, role, config=FLEET_CONFIG,
                                 env=env, name=name)

    def stop(*names):
        for n in names:
            svc, _, server = pods.pop(n)
            server.stop()
            svc.close()
        gc.collect()
        torch.cuda.empty_cache()

    def migrate(src, dst, prompts, wants, **kw):
        with _env({"SHAI_MIGRATE_PEER_URL": pods[dst][1],
                   "SHAI_MIGRATE_RESERVE_S": str(FLEET_DRAIN_S)}):
            return _fleet_migration(ctx, pods, src, dst, prompts, wants,
                                    **kw)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            boot(tmp, path, "A", role="prefill")
            boot(tmp, path, "M", **drains)
            boot(tmp, path, "C", SHAI_KVFABRIC_PEERS=pods["A"][1],
                 SHAI_KVFABRIC_TTL_S="1")
            boot(tmp, path, "D", **drains)
            # every kernel count from here on is the fleet's main path
            _reset_counters()
            out["fabric"] = _fleet_fabric(ctx, pods, [
                f"fleet fabric {i}: " + text for i in range(3)])
            log("serve_fleet fabric: " + json.dumps(out["fabric"]))
            prompts = [f"fleet migration {i}: " + text
                       for i in range(FLEET_REQUESTS)]
            wants, ttft = _fleet_unmigrated(pods, "M", prompts)
            b2 = _read_counters()["paged_decode_attention"]
            out["bf16"] = migrate("D", "C", prompts, wants)
            out["bf16"]["b2_launches"] = \
                _read_counters()["paged_decode_attention"] - b2
            out["bf16"]["unmigrated_ttft_s"] = ttft
            log("serve_fleet migration bf16: " + json.dumps(out["bf16"]))
            # fresh prompts: C holds nothing of them, so the refused
            # restore is a recompute
            prompts = [f"fleet fault {i}: " + text for i in range(2)]
            wants, _ = _fleet_unmigrated(pods, "M", prompts)
            out["faults"] = migrate(
                "M", "C", prompts, wants,
                faults="migrate.ship=error#1,migrate.restore=error#1")
            log("serve_fleet migration faults: "
                + json.dumps(out["faults"]))
            stop("A", "C", "D", "M")
            boot(tmp, path, "Dq", **quant, **drains)
            boot(tmp, path, "Bq", **quant)
            prompts = [f"fleet int8 migration {i}: " + text
                       for i in range(FLEET_REQUESTS)]
            wants, ttft = _fleet_unmigrated(pods, "Dq", prompts)
            b3 = _read_counters()["ragged_paged_attention"]
            out["int8"] = migrate("Dq", "Bq", prompts, wants, int8=True)
            out["int8"]["b3_launches"] = \
                _read_counters()["ragged_paged_attention"] - b3
            out["int8"]["unmigrated_ttft_s"] = ttft
            log("serve_fleet migration int8: " + json.dumps(out["int8"]))
            counts = _read_counters()
        finally:
            for name in list(pods):
                stop(name)
    for run in ("bf16", "int8"):
        r = out[run]
        want = {"shipped": FLEET_REQUESTS, "received": FLEET_REQUESTS,
                "resumed": FLEET_REQUESTS}
        got = {"shipped": r["src_migrate"]["shipped"],
               "received": r["dst_migrate"]["received"],
               "resumed": r["dst_migrate"]["resumed"]}
        if got != want or not all(h["resume"] and h["restored"]
                                  for h in r["handoffs"]):
            raise AssertionError(f"serve_fleet {run}: counts {got}, "
                                 f"handoffs {r['handoffs']}")
    f = out["faults"]
    if sorted(h["resume"] for h in f["handoffs"]) != [False, True] or \
            f["src_migrate"]["failed"] != 1 or \
            f["dst_migrate"]["fallbacks"] != 1 or \
            f["dst_migrate"]["resumed"] != 1 or \
            [r["restored_blocks"] for r in f["resumed"]] != [0]:
        raise AssertionError(f"serve_fleet: the fault ladder {f}")
    if not (out["bf16"]["b2_launches"] and out["int8"]["b3_launches"]
            and out["fabric"]["b1_launches_warm"]):
        raise AssertionError(f"serve_fleet: launches {counts}")
    ctx.setdefault("launches", {})["serve_fleet"] = counts
    log("serve_fleet launches: " + json.dumps(counts))
    ctx["serve_fleet"] = out


# -- serve_int8 --------------------------------------------------------------

#: Llama-3-8B's weights under QUANTIZATION=int8, by part: the bf16
#: embedding, the int8 projections and lm_head, their f32 scales, the norms
INT8_WEIGHT_BYTES = 1_050_673_152 + 6_979_321_856 + 525_336_576 \
    + 6_018_048 + 532_480


def _serve_int8_checks(ctx, base, eng) -> None:
    per = 7 * eng.cfg.n_layers + 1
    graphs = _graphs(eng)
    weights = eng._price_static_pools()["weights"]
    status, conf = _http(base + "/debug/conformance")
    ledger = conf.get("hbm", {}).get("weights_bytes")
    line = {"weights_bytes": weights, "ledger_weights_bytes": ledger,
            "want": INT8_WEIGHT_BYTES,
            "int8_per_replay": sorted({g.launches.get("int8_matmul", 0)
                                       for g in graphs}),
            "launches": ctx["launches"]["serve_int8"],
            "graph_pool_bytes": eng._graphs.bytes(),
            "serve_graph_pool_bytes": ctx.get("serve_summary", {}).get(
                "serve", {}).get("graph_pool_bytes")}
    log("serve_int8: " + json.dumps(line))
    if weights != INT8_WEIGHT_BYTES or ledger != INT8_WEIGHT_BYTES:
        raise AssertionError(f"serve_int8: weights pool {weights} (ledger "
                             f"{ledger}), want {INT8_WEIGHT_BYTES}")
    if line["int8_per_replay"] != [per]:
        raise AssertionError(f"serve_int8: int8 launches per replay "
                             f"{line['int8_per_replay']}, want {per}")
    ctx["serve_int8"] = line


def phase_serve_int8(ctx):
    # serve's tier, requests and switches with the weights born int8
    _serve(ctx, "serve_int8", {
        "VLLM_CONFIG": os.path.join(REPO, "no-vllm-config.yaml"),
        "SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "",
        "QUANTIZATION": "int8"},
        _serve_prompts(), {"flash_attention", "paged_decode_attention",
                           "int8_matmul", "int8_matmul_wide"},
        "B2 paged_decode_attention",
        then=lambda base, eng: _serve_int8_checks(ctx, base, eng))
    summary = ctx["serve_summary"]
    log("serve_int8 beside serve: " + json.dumps(
        {k: summary.get(k) for k in ("serve", "serve_int8")}))


# -- mllama (Llama-3.2-11B-Vision) ---------------------------------------------

#: the engine_mllama engine's shapes: the engine phases' (4 slots, buckets
#: 128 and 512, 2,048 tokens)
MLLAMA_ENGINE = {"max_model_len": 2048, "max_num_seqs": 4, "block_size": 16,
                 "context_encoding_buckets": (128, 512),
                 "max_new_tokens": ENGINE_NEW_TOKENS}
#: the engine_mllama prompts: an image row of one tile ("random"), one of
#: 2 x 2 tiles, a text-only row, and a 2 x 2 image row past the largest
#: bucket (the cross continuation ladder: 512 + 512 + 276)
MLLAMA_PROMPTS = (37, 120, 300, 1300)


def _mllama_model(ctx):
    """Llama-3.2-11B-Vision at full width and depth, seeded: the text tower
    (``LlamaConfig.mllama_11b_text``, 40 layers, 8 of them cross layers,
    N(0, 0.02) weights, the tanh gates U(0.5, 1.5)) and the vision tower
    with its projector (``MllamaVisionConfig()``: 560 px, 32 + 8 layers,
    N(0, 0.02), every gate U(0.5, 1.5)), bf16, built on the card once."""
    if "mllama" not in ctx:
        import torch
        from scalable_hw_agnostic_inference_tpu_torch.models import (
            mllama as mm,
        )
        from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
            LlamaConfig,
            LlamaForCausalLM,
            random_params,
        )

        t0 = time.monotonic()
        cfg = LlamaConfig.mllama_11b_text()
        model = LlamaForCausalLM.from_state_dict(
            cfg, random_params(cfg, seed=0, std=0.02, device="cuda"))
        vcfg = mm.MllamaVisionConfig()
        vision, proj = mm.build_vision(
            vcfg, cfg.dim, mm.random_vision_params(vcfg, cfg.dim, seed=1,
                                                   device="cuda"),
            dtype=torch.bfloat16)
        ctx["mllama"] = (cfg, model, vcfg, vision, proj)
        log(f"mllama model: Llama-3.2-11B-Vision, text {cfg.n_layers} "
            f"layers (cross {list(cfg.cross_attention_layers)}), vision "
            f"{vcfg.n_layers} + {vcfg.n_global_layers} layers at "
            f"{vcfg.image_size} px, Lv {vcfg.cross_seq_len}; "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B + "
            f"{sum(p.numel() for p in vision.parameters()) / 1e9:.3f} B + "
            f"{sum(p.numel() for p in proj.parameters()) / 1e9:.3f} B "
            f"params, built in {time.monotonic() - t0:.1f} s")
    return ctx["mllama"]


def _image_1120():
    """The in-script 1120 x 1120 image (2 x 2 tiles at 560 px, no
    resize): smooth gradients and seeded noise."""
    import numpy as np

    y, x = np.mgrid[0:1120, 0:1120]
    rng = np.random.default_rng(5)
    img = np.stack([x // 5, y // 5, (x + y) // 9], -1) % 256
    return (img + rng.integers(0, 24, img.shape)).clip(0, 255).astype(
        np.uint8)


def _encode_timed(torch, vision, proj, img, supported):
    """``(states, n_valid, ms, peak bytes over the resident)`` of one
    encode (the vision model always runs ``max_num_tiles`` tiles)."""
    from scalable_hw_agnostic_inference_tpu_torch.models import mllama as mm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    states, n = mm.encode_image(vision, proj, img, supported)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return states, n, ms, torch.cuda.max_memory_allocated() - base


def _count_prefills(eng):
    """Count the engine's prefill and continuation calls from here on (each
    launches B1 once per layer, cross layers included)."""
    calls = []
    for key, fn in list(eng._prefill.items()):
        def counted(*a, _fn=fn, **k):
            calls.append(1)
            return _fn(*a, **k)
        eng._prefill[key] = counted
    return calls


def _mllama_engine(ctx, switches, spec=0, model=None, cross=True):
    """A warmed engine over the mllama model (or ``model``, a text model of
    the same widths, with ``cross`` False) under ``switches``."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
    )

    cfg, mmodel, vcfg, _, _ = _mllama_model(ctx)
    model = model or mmodel
    ecfg = EngineConfig(**MLLAMA_ENGINE,
                        speculative_model="[ngram]" if spec else "",
                        num_speculative_tokens=spec,
                        ngram_prompt_lookup_max=4, ngram_prompt_lookup_min=1)
    env = {"SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "",
           "SHAI_ASYNC_DECODE": "1", **switches}
    with _env(env):
        eng = LLMEngine(model.cfg, model, ecfg, device="cuda",
                        cross_seq_len=vcfg.cross_seq_len if cross else 0)
        t0 = time.monotonic()
        eng.warm_executables()
        eng.warm_s = time.monotonic() - t0
    return eng


def _mllama_drive(eng, reqs, all_lp=True):
    """Submit ``reqs`` ``(prompt, states or None, cross_len)``, greedy,
    with 5 logprobs each, and step to the end. Returns the finished
    requests, the launch counts, the seconds and the walk: B2's exact
    count (the replays' captured launches) and B1's (the layers times the
    prefill and continuation calls, plus the replays' captured
    launches)."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        SamplingParams,
    )

    before = _replays(eng)
    calls = _count_prefills(eng)
    _reset_counters()
    t0 = time.monotonic()
    ids = [eng.add_request(p, SamplingParams(
        temperature=0.0, max_new_tokens=ENGINE_NEW_TOKENS,
        logprobs=5 if all_lp else 0), cross_states=s, cross_len=n)
        for p, s, n in reqs]
    done = {}
    while set(ids) - set(done):
        for f in eng.step():
            done[f.req_id] = f
    eng.finish_pending()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = _read_counters()
    walk = _expected_walk(eng, before, [])
    walk["flash_attention"] = eng.cfg.n_layers * len(calls) + sum(
        g.launches.get("flash_attention", 0)
        * (g.replays - before.get(g.key, 0)) for g in _graphs(eng))
    fins = [done[i] for i in ids]
    for f in fins:
        if len(f.token_ids) != ENGINE_NEW_TOKENS:
            raise AssertionError(f"{len(f.token_ids)} tokens, want "
                                 f"{ENGINE_NEW_TOKENS}")
    return fins, counts, seconds, walk, len(calls)


def _text_tower(cfg, model):
    """The mllama text tower's 32 self-attention layers as a text model of
    the same widths, sharing the weights (no copy): the text-only
    engine a cross decode replay is held against."""
    import dataclasses

    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaForCausalLM,
    )

    keep = [i for i in range(cfg.n_layers)
            if i not in cfg.cross_attention_layers]
    tcfg = dataclasses.replace(cfg, n_layers=len(keep),
                               cross_attention_layers=())
    sd = model.state_dict()
    state = {k: v for k, v in sd.items() if not k.startswith("layers.")}
    for j, i in enumerate(keep):
        pre = f"layers.{i}."
        state.update({f"layers.{j}." + k[len(pre):]: v
                      for k, v in sd.items() if k.startswith(pre)})
    return LlamaForCausalLM.from_state_dict(tcfg, state)


def phase_engine_mllama(ctx):
    """Llama-3.2-11B-Vision through the engine on the card: the vision
    encoder on a "random" image and an in-script 1120 x 1120 array; one
    batch of two image rows, a text-only row and an image prompt past the
    largest bucket, greedy, async equal to lock-step, scored by the plain
    scoring forward (``TIE_TOL``); the image rows against the same prompts
    text-only; a speculative round held by the tie rule; B1 and B2 exactly
    the layers times the calls and replays; the numbers of the slice."""
    import torch

    _drop_engine_model(ctx)
    try:
        _engine_mllama(ctx)
    finally:
        ctx.pop("mllama", None)
        gc.collect()
        torch.cuda.empty_cache()


def _engine_mllama(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models import mllama as mm

    cfg, model, vcfg, vision, proj = _mllama_model(ctx)
    supported = [[1, 1], [1, 2], [1, 3], [1, 4], [2, 1], [2, 2], [3, 1],
                 [4, 1]]
    row = {"card": ctx.get("card")}
    # the vision front-end (its first call builds what it needs)
    mm.encode_image(vision, proj, mm.random_image(vcfg), supported)
    s_rand, n_rand, ms_rand, peak_rand = _encode_timed(
        torch, vision, proj, mm.random_image(vcfg), supported)
    s_big, n_big, ms_big, peak_big = _encode_timed(
        torch, vision, proj, _image_1120(), supported)
    if (n_rand, n_big) != (1601, 6404) or not all(
            bool(torch.isfinite(s).all()) for s in (s_rand, s_big)):
        raise AssertionError(f"engine_mllama: encode gave {n_rand} / "
                             f"{n_big} states, or non-finite ones")
    row["vision_encode_ms"] = {"random_1_tile": ms_rand,
                               "1120_2x2_tiles": ms_big}
    row["vision_peak_bytes"] = max(peak_rand, peak_big)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in MLLAMA_PROMPTS]
    images = [(s_rand, n_rand), (s_big, n_big), None, (s_big, n_big)]
    reqs = [(p, None if im is None else im[0], 0 if im is None else im[1])
            for p, im in zip(prompts, images)]
    eng = _mllama_engine(ctx, {})
    # the admission-time cross-KV projection of a full image
    timer = ctx["timer"]
    with torch.inference_mode():
        row["cross_kv_ms"] = timer(lambda: eng._cross_embed(model, s_big),
                                   reps=5)
    fins, counts, seconds, walk, n_calls = _mllama_drive(eng, reqs)
    row.update(seconds=seconds, prefill_calls=n_calls, launches=counts,
               walk=walk, warm_s=eng.warm_s,
               recompiles=eng.obs.recompiles,
               leaked_blocks=eng.cache.leaked_blocks,
               flushes=eng.obs.flush_reasons(),
               b1_per_replay=sorted({g.launches.get("flash_attention", 0)
                                     for g in _graphs(eng)}),
               graph_pool_bytes=eng._graphs.bytes(),
               cross_kv_bytes=sum(t.nbytes for b in eng._cross_kv
                                  for t in b.values()),
               kv_pool_bytes=eng.cache.pool_bytes)
    if eng.tpot.count:
        tp = eng.tpot.report()
        row["tpot_ms"] = {"p50": tp["p50"] * 1e3, "p99": tp["p99"] * 1e3}
    # the slot_idx gather: each cross layer copies its rows' k and v
    Bb = MLLAMA_ENGINE["max_num_seqs"]
    row["gather_bytes_per_step"] = (2 * len(cfg.cross_attention_layers) * Bb
                                    * vcfg.cross_seq_len * cfg.n_kv_heads
                                    * cfg.head_dim * 2)
    # one replay of the full-batch decode key, wall and device by kernel
    big = eng._decode_fns[max(eng._decode_fns, key=lambda k: k[1])]
    with torch.inference_mode():
        row["replay_ms"] = _step_wall_ms(torch, big.replay)
        by_kernel = _device_us_by_kernel(torch, big.replay, calls=10)
    dev_us = sum(us for us, _ in by_kernel.values())
    b1_us = sum(us for k, (us, _) in by_kernel.items() if "flash_kernel" in k)
    row["replay_device_ms"] = dev_us / 1e3 if dev_us else None
    row["b1_share_of_replay"] = b1_us / dev_us if dev_us else None
    row["b1_replay_ms"] = b1_us / 1e3 if dev_us else None
    # the same prompts' image rows text-only: the image must change them
    text = _mllama_drive(eng, [(p, None, 0) for p, _, _ in reqs[:2]])[0]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # lock-step: the same tokens and logprob entries
    eng = _mllama_engine(ctx, {"SHAI_ASYNC_DECODE": "0"})
    sync = _mllama_drive(eng, reqs)
    sync_leak, sync_rc = eng.cache.leaked_blocks, eng.obs.recompiles
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the text-only engine: the same weights without the cross layers
    tmodel = _text_tower(cfg, model)
    teng = _mllama_engine(ctx, {}, model=tmodel, cross=False)
    _mllama_drive(teng, [(p, None, 0) for p, _, _ in reqs])
    tbig = teng._decode_fns[max(teng._decode_fns, key=lambda k: k[1])]
    with torch.inference_mode():
        row["text_replay_ms"] = _step_wall_ms(torch, tbig.replay)
        tdev = _device_step(torch, tbig.replay)[0]
    row["text_replay_device_ms"] = tdev
    del teng, tmodel, tbig
    gc.collect()
    torch.cuda.empty_cache()
    # speculative decoding through verify's cross tail
    eng = _mllama_engine(ctx, {}, spec=SPEC_K)
    spec = _mllama_drive(eng, reqs)
    row["spec"] = eng.spec.as_dict()
    row["spec_walk"] = spec[3]
    row["spec_b1_per_verify"] = sorted({g.launches.get("flash_attention", 0)
                                        for g in eng._verify_fns.values()})
    spec_leak, spec_rc = eng.cache.leaked_blocks, eng.obs.recompiles
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # scoring: each request's tokens by the scoring forward with its vision
    # states, through B1 and through B1's plain version
    crosses = [None if s is None else (s, n) for _, s, n in reqs]
    sc = _score(model, prompts, fins, crosses)
    ssc = _score(model, prompts, spec[0], crosses)
    gaps, noise = _partings(spec[0], fins)
    row.update(score={k: sc[k] for k in ("b1", "plain", "tokens", "eps",
                                         "lp_err")},
               spec_score={k: ssc[k] for k in ("b1", "plain", "tokens")},
               spec_parting_gaps=gaps, spec_noise=noise,
               spec_tie_gap=max(TIE_GAP, NOISE_TIES * noise),
               spec_streams_equal=sum(a.token_ids == b.token_ids
                                      for a, b in zip(spec[0], fins)),
               image_vs_text_equal=[a.token_ids == b.token_ids
                                    for a, b in zip(fins[:2], text)])
    ctx["engine_mllama"] = row
    ctx.setdefault("launches", {})["engine_mllama"] = counts
    log("engine_mllama: " + json.dumps(row))
    bad = [k for k, ok in (
        ("async == lock-step",
         [(f.token_ids, f.logprobs) for f in fins]
         == [(f.token_ids, f.logprobs) for f in sync[0]]),
        ("B1/B2 walk", {k: counts[k] for k in walk} == walk),
        ("lock-step walk", {k: sync[1][k] for k in sync[3]} == sync[3]),
        ("spec walk", {k: spec[1][k] for k in spec[3]} == spec[3]),
        ("8 B1 launches a replay", row["b1_per_replay"] == [8]),
        ("8 B1 launches a verify", row["spec_b1_per_verify"] == [8]),
        ("0 recompiles", row["recompiles"] == sync_rc == spec_rc == 0),
        ("no leaked block", not (row["leaked_blocks"] or sync_leak
                                 or spec_leak)),
        ("tokens by the plain scoring forward",
         sc["plain"][1] <= TIE_TOL and ssc["plain"][1] <= TIE_TOL),
        ("logprobs", sc["lp_err"] <= LP_TOL),
        ("image rows differ from text-only",
         not any(row["image_vs_text_equal"])),
        ("spec by the tie rule",
         all(g < row["spec_tie_gap"] for g in gaps)),
        ("verify steps", row["spec"]["spec_verify_steps"] > 0),
        ("a chunk", n_calls > 4)) if not ok]
    if bad:
        raise AssertionError(f"engine_mllama: failed {bad}")
    _check_counters("engine_mllama", counts,
                    {"flash_attention", "paged_decode_attention"})


# serve_mllama: the directory's cut (full widths; depth cut so that the
# phase stays in its time limit): text 10 layers with cross layers at 3
# and 8, vision 8 local + 2 global layers collecting layers 1, 3, 5, 6, 7
SERVE_MLLAMA_TEXT_LAYERS = 10
SERVE_MLLAMA_CROSS = (3, 8)
SERVE_MLLAMA_VISION = {"num_hidden_layers": 8, "num_global_layers": 2,
                       "intermediate_layers_indices": [1, 3, 5, 6, 7]}
SERVE_MLLAMA_CONFIG = {"max_model_len": 2048, "block_size": 16,
                       "max_num_seqs": 8,
                       "context_encoding_buckets": [128, 512],
                       "max_new_tokens": 16}


def _png_bytes(img, filters=(0, 1, 2, 3, 4)) -> bytes:
    """An 8-bit RGB PNG of ``img`` whose rows cycle through ``filters``
    (by default the five filter types: None, Sub, Up, Average, Paeth),
    written with zlib."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = img.shape
    out = bytearray()
    prev = np.zeros(w * 3, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        a = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        c = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out), 6))
            + chunk(b"IEND", b""))


#: JPEG's zigzag order: zigzag index -> natural (row-major) index
JPEG_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

#: the ITU T.81 Annex K example quantization tables (row-major)
JPEG_QT_LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60,
                55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87,
                80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64,
                81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72,
                92, 95, 98, 112, 100, 103, 99)
JPEG_QT_CHROMA = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99,
                  99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66) + (99,) * 38

#: sampling name -> each component's (h, v) factors
JPEG_SAMPLING = {"4:4:4": ((1, 1), (1, 1), (1, 1)),
                 "4:2:2": ((2, 1), (1, 1), (1, 1)),
                 "4:2:0": ((2, 2), (1, 1), (1, 1)),
                 "4:4:0": ((1, 2), (1, 1), (1, 1)),
                 "gray": ((1, 1),)}


def _jpeg_bytes(img, sampling="4:2:0", quality=90, progressive=False,
                restart=0, extended=False) -> bytes:
    """A JFIF JPEG of ``img`` (``[H, W, 3]`` uint8; ``"gray"`` takes its
    first channel), written here with numpy: YCbCr, each chroma plane
    averaged down to its ``sampling`` factors, the float DCT, the Annex K
    tables scaled to ``quality`` as libjpeg scales them (``extended``:
    16-bit tables past 255, an SOF1 frame), Huffman tables of one length
    (4 bits for the 12 DC categories, 9 for the AC symbols). Baseline:
    one interleaved scan; ``progressive`` (SOF2): an interleaved DC scan,
    then spectral bands per component (luma 1-5 and 6-63, chroma 1-63),
    each band ended by an EOB of one block. ``restart``: a restart marker
    every ``restart`` MCUs of every scan."""
    import math
    import struct

    import numpy as np

    facs = JPEG_SAMPLING[sampling]
    h, w = img.shape[:2]
    px = img.astype(np.float64)
    if sampling == "gray":
        planes = [px[..., 0]]
    else:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax = max(f[0] for f in facs)
    vmax = max(f[1] for f in facs)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    cap = 32767 if extended else 255
    qts = [np.clip((np.asarray(t) * scale + 50) // 100, 1, cap).astype(
        np.int64) for t in (JPEG_QT_LUMA, JPEG_QT_CHROMA)]
    u = np.arange(8)
    dct = np.cos((2 * u[None, :] + 1) * u[:, None] * math.pi / 16) / 2
    dct[0] /= math.sqrt(2)
    zz = np.asarray(JPEG_ZIGZAG)
    comps = []
    for ci, (plane, (fh, fv)) in enumerate(zip(planes, facs)):
        full = np.pad(plane, ((0, mcuy * 8 * vmax - h),
                              (0, mcux * 8 * hmax - w)), mode="edge")
        sy, sx = vmax // fv, hmax // fh
        small = full.reshape(full.shape[0] // sy, sy, full.shape[1] // sx,
                             sx).mean(axis=(1, 3))
        bh, bw = small.shape[0] // 8, small.shape[1] // 8
        blocks = small.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        coef = np.einsum("uy,abyx,vx->abuv", dct, blocks, dct)
        qt = qts[0 if ci == 0 else 1]
        q = np.round(coef.reshape(bh, bw, 64) / qt).astype(np.int64)
        comps.append({"id": ci + 1, "h": fh, "v": fv, "tq": min(ci, 1),
                      "bw": bw, "zz": q[:, :, zz].tolist(),
                      "cw": -(-w * fh // hmax), "ch": -(-h * fv // vmax)})

    out = bytearray(b"\xff\xd8")

    def seg(marker, body):
        out.extend(struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body)

    seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, qt in enumerate(qts[:1 if sampling == "gray" else 2]):
        vals = qt[zz]
        if int(vals.max()) > 255:
            seg(0xDB, bytes([0x10 | i]) + vals.astype(">u2").tobytes())
        else:
            seg(0xDB, bytes([i]) + vals.astype(np.uint8).tobytes())
    sof = 0xC2 if progressive else 0xC1 if extended else 0xC0
    seg(sof, struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(
        bytes([c["id"], c["h"] << 4 | c["v"], c["tq"]]) for c in comps))
    # one code length a table: DC categories 0-11 at 4 bits, AC symbols
    # 0-254 at 9 (symbol v is code v) and 255, never used, at 10
    dc_counts = [0] * 16
    dc_counts[3] = 12
    ac_counts = [0] * 16
    ac_counts[8] = 255
    ac_counts[9] = 1
    for t in range(1 if sampling == "gray" else 2):
        seg(0xC4, bytes([t]) + bytes(dc_counts) + bytes(range(12)))
        seg(0xC4, bytes([0x10 | t]) + bytes(ac_counts) + bytes(range(256)))
    if restart:
        seg(0xDD, struct.pack(">H", restart))

    class Bits:
        def __init__(self):
            self.acc = self.n = 0

        def put(self, code, length):
            self.acc = (self.acc << length) | code
            self.n += length
            while self.n >= 8:
                self.n -= 8
                byte = (self.acc >> self.n) & 0xFF
                out.append(byte)
                if byte == 0xFF:
                    out.append(0)
            self.acc &= (1 << self.n) - 1

        def value(self, v):
            s = abs(v).bit_length()
            if s:
                self.put(v if v > 0 else v + (1 << s) - 1, s)
            return s

        def align(self):
            if self.n:
                self.put((1 << (8 - self.n)) - 1, 8 - self.n)

    def scan(members, ss, se, units, code_unit):
        out.extend(struct.pack(">BBHB", 0xFF, 0xDA, 6 + 2 * len(members),
                               len(members)))
        for c in members:
            out.extend(bytes([c["id"], c["tq"] << 4 | c["tq"]]))
        out.extend(bytes([ss, se, 0]))
        bits = Bits()
        pred = {c["id"]: 0 for c in members}
        for k, unit in enumerate(units):
            if restart and k and k % restart == 0:
                bits.align()
                out.extend(bytes([0xFF, 0xD0 + (k // restart - 1) % 8]))
                pred = {c["id"]: 0 for c in members}
            for c, by, bx in unit:
                code_unit(bits, c, c["zz"][by][bx], pred)
        bits.align()

    def code_dc(bits, c, z, pred):
        diff = z[0] - pred[c["id"]]
        pred[c["id"]] = z[0]
        bits.put(abs(diff).bit_length(), 4)
        bits.value(diff)

    def code_ac(ss, se):
        def code(bits, c, z, pred):
            run = 0
            for k in range(ss, se + 1):
                v = z[k]
                if not v:
                    run += 1
                    continue
                while run > 15:
                    bits.put(0xF0, 9)
                    run -= 16
                bits.put(run << 4 | abs(v).bit_length(), 9)
                bits.value(v)
                run = 0
            if run:
                bits.put(0x00, 9)      # EOB (EOB0: a run of one block)
        return code

    def interleaved(members):
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                units.append([(c, my * c["v"] + y, mx * c["h"] + x)
                              for c in members for y in range(c["v"])
                              for x in range(c["h"])])
        return units

    def single(c):
        return [[(c, y, x)] for y in range(-(-c["ch"] // 8))
                for x in range(-(-c["cw"] // 8))]

    # a scan of one component is non-interleaved: its own blocks, in order
    units_all = single(comps[0]) if len(comps) == 1 else interleaved(comps)
    if not progressive:
        def code_block(bits, c, z, pred):
            code_dc(bits, c, z, pred)
            code_ac(1, 63)(bits, c, z, pred)
        scan(comps, 0, 63, units_all, code_block)
    else:
        scan(comps, 0, 0, units_all, code_dc)
        for c in comps:
            bands = ((1, 5), (6, 63)) if c["id"] == 1 else ((1, 63),)
            for ss, se in bands:
                scan([c], ss, se, single(c), code_ac(ss, se))
    out.extend(b"\xff\xd9")
    return bytes(out)


def _cmyk_jpeg() -> bytes:
    """The headers of a 4-component (CMYK) baseline JPEG, which the port
    answers with a 400 naming it."""
    import struct

    sof = struct.pack(">BHHB", 8, 8, 8, 4) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(4))
    return (b"\xff\xd8" + b"\xff\xee" + struct.pack(">H", 14)
            + b"Adobe\x00\x64\x00\x00\x00\x00\x02"
            + b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xd9")


def _sp_tokenizer_spec(vocab_size: int = 32000, n_added: int = 2):
    """A SentencePiece-style BPE ``tokenizer.json`` (dict) of Llama-2's
    layout and size, built here from a seed: ``<unk>``, ``<s>``, ``</s>``,
    the 256 ``<0xXX>`` byte tokens, the printable ASCII characters and
    "▁", then merged pieces up to ``vocab_size`` (each a shorter piece and
    one character, ranked shortest first), the legacy normalizer
    ``Prepend("▁"), Replace(" ", "▁")``, byte fallback, the decoder
    ``Replace, ByteFallback, Fuse, Strip(1, 0)``, BOS through the
    template; LLaVA's added ``<image>`` and ``<pad>`` after the vocabulary
    (``n_added``)."""
    import random

    sp = "▁"
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    alphabet = [sp] + [chr(c) for c in range(33, 127)]
    for ch in alphabet:
        vocab[ch] = len(vocab)
    rng = random.Random(11)
    letters = [sp] + list("etaoinshrdlcumwfgypbvkjxqz")
    merges = []
    frontier = list(letters)
    while len(vocab) < vocab_size:
        grown = []
        for piece in frontier:
            for ch in rng.sample(letters, 8):
                new = piece + ch
                if new not in vocab and len(vocab) < vocab_size:
                    vocab[new] = len(vocab)
                    merges.append(f"{piece} {ch}")
                    grown.append(new)
        frontier = grown or list(letters)
    tok = {"content": "", "single_word": False, "lstrip": False,
           "rstrip": False, "normalized": False, "special": True}
    added = [dict(tok, id=i, content=c) for c, i in (
        ("<unk>", 0), ("<s>", 1), ("</s>", 2))]
    added += [dict(tok, id=vocab_size + i, content=c) for i, c in enumerate(
        ("<image>", "<pad>")[:n_added])]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": sp},
            {"type": "Replace", "pattern": {"String": " "},
             "content": sp}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                       "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": sp}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges}}


def _write_sp_tokenizer(path) -> None:
    """LLaVA-1.5's tokenizer files, seeded (``_sp_tokenizer_spec``):
    ``tokenizer.json`` and a ``LlamaTokenizerFast`` config."""
    path = Path(path)
    (path / "tokenizer.json").write_text(json.dumps(_sp_tokenizer_spec(),
                                                    ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
        "add_bos_token": True, "add_eos_token": False, "legacy": False,
        "clean_up_tokenization_spaces": False, "padding_side": "left",
        "model_max_length": 4096}))


#: photo sizes the image front-end is timed at on the host: 1080p and a
#: 12 MP phone photo, every row Paeth-filtered as photo encoders write
SERVE_MLLAMA_PHOTOS = ((1080, 1920), (3024, 4032))


def _time_image_front_end(ctx):
    """Host ms of the PNG decode (``imageio.decode_image``) and of the
    tiling (``mllama.preprocess_tiled``: the resize to the canvas, the
    normalization, the tiles) of photo-size all-Paeth PNGs at
    Llama-3.2-11B-Vision's 560 px tiles, each the best of two, the decode
    held equal to the image written."""
    import numpy as np
    from scalable_hw_agnostic_inference_tpu_torch.models import mllama as mm
    from scalable_hw_agnostic_inference_tpu_torch.models.imageio import (
        decode_image,
    )

    vcfg = mm.MllamaVisionConfig()
    supported = [[1, 1], [1, 2], [1, 3], [1, 4], [2, 1], [2, 2], [3, 1],
                 [4, 1]]
    rng = np.random.default_rng(5)
    row = {}
    for h, w in SERVE_MLLAMA_PHOTOS:
        y, x = np.mgrid[0:h, 0:w]
        img = ((np.stack([x // 5, y // 5, (x + 2 * y) // 9], -1) % 256
                + rng.integers(0, 24, (h, w, 3))).clip(0, 255)
               .astype(np.uint8))
        data = _png_bytes(img, filters=(4,))
        dec, pre = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            got = decode_image(data)
            t1 = time.perf_counter()
            _, _, n_tiles = mm.preprocess_tiled(got, vcfg, supported)
            dec.append((t1 - t0) * 1e3)
            pre.append((time.perf_counter() - t1) * 1e3)
        if not np.array_equal(got, img):
            raise AssertionError(f"serve_mllama: the {w}x{h} PNG decoded "
                                 f"unlike the image written")
        row[f"{w}x{h}"] = {"png_mb": len(data) / 1e6,
                           "decode_ms": min(dec), "decode_ms_all": dec,
                           "preprocess_ms": min(pre), "n_tiles": n_tiles}
    ctx["serve_mllama_front_end"] = row
    log("serve_mllama: image front-end on the host (all-Paeth PNG): "
        + json.dumps(row))


def _seeded_mllama_dir(ctx):
    """A seeded Llama-3.2-11B-Vision directory in HF layout at full widths,
    depth cut (``SERVE_MLLAMA_*``): ``config.json`` (model_type mllama,
    text and vision configs), the tensors under HF's names
    (``model.language_model.*``, ``model.vision_model.*``,
    ``model.multi_modal_projector.*``, ``lm_head``; the embedding with
    its 8 image-token rows) in two shards, and the BPE tokenizer."""
    import dataclasses
    import tempfile

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
        save_sharded,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models import mllama as mm
    from scalable_hw_agnostic_inference_tpu_torch.models.convert import (
        hf_name,
        mllama_vision_config,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        random_params,
    )

    cfg = dataclasses.replace(
        LlamaConfig.mllama_11b_text(), n_layers=SERVE_MLLAMA_TEXT_LAYERS,
        cross_attention_layers=SERVE_MLLAMA_CROSS)
    vjson = {"hidden_size": 1280, "attention_heads": 16,
             "intermediate_size": 5120, "image_size": 560, "patch_size": 14,
             "max_num_tiles": 4, "norm_eps": 1e-5,
             "vision_output_dim": 1280 * 6, **SERVE_MLLAMA_VISION,
             "supported_aspect_ratios": [[1, 1], [1, 2], [1, 3], [1, 4],
                                         [2, 1], [2, 2], [3, 1], [4, 1]],
             "model_type": "mllama_vision_model"}
    vcfg, _ = mllama_vision_config(vjson)
    state = random_params(cfg, seed=7, std=0.02, device="cuda")
    # HF's embedding rows: the vocabulary and 8 image tokens
    state["embed.weight"] = torch.cat([
        state["embed.weight"],
        torch.zeros(8, cfg.dim, dtype=torch.bfloat16, device="cuda")])
    tensors = {hf_name(k, "model.language_model."): v
               for k, v in state.items()}
    vstate = mm.random_vision_params(vcfg, cfg.dim, seed=8, device="cuda")
    names = mm.vision_hf_names(vcfg, "model.vision_model",
                               "model.multi_modal_projector")
    for k, v in vstate.items():
        flat = names[k]
        if k.endswith(("tile_pos_emb", "pre_tile_emb", "post_tile_emb")):
            v = v.reshape(v.shape[0], -1)      # HF's flat embedding rows
        tensors[flat] = v
    path = Path(tempfile.mkdtemp(prefix="shai-mllama-")) / "llama-3.2-vision"
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["MllamaForConditionalGeneration"],
        "model_type": "mllama", "torch_dtype": "bfloat16",
        "text_config": {
            "model_type": "mllama_text_model", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.dim, "intermediate_size": cfg.mlp_dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "cross_attention_layers": list(cfg.cross_attention_layers),
            "max_position_embeddings": cfg.max_seq_len,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
            "rope_scaling": None, "tie_word_embeddings": False,
            "hidden_act": "silu"},
        "vision_config": vjson}))
    (path / "preprocessor_config.json").write_text(json.dumps({
        "image_mean": [0.48145466, 0.4578275, 0.40821073],
        "image_std": [0.26862954, 0.26130258, 0.27577711]}))
    paths = save_sharded(tensors, path, 2)
    _write_tokenizer(path)
    del state, vstate, tensors
    gc.collect()
    torch.cuda.empty_cache()
    ctx["seeded_mllama"] = path
    return path, sum(p.stat().st_size for p in paths)


def phase_serve_mllama(ctx):
    """The vllm unit on a seeded mllama directory (``_seeded_mllama_dir``):
    8 concurrent ``POST /generate`` (4 PNG images of two sizes, 2
    ``"random"``, 2 text-only), the 400s of a malformed image and a
    corrupt JPEG, and the ``cross_kv`` pool on ``/metrics``; B1 and B2 only, 0
    recompiles, no leaked block. First, the image front-end's host ms on
    photo-size PNGs (``_time_image_front_end``)."""
    import base64

    import numpy as np

    ctx.pop("mllama", None)
    _drop_engine_model(ctx)
    _time_image_front_end(ctx)
    t0 = time.monotonic()
    path, n_bytes = _seeded_mllama_dir(ctx)
    write_s = time.monotonic() - t0
    rng = np.random.default_rng(4)
    pngs = []
    for h, w in ((480, 640), (768, 1024)):
        y, x = np.mgrid[0:h, 0:w]
        img = (np.stack([x // 3, y // 3, (x + 2 * y) // 7], -1) % 256
               + rng.integers(0, 16, (h, w, 3))).clip(0, 255)
        pngs.append(base64.b64encode(_png_bytes(img.astype(np.uint8)))
                    .decode())
    # the text-only rows repeat the first two image rows' prompts
    prompts = [f"image {i}: describe what you see in detail" for i in
               range(4)] + ["random image: what is it?"] * 2 + [
        f"image {i}: describe what you see in detail" for i in range(2)]
    images = [pngs[0], pngs[1], pngs[0], pngs[1], "random", "random",
              None, None]
    # token ids ride the logprob entries (most of the seeded model's ids lie
    # past the small tokenizer's vocabulary and decode to no text)
    payloads = [{"prompt": p, "logprobs": 1} if im is None else
                {"prompt": p, "image_b64": im, "logprobs": 1}
                for p, im in zip(prompts, images)]
    config = str(path.parent / "vllm_config.json")
    with open(config, "w") as f:
        json.dump(SERVE_MLLAMA_CONFIG, f)
    log(f"serve_mllama: wrote {path} ({n_bytes / 1e9:.2f} GB) in "
        f"{write_s:.1f} s: text {SERVE_MLLAMA_TEXT_LAYERS} layers (cross "
        f"{list(SERVE_MLLAMA_CROSS)}), vision {SERVE_MLLAMA_VISION}")

    def checks(base, eng):
        svc = ctx["serving"]["service"]
        bad = {}
        for name, b64 in (("malformed", "@@not base64@@"),
                          ("jpeg", base64.b64encode(
                              b"\xff\xd8\xff\xe0" + bytes(200)).decode())):
            status, body = _http(base + "/generate", {
                "prompt": "x", "image_b64": b64, "max_new_tokens": 4})
            bad[name] = (status, body.get("detail", body))
        metrics = _http(base + "/metrics", raw=True)[1]
        cross = [ln for ln in metrics.splitlines()
                 if ln.startswith("shai_hbm_cross_kv")]
        row = {"bad_images": bad, "hbm_cross_kv": cross,
               "vision_warm_s": svc.vision_warm_seconds,
               "load_s": svc.load_seconds,
               "cross_kv_bytes": sum(t.nbytes for b in eng._cross_kv
                                     for t in b.values()),
               "cross_seq_len": eng.cross_seq_len}
        ctx["serve_mllama_checks"] = row
        log("serve_mllama: " + json.dumps(row))
        if bad["malformed"][0] != 400 or bad["jpeg"][0] != 400 \
                or "JPEG" not in json.dumps(bad["jpeg"]):
            raise AssertionError(f"serve_mllama: bad images answered {bad}")
        if not cross or float(cross[0].split()[-1]) <= 0:
            raise AssertionError("serve_mllama: no shai_hbm_cross_kv_bytes "
                                 "on /metrics")

    results = _serve(ctx, "serve_mllama", {
        "MODEL_ID": str(path), "VLLM_CONFIG": config,
        "SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": ""},
        payloads, {"flash_attention", "paged_decode_attention"},
        "B2 paged_decode_attention", then=checks)
    toks = [r[1]["n_tokens"] for r in results]
    ids = [[e["token"] for e in r[1]["logprobs"]] for r in results]
    # the image changes the tokens of the same prompt
    same = [ids[i] == ids[6 + i] for i in range(2)]
    log(f"serve_mllama: tokens {toks}; image rows equal to their prompts "
        f"text-only: {same}")
    shutil.rmtree(path.parent, ignore_errors=True)
    ctx.pop("seeded_mllama", None)
    if any(same) or any(t < 1 for t in toks):
        raise AssertionError(f"serve_mllama: tokens {toks}, image rows "
                             f"equal to text-only {same}")


# -- the soft-prefix VLM (LLaVA-1.5-7B) ----------------------------------------

LLAVA_ENGINE = {"max_model_len": 2048, "max_num_seqs": 4, "block_size": 16,
                "context_encoding_buckets": (128, 512, 2048),
                "max_new_tokens": ENGINE_NEW_TOKENS}
#: engine_llava's text lengths of its four image rows (a PNG, a baseline
#: JPEG, a progressive JPEG, "random"); two text-only rows repeat the
#: first two prompts
LLAVA_TEXT = (37, 120, 300, 64)
#: the preemption run: two image rows of 576 + 300 tokens admit into a
#: pool of this many blocks (the null block and 2 x 55, one free), so the
#: second row to cross a block boundary in decode is preempted
LLAVA_PREEMPT_BLOCKS = 112


def _llava_model(ctx):
    """LLaVA-1.5-7B at full width and depth, seeded: the Llama-2-7B text
    model (``LlamaConfig.llava15_7b_text``, N(0, 0.02)) and the CLIP-L/14
    336 px tower with its projector (``VisionTowerConfig()``, N(0, 0.02),
    unit LayerNorm scales), bf16, built on the card once."""
    if "llava" not in ctx:
        import torch
        from scalable_hw_agnostic_inference_tpu_torch.models import vlm
        from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
            LlamaConfig,
            LlamaForCausalLM,
            random_params,
        )

        t0 = time.monotonic()
        cfg = LlamaConfig.llava15_7b_text()
        model = LlamaForCausalLM.from_state_dict(
            cfg, random_params(cfg, seed=0, std=0.02, device="cuda"))
        vcfg = vlm.VisionTowerConfig()
        tower = vlm.build(vcfg, vlm.random_params(vcfg, seed=1,
                                                  device="cuda"),
                          dtype=torch.bfloat16)
        ctx["llava"] = (cfg, model, vcfg, tower)
        log(f"llava model: LLaVA-1.5-7B, text {cfg.n_layers} layers "
            f"({cfg.n_heads} heads over {cfg.n_kv_heads}), tower "
            f"{vcfg.n_layers} layers at {vcfg.image_size} px "
            f"({vcfg.n_patches} patches, {vcfg.n_blocks} blocks run); "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B + "
            f"{sum(p.numel() for p in tower.parameters()) / 1e9:.3f} B "
            f"params, built in {time.monotonic() - t0:.1f} s")
    return ctx["llava"]


def _llava_photo(h=480, w=640, seed=6):
    """A seeded photo-like image: gradients, a disc, noise."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) % 256], -1)
    disc = (x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 3) ** 2
    img[disc] = (img[disc] + 128) % 256
    return (img + rng.integers(0, 20, img.shape)).clip(0, 255).astype(
        np.uint8)


def _llava_images():
    """engine_llava's four images as ``image_b64`` payloads: a PNG, a
    baseline and a progressive 4:2:0 JPEG of one photo, and "random"."""
    import base64

    img = _llava_photo()

    def b64(data):
        return base64.b64encode(data).decode()

    return [("png", b64(_png_bytes(img))),
            ("jpeg", b64(_jpeg_bytes(img, "4:2:0", 90))),
            ("jpeg_progressive", b64(_jpeg_bytes(img, "4:2:0", 90,
                                                 progressive=True))),
            ("random", "random")]


def _tower_timed(torch, tower, px):
    """``(prefix [P, dim] f32, ms, peak bytes over the resident, B1
    launches)`` of one tower run on ``px`` ``[1, H, W, 3]``."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
    )

    x = torch.from_numpy(px).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n0 = fa.flash_attention.launches
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = tower(x)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, ms, torch.cuda.max_memory_allocated() - base,
            fa.flash_attention.launches - n0)


def _llava_engine(ctx, switches, num_blocks=0, spec=0):
    """A warmed engine over the LLaVA model under ``switches`` (with
    ``spec``, ``[ngram]`` speculation of that many tokens), its closed set
    holding the soft-prefix prefill."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
    )

    cfg, model, vcfg, _ = _llava_model(ctx)
    ecfg = EngineConfig(**LLAVA_ENGINE, num_blocks=num_blocks,
                        speculative_model="[ngram]" if spec else "",
                        num_speculative_tokens=spec,
                        ngram_prompt_lookup_max=4, ngram_prompt_lookup_min=1)
    env = {"SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "",
           "SHAI_ASYNC_DECODE": "1", **switches}
    with _env(env):
        eng = LLMEngine(cfg, model, ecfg, device="cuda")
        t0 = time.monotonic()
        eng.n_warm = eng.warm_executables([0, vcfg.n_patches])
        eng.warm_s = time.monotonic() - t0
    return eng


def _llava_drive(eng, reqs):
    """Submit ``reqs`` ``(prompt, prefix or None)``, greedy with 5
    logprobs each, and step to the end. Returns the finished requests, the
    launch counts, the seconds, the exact walk (B1: the layers times the
    prefill calls; B2 or B3: the replays' captured launches) and the
    prefill calls."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        SamplingParams,
    )

    before = _replays(eng)
    calls = _count_prefills(eng)
    _reset_counters()
    t0 = time.monotonic()
    ids = [eng.add_request(p, SamplingParams(
        temperature=0.0, max_new_tokens=ENGINE_NEW_TOKENS, logprobs=5),
        prefix=pre) for p, pre in reqs]
    done = {}
    while set(ids) - set(done):
        for f in eng.step():
            done[f.req_id] = f
    eng.finish_pending()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = _read_counters()
    walk = _expected_walk(eng, before, [])
    walk["flash_attention"] = eng.cfg.n_layers * len(calls)
    fins = [done[i] for i in ids]
    for f in fins:
        if len(f.token_ids) != ENGINE_NEW_TOKENS:
            raise AssertionError(f"{len(f.token_ids)} tokens, want "
                                 f"{ENGINE_NEW_TOKENS}")
    return fins, counts, seconds, walk, len(calls)


def phase_engine_llava(ctx):
    """LLaVA-1.5-7B through the engine on the card: the tower on a PNG, a
    baseline and a progressive JPEG (decoded, resized bicubic and
    normalized by ``serve.units.common.decode_image``) and "random"; four
    image rows and two text-only rows, greedy, async equal to lock-step,
    scored by the plain scoring forward over ``[prefix; prompt]``
    (``TIE_TOL``), the image rows unlike their prompts text-only; (a)
    bucketed (B1, B2), (b) ragged with int8 KV (B1, B3); (c) an image row
    preempted and resumed; (d) ``[ngram]`` speculation (k = ``SPEC_K``)
    over the rows of (a), held as ``engine_mllama``'s spec round is: the
    plain scoring forward by ``TIE_TOL``, (a)'s tokens by the tie rule,
    B2 exactly the decode and verify replays' captured launches, a verify
    replay's ms at a group of one; B1 exactly the layers times the prefill
    calls, B2 and B3 the replays' captured launches; 0 recompiles, no
    leaked block; the tower's ms and peak bytes an image."""
    import torch

    _drop_engine_model(ctx)
    try:
        _engine_llava(ctx)
    finally:
        ctx.pop("llava", None)
        gc.collect()
        torch.cuda.empty_cache()


def _engine_llava(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.common import (
        decode_image,
    )

    cfg, model, vcfg, tower = _llava_model(ctx)
    row = {"card": ctx.get("card")}
    images = _llava_images()
    _tower_timed(torch, tower, decode_image({"image_b64": "random"},
                                            vcfg.image_size))    # warm
    prefixes, tower_ms, tower_peak, tower_b1 = [], {}, 0, set()
    for name, b64 in images:
        pre, ms, peak, n_b1 = _tower_timed(torch, tower, decode_image(
            {"image_b64": b64}, vcfg.image_size))
        if tuple(pre.shape) != (vcfg.n_patches, cfg.dim) or not bool(
                torch.isfinite(pre).all()):
            raise AssertionError(f"engine_llava: the {name} prefix is "
                                 f"{tuple(pre.shape)} or not finite")
        prefixes.append(pre)
        tower_ms[name] = ms
        tower_peak = max(tower_peak, peak)
        tower_b1.add(n_b1)
    row.update(tower_ms=tower_ms, tower_peak_bytes=tower_peak,
               tower_b1_launches=sorted(tower_b1))
    with torch.inference_mode():
        x = torch.from_numpy(decode_image({"image_b64": "random"},
                                          vcfg.image_size)).to("cuda")
        row["tower_device_ms"] = ctx["timer"](lambda: tower(x), reps=5)
        tk = _device_us_by_kernel(torch, lambda: tower(x), calls=3)
    row["tower_b1_ms"] = sum(us for k, (us, _) in tk.items()
                             if "flash_kernel" in k) / 1e3
    log("engine_llava tower: " + json.dumps(
        {k: row[k] for k in ("tower_ms", "tower_device_ms", "tower_b1_ms",
                             "tower_peak_bytes", "tower_b1_launches")}))
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in LLAVA_TEXT]
    reqs = [(p, pre) for p, pre in zip(prompts, prefixes)] + [
        (p, None) for p in prompts[:2]]
    runs = {}
    for label, switches, expect in (
            ("engine_llava (a)", {}, {"flash_attention",
                                      "paged_decode_attention"}),
            ("engine_llava (b)", {"SHAI_RAGGED_ATTENTION": "1",
                                  "SHAI_KV_QUANT": "int8"},
             {"flash_attention", "ragged_paged_attention"})):
        eng = _llava_engine(ctx, switches)
        fins, counts, seconds, walk, n_calls = _llava_drive(eng, reqs)
        r = {"seconds": seconds, "prefill_calls": n_calls,
             "launches": counts, "walk": walk, "warmed": eng.n_warm,
             "warm_s": eng.warm_s,
             "prefix_keys": sorted(str(k) for k in eng._prefill
                                   if k[0] == "prefix"),
             "recompiles": eng.obs.recompiles,
             "leaked_blocks": eng.cache.leaked_blocks,
             "flushes": eng.obs.flush_reasons(),
             "kv_pool_bytes": eng.cache.pool_bytes,
             "graph_pool_bytes": eng._graphs.bytes()}
        if eng.tpot.count:
            tp = eng.tpot.report()
            r["tpot_ms"] = {"p50": tp["p50"] * 1e3, "p99": tp["p99"] * 1e3}
        big = eng._decode_fns[max(eng._decode_fns, key=lambda k: k[1])]
        with torch.inference_mode():
            r["replay_ms"] = _step_wall_ms(torch, big.replay)
            by_kernel = _device_us_by_kernel(torch, big.replay, calls=10)
            r["replay_device_ms"] = sum(us for us, _ in
                                        by_kernel.values()) / 1e3
            r["replay_attention_ms"] = sum(
                us for k, (us, _) in by_kernel.items()
                if any(w in k for w in ("ragged_kernel", "decode_kernel",
                                        "merge_kernel", "groups_kernel"))
            ) / 1e3
            if label.endswith("(a)"):
                # one soft-prefix prefill at the 2048 bucket (576 image
                # tokens and 300 of text, the null table): device ms, B1's
                # share of it
                fn = eng._prefill[("prefix", 2048, vcfg.n_patches)]
                dev = torch.device("cuda")
                args = (model, eng.cache.kv, torch.randint(
                    3, cfg.vocab_size, (1, 2048 - vcfg.n_patches),
                    device=dev, dtype=torch.int32),
                    torch.tensor([300], dtype=torch.int32, device=dev),
                    torch.zeros((1, eng.ecfg.blocks_per_seq),
                                dtype=torch.int32, device=dev))
                call = lambda: fn(*args, prefix=prefixes[0][None])  # noqa
                r["prefix_prefill_ms"] = ctx["timer"](call, reps=5)
                pk = _device_us_by_kernel(torch, call, calls=3)
                r["prefix_prefill_b1_ms"] = sum(
                    us for k, (us, _) in pk.items()
                    if "flash_kernel" in k) / 1e3
        del eng, big
        gc.collect()
        torch.cuda.empty_cache()
        # lock-step: the same tokens and logprob entries
        eng = _llava_engine(ctx, {**switches, "SHAI_ASYNC_DECODE": "0"})
        sync = _llava_drive(eng, reqs)
        r["sync_equal"] = ([(f.token_ids, f.logprobs) for f in fins]
                           == [(f.token_ids, f.logprobs) for f in sync[0]])
        r["sync_recompiles"] = eng.obs.recompiles
        r["sync_leaked"] = eng.cache.leaked_blocks
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        sc = _score(model, [p for p, _ in reqs], fins,
                    prefixes=[pre for _, pre in reqs])
        r["score"] = {k: sc[k] for k in ("b1", "plain", "tokens", "eps",
                                         "lp_err")}
        r["image_vs_text_equal"] = [fins[i].token_ids == fins[4 + i].token_ids
                                    for i in range(2)]
        runs[label] = (r, fins, counts, walk, expect, sync)
        row[label] = r
        ctx.setdefault("launches", {})[label] = counts
        log(f"{label}: " + json.dumps(r))
    # (c) an image row preempted and resumed: two rows of 576 + 300
    eng = _llava_engine(ctx, {}, num_blocks=LLAVA_PREEMPT_BLOCKS)
    preq = [(prompts[2], prefixes[1]), (prompts[2], prefixes[2])]
    pfins, pcounts, _, pwalk, pcalls = _llava_drive(eng, preq)
    psc = _score(model, [p for p, _ in preq], pfins,
                 prefixes=[pre for _, pre in preq])
    rc = {"preemptions": eng.obs.preemptions, "prefill_calls": pcalls,
          "recompiles": eng.obs.recompiles,
          "leaked_blocks": eng.cache.leaked_blocks,
          "score": {k: psc[k] for k in ("b1", "plain", "tokens")},
          "walk_equal": {k: pcounts[k] for k in pwalk} == pwalk}
    row["engine_llava (c)"] = rc
    log("engine_llava (c): " + json.dumps(rc))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (d) speculative decoding with soft-prefix rows: every row's decode
    # starts at its prefix length plus its text
    eng = _llava_engine(ctx, {}, spec=SPEC_K)
    sfins, scounts, sseconds, swalk, _ = _llava_drive(eng, reqs)
    ssc = _score(model, [p for p, _ in reqs], sfins,
                 prefixes=[pre for _, pre in reqs])
    gaps, noise = _partings(sfins, runs["engine_llava (a)"][1])
    vbig = eng._verify_fns[max(eng._verify_fns,
                               key=lambda k: (k[1], k[0]))]
    with torch.inference_mode():
        vwall = _step_wall_ms(torch, vbig.replay)
        vk = _device_us_by_kernel(torch, vbig.replay, calls=10)
    rd = {"seconds": sseconds, "launches": scounts, "walk": swalk,
          "spec": eng.spec.as_dict(), "warmed": eng.n_warm,
          "recompiles": eng.obs.recompiles,
          "leaked_blocks": eng.cache.leaked_blocks,
          "flushes": eng.obs.flush_reasons(),
          "b2_per_verify": sorted({g.launches.get("paged_decode_attention",
                                                  0)
                                   for g in eng._verify_fns.values()}),
          "verify_key": list(vbig.key), "verify_replay_ms": vwall,
          "verify_replay_device_ms": sum(us for us, _ in vk.values()) / 1e3,
          "verify_attention_ms": sum(
              us for k, (us, _) in vk.items()
              if "decode_kernel" in k or "merge_kernel" in k) / 1e3,
          "score": {k: ssc[k] for k in ("b1", "plain", "tokens")},
          "parting_gaps": gaps, "noise": noise,
          "tie_gap": max(TIE_GAP, NOISE_TIES * noise),
          "streams_equal_a": sum(a.token_ids == b.token_ids for a, b in
                                 zip(sfins, runs["engine_llava (a)"][1]))}
    if eng.tpot.count:
        tp = eng.tpot.report()
        rd["tpot_ms"] = {"p50": tp["p50"] * 1e3, "p99": tp["p99"] * 1e3}
    row["engine_llava (d)"] = rd
    ctx.setdefault("launches", {})["engine_llava (d)"] = scounts
    log("engine_llava (d): " + json.dumps(rd))
    del eng, vbig
    gc.collect()
    torch.cuda.empty_cache()
    ctx["engine_llava"] = row
    ra = runs["engine_llava (a)"][0]
    bad = []
    for label, (r, fins, counts, walk, expect, sync) in runs.items():
        bad += [f"{label}: {k}" for k, ok in (
            ("async == lock-step", r["sync_equal"]),
            ("walk", {k: counts[k] for k in walk} == walk),
            ("lock-step walk", {k: sync[1][k] for k in sync[3]} == sync[3]),
            ("the prefix prefill warmed alone",
             r["prefix_keys"] == [str(("prefix", 2048, vcfg.n_patches))]),
            ("0 recompiles", r["recompiles"] == r["sync_recompiles"] == 0),
            ("no leaked block", not (r["leaked_blocks"]
                                     or r["sync_leaked"])),
            ("image rows differ from text-only",
             not any(r["image_vs_text_equal"])),
            ("tokens by the plain scoring forward"
             if label.endswith("(a)") else
             "int8 KV: argmax hits within 10% of (a)",
             r["score"]["plain"][1] <= TIE_TOL if label.endswith("(a)")
             else r["score"]["plain"][0] >= 0.9 * ra["score"]["plain"][0]),
            ("logprobs", not label.endswith("(a)")
             or r["score"]["lp_err"] <= LP_TOL)) if not ok]
        try:
            _check_counters(label, counts, expect)
        except AssertionError as e:
            bad.append(str(e))
    bad += [f"engine_llava (c): {k}" for k, ok in (
        ("a preemption", rc["preemptions"] >= 1),
        ("re-admitted", rc["prefill_calls"] >= 3),
        ("0 recompiles", rc["recompiles"] == 0),
        ("no leaked block", rc["leaked_blocks"] == 0),
        ("walk", rc["walk_equal"]),
        ("tokens by the plain scoring forward",
         rc["score"]["plain"][1] <= TIE_TOL)) if not ok]
    bad += [f"engine_llava (d): {k}" for k, ok in (
        ("spec walk", {k: scounts[k] for k in swalk} == swalk),
        ("B2 a layer in each verify", rd["b2_per_verify"] == [cfg.n_layers]),
        ("verify steps", rd["spec"]["spec_verify_steps"] > 0),
        ("0 recompiles", rd["recompiles"] == 0),
        ("no leaked block", rd["leaked_blocks"] == 0),
        ("tokens by the plain scoring forward",
         ssc["plain"][1] <= TIE_TOL),
        ("spec by the tie rule", all(g < rd["tie_gap"] for g in gaps)))
        if not ok]
    try:
        _check_counters("engine_llava (d)", scounts,
                        {"flash_attention", "paged_decode_attention"})
    except AssertionError as e:
        bad.append(str(e))
    bad += [k for k, ok in (
        ("tower: B1 once a block run", row["tower_b1_launches"]
         == [vcfg.n_blocks]),) if not ok]
    if bad:
        raise AssertionError(f"engine_llava: failed {bad}")


# serve_llava: the directory's cut (full widths; the text model's depth cut
# so that the write stays short; the tower whole)
SERVE_LLAVA_TEXT_LAYERS = 8
SERVE_LLAVA_CONFIG = {"max_model_len": 2048, "block_size": 16,
                      "max_num_seqs": 8,
                      "context_encoding_buckets": [128, 512, 2048],
                      "max_new_tokens": 16}
#: the host's JPEG decode and bicubic resize are timed at 1080p (the best
#: of two) and at a 12-megapixel phone photo's size (once), under
#: ``jpeg.MAX_JPEG_PIXELS``
SERVE_LLAVA_PHOTOS = (((1080, 1920), 2), ((3024, 4032), 1))


def _time_jpeg_front_end(ctx):
    """Host ms of the JPEG decode (``imageio.decode_image``) and of the
    bicubic resize to 336 px, of a baseline and a progressive 4:2:0 JPEG
    (``_jpeg_bytes``, quality 90) at each of ``SERVE_LLAVA_PHOTOS``; the
    decode held near the image encoded (mean error under 10 levels: a
    wrong IDCT, table or colour transform is off by tens)."""
    import numpy as np
    from scalable_hw_agnostic_inference_tpu_torch.models import imageio

    row = {}
    for (h, w), reps in SERVE_LLAVA_PHOTOS:
        img = _llava_photo(h, w, seed=7)
        for name, kw in (("baseline", {}),
                         ("progressive", {"progressive": True})):
            row[f"{w}x{h} {name}"] = _time_jpeg(
                imageio, np, img, _jpeg_bytes(img, "4:2:0", 90, **kw), reps,
                f"{w}x{h} {name}")
    ctx["serve_llava_front_end"] = row
    log("serve_llava: JPEG front-end on the host: " + json.dumps(row))


def _time_jpeg(imageio, np, img, data, reps, name):
    """The best of ``reps`` decodes and resizes of one JPEG (host ms)."""
    dec, rsz = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = imageio.decode_image(data)
        t1 = time.perf_counter()
        imageio.resize_bicubic(got, 336, 336)
        dec.append((t1 - t0) * 1e3)
        rsz.append((time.perf_counter() - t1) * 1e3)
    err = float(np.abs(got.astype(np.int32) - img).mean())
    if got.shape != img.shape or err > 10.0:
        raise AssertionError(f"serve_llava: the {name} JPEG decoded to "
                             f"{got.shape}, mean error {err:.2f}")
    mp = img.shape[0] * img.shape[1] / 1e6
    return {"jpeg_mb": len(data) / 1e6, "decode_ms": min(dec),
            "decode_ms_all": dec, "decode_ms_per_mp": min(dec) / mp,
            "resize_ms": min(rsz), "mean_abs_err": err}


def _seeded_llava_dir(ctx):
    """A seeded LLaVA-1.5-7B directory in HF's layout (llava-1.5-7b-hf's
    own: ``language_model.model.*``, ``language_model.lm_head``,
    ``vision_tower.vision_model.*`` with CLIP's ``pre_layrnorm`` and
    ``post_layernorm``, ``multi_modal_projector.linear_{1,2}``) at full
    widths, the text depth cut to ``SERVE_LLAVA_TEXT_LAYERS``, in two
    shards; ``config.json`` in llava-1.5-7b-hf's sparse form (its
    ``text_config`` names 7 keys and the cut depth); the SentencePiece-
    style tokenizer (``_write_sp_tokenizer``) and llava-1.5's chat template
    as ``chat_template.jinja``."""
    import dataclasses
    import tempfile

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
        save_sharded,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models import vlm
    from scalable_hw_agnostic_inference_tpu_torch.models.convert import (
        hf_name,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        random_params,
    )

    cfg = dataclasses.replace(LlamaConfig.llava15_7b_text(),
                              n_layers=SERVE_LLAVA_TEXT_LAYERS)
    state = random_params(cfg, seed=9, std=0.02, device="cuda")
    tensors = {hf_name(k, "language_model.model.",
                       "language_model.lm_head.weight"): v
               for k, v in state.items()}
    vcfg = vlm.VisionTowerConfig()
    vstate = vlm.random_params(vcfg, seed=10, device="cuda")
    names = vlm.hf_names(vcfg, "vision_tower.vision_model",
                         "multi_modal_projector")
    tensors.update({names[k]: v for k, v in vstate.items()})
    for leaf, fill in (("weight", 1.0), ("bias", 0.0)):  # unused by LLaVA
        tensors[f"vision_tower.vision_model.post_layernorm.{leaf}"] = \
            torch.full((vcfg.dim,), fill, dtype=torch.bfloat16,
                       device="cuda")
    path = Path(tempfile.mkdtemp(prefix="shai-llava-")) / "llava-1.5-7b"
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlavaForConditionalGeneration"],
        "ignore_index": -100, "image_token_index": 32000,
        "model_type": "llava", "pad_token_id": 32001,
        "projector_hidden_act": "gelu",
        "text_config": {
            "_name_or_path": "lmsys/vicuna-7b-v1.5",
            "architectures": ["LlamaForCausalLM"],
            "max_position_embeddings": 4096, "model_type": "llama",
            "rms_norm_eps": 1e-05, "torch_dtype": "float16",
            "vocab_size": 32064,
            "num_hidden_layers": SERVE_LLAVA_TEXT_LAYERS},
        "tie_word_embeddings": False, "torch_dtype": "float16",
        "vision_config": {
            "hidden_size": 1024, "image_size": 336,
            "intermediate_size": 4096, "model_type": "clip_vision_model",
            "num_attention_heads": 16, "num_hidden_layers": 24,
            "patch_size": 14, "projection_dim": 768, "vocab_size": 32000},
        "vision_feature_layer": -2,
        "vision_feature_select_strategy": "default",
        "vocab_size": 32064}))
    paths = save_sharded(tensors, path, 2)
    _write_sp_tokenizer(path)
    (path / "chat_template.jinja").write_text(LLAVA15_TEMPLATE)
    del state, vstate, tensors
    gc.collect()
    torch.cuda.empty_cache()
    return path, sum(p.stat().st_size for p in paths)


#: serve_llava's rows: the image each sends (None: text-only)
SERVE_LLAVA_KINDS = ("png 400x300", "png 640x480", "jpeg 640x480 4:2:0",
                     "jpeg 400x300 4:2:0 progressive", "jpeg 400x300 4:4:4",
                     "random", None, None)


def _jpeg_over_cap() -> bytes:
    """A small baseline JPEG whose frame header says one row more than
    ``jpeg.MAX_JPEG_PIXELS`` allows (4096 x 4097): refused from the
    header."""
    import struct

    data = _jpeg_bytes(_llava_photo(16, 16, seed=13), "4:2:0", 90)
    at = data.index(b"\xff\xc0") + 5   # marker, length, precision
    return data[:at] + struct.pack(">HH", 4097, 4096) + data[at + 4:]


def phase_serve_llava(ctx):
    """The vllm unit on a seeded LLaVA directory (``_seeded_llava_dir``):
    8 concurrent ``POST /generate`` (2 PNGs of two sizes, a baseline and a
    progressive JPEG, a 4:4:4 JPEG, "random", and the first two prompts
    text-only), the 400s of a CMYK JPEG and of bytes that are no base64;
    B1 (the tower and the prefill) and B2 only, 0 recompiles, no leaked
    block, the image rows unlike their prompts text-only; the chat round
    under llava-1.5's template (``_chat_round``). First, the JPEG
    front-end's host ms at 1080p (``_time_jpeg_front_end``)."""
    import base64

    _drop_engine_model(ctx)
    _time_jpeg_front_end(ctx)
    t0 = time.monotonic()
    path, n_bytes = _seeded_llava_dir(ctx)
    write_s = time.monotonic() - t0
    small, big = _llava_photo(300, 400, seed=11), _llava_photo(seed=12)

    def b64(data):
        return base64.b64encode(data).decode()

    # SERVE_LLAVA_KINDS names each row's image
    images = [b64(_png_bytes(small)), b64(_png_bytes(big)),
              b64(_jpeg_bytes(big, "4:2:0", 90)),
              b64(_jpeg_bytes(small, "4:2:0", 85, progressive=True)),
              b64(_jpeg_bytes(small, "4:4:4", 90)), "random", None, None]
    prompts = [f"USER: <image>\nimage {i}: describe it in detail. "
               f"ASSISTANT:" for i in range(6)]
    prompts += prompts[:2]
    payloads = [{"prompt": p, "logprobs": 1} if im is None else
                {"prompt": p, "image_b64": im, "logprobs": 1}
                for p, im in zip(prompts, images)]
    config = str(path.parent / "vllm_config.json")
    with open(config, "w") as f:
        json.dump(SERVE_LLAVA_CONFIG, f)
    log(f"serve_llava: wrote {path} ({n_bytes / 1e9:.2f} GB) in "
        f"{write_s:.1f} s: text {SERVE_LLAVA_TEXT_LAYERS} layers, tower 24")

    def checks(base, eng):
        import torch
        from scalable_hw_agnostic_inference_tpu_torch.serve.units.common \
            import decode_image
        from scalable_hw_agnostic_inference_tpu_torch.utils.latency import (
            LatencyCollector,
        )

        svc = ctx["serving"]["service"]
        bad = {}
        for name, data in (("cmyk", base64.b64encode(_cmyk_jpeg()).decode()),
                           ("not base64", "@@ not base64 @@"),
                           ("over the JPEG cap", b64(_jpeg_over_cap()))):
            status, body = _http(base + "/generate", {
                "prompt": "x", "image_b64": data, "max_new_tokens": 4})
            bad[name] = (status, body.get("detail", body))
        # the host ms of this traffic's images through the unit's front end
        # (decode, bicubic resize to 336 px, normalization), the best of two
        front = {}
        for kind, im in zip(SERVE_LLAVA_KINDS, images):
            if im is None:
                continue
            ts = []
            for _ in range(2):
                t0 = time.perf_counter()
                decode_image({"image_b64": im}, 336)
                ts.append((time.perf_counter() - t0) * 1e3)
            front[kind] = min(ts)
        # the served tower's ms an image (zeros; the decode excluded)
        vcfg, tower = svc._vision
        x = torch.zeros((1, vcfg.image_size, vcfg.image_size, 3),
                        device="cuda")
        with torch.inference_mode():
            tower_ms = ctx["timer"](lambda: tower(x), reps=5)
        # the same prompts text-only: TTFT and TPOT with no image work on
        # the host, beside the image round's
        eng.ttft, eng.tpot = LatencyCollector(), LatencyCollector()
        res, wall = _send_concurrent(
            base, [{"prompt": p, "logprobs": 1} for p in prompts])
        if any(r is None or r[0] != 200 for r in res):
            raise AssertionError(f"serve_llava: the text-only round "
                                 f"failed: {res[:2]}")
        ttft, tpot = eng.ttft.report(), eng.tpot.report()
        # the largest decode graph's replay, with the engine idle (its
        # static inputs are the last step's: the same writes again)
        big = eng._decode_fns[max(eng._decode_fns, key=lambda k: k[1])]
        with torch.inference_mode():
            replay_ms = _step_wall_ms(torch, big.replay)
            by_kernel = _device_us_by_kernel(torch, big.replay, calls=10)
        row = {"bad_images": bad, "vision_warm_s": svc.vision_warm_seconds,
               "tower_ms": tower_ms, "front_end_ms": front,
               "text_only_round": {
                   "wall_s": wall,
                   "ttft_ms": {"p50": ttft["p50"] * 1e3,
                               "p99": ttft["p99"] * 1e3},
                   "tpot_ms": {"p50": tpot["p50"] * 1e3,
                               "p99": tpot["p99"] * 1e3}},
               "decode_replay": {
                   "key": list(big.key), "wall_ms": replay_ms,
                   "device_ms": sum(us for us, _ in by_kernel.values())
                   / 1e3,
                   "attention_ms": sum(
                       us for k, (us, _) in by_kernel.items()
                       if "decode_kernel" in k or "merge_kernel" in k)
                   / 1e3},
               "load_s": svc.load_seconds, "warm_s": svc.warm_seconds,
               "prefix_keys": sorted(str(k) for k in eng._prefill
                                     if k[0] == "prefix"),
               "tokenizer_sp": svc.tokenizer.sp is not None}
        row["chat"] = _chat_round(ctx, "serve_llava", base, svc, CHAT_PARTS)
        ctx["serve_llava_checks"] = row
        log("serve_llava: " + json.dumps(row))
        if bad["cmyk"][0] != 400 or "CMYK" not in json.dumps(bad["cmyk"]) \
                or bad["not base64"][0] != 400 \
                or bad["over the JPEG cap"][0] != 400 \
                or "pixel limit for JPEG" not in json.dumps(
                    bad["over the JPEG cap"]):
            raise AssertionError(f"serve_llava: bad images answered {bad}")
        if not row["tokenizer_sp"] or not row["prefix_keys"]:
            raise AssertionError(f"serve_llava: {row}")

    results = _serve(ctx, "serve_llava", {
        "MODEL_ID": str(path), "VLLM_CONFIG": config,
        "SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": ""},
        payloads, {"flash_attention", "paged_decode_attention"},
        "B2 paged_decode_attention", then=checks)
    toks = [r[1]["n_tokens"] for r in results]
    ids = [[e["token"] for e in r[1]["logprobs"]] for r in results]
    same = [ids[i] == ids[6 + i] for i in range(2)]
    log(f"serve_llava: tokens {toks}; image rows equal to their prompts "
        f"text-only: {same}")
    shutil.rmtree(path.parent, ignore_errors=True)
    if any(same) or any(t < 1 for t in toks):
        raise AssertionError(f"serve_llava: tokens {toks}, image rows "
                             f"equal to text-only {same}")


# -- Stable Diffusion 2.1 (A9) ---------------------------------------------------

#: the sd unit's defaults (reference utils/env.py): 512 x 512, 25 DDIM steps,
#: guidance 7.5; the 768 px run (stable-diffusion-2-1's native size,
#: v-prediction) at fewer steps
SD_SIZE, SD_STEPS, SD_GUIDANCE = 512, 25, 7.5
SD_768_STEPS = 10
#: the B1-against-plain run's steps
SD_CHECK_STEPS = 4
#: two images of one request that must agree (uint8 levels of 255, mean and
#: max of |a - b|): a run through B1 against the same run through B1's
#: plain version (fp32 softmax), and a request's image in a batch of 4
#: against its image alone (another UNet batch rounds its bf16 products in
#: another order). The CPU tests' bf16 bound for the same pipeline
#: (tests/test_torch_diffusion.py PIPE_BF16_*: the port against JAX at bf16
#: 2.1-3.2, 14-22 on random tiny weights) sets its size
SD_IMAGE_MEAN, SD_IMAGE_MAX = 4.0, 32
#: the text encoder's conditioning through B1 (q, k, v rounded to bf16)
#: against the fp32 plain forward on the CPU: max |a - b| over rms(b). The
#: bf16 rounding of q, k, v and of P over 23 layers: u = 2^-8 relative a
#: step, about 23 * 2u = 0.18 rms at most; 0.25 leaves room
SD_TEXT_RRMS = 0.25
#: B1 launches: one per attention of each of SD2.x's 16 transformer blocks
#: (self and cross) a UNet forward; one per layer a text encode
SD_UNET_B1, SD_TEXT_B1 = 32, 23
#: serve_sd's unit's SD_BATCH_MAX (its coalescing window is the unit's
#: own 20 ms: the round's client threads leave one barrier together)
SERVE_SD_BATCH = 4


def _sd_ids(torch, B: int, seed: int):
    """``(prompt ids, uncond ids)`` ``[B, 77]`` as SD2.1's tokenizer gives
    them: start 49406, 8 to 40 random ids, end 49407, then ``!`` (0) pads;
    the negative prompt empty."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((B, 77), dtype=torch.int64)
    un = torch.zeros((B, 77), dtype=torch.int64)
    for b in range(B):
        n = int(torch.randint(8, 41, (1,), generator=g))
        ids[b, 0], un[b, 0], un[b, 1] = 49406, 49406, 49407
        ids[b, 1:n + 1] = torch.randint(1, 49406, (n,), generator=g)
        ids[b, n + 1] = 49407
    return ids, un


def _sd_models(torch, variant, seed: int = 0):
    """SD2.1's text encoder (OpenCLIP-H, 23 layers, fp32), UNet (bf16) and
    VAE decoder (fp32 weights, bf16 compute) at full width and depth,
    seeded, built on the card."""
    from scalable_hw_agnostic_inference_tpu_torch.models import clip, unet, vae
    from scalable_hw_agnostic_inference_tpu_torch.models.encoder import (
        seeded_init_,
    )

    text = seeded_init_(clip.ClipTextEncoder(clip.ClipTextConfig(),
                                             device="cuda"), seed)
    un = seeded_init_(unet.UNet2DCondition(
        variant.unet, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        device="cuda"), seed + 1)
    va = seeded_init_(vae.AutoencoderKL(variant.vae, device="cuda",
                                        encoder=False), seed + 2)
    return text, un, va


def _image_diff(a, b):
    import numpy as np

    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return float(d.mean()), int(d.max())


def _check_image_pair(what: str, a, b) -> dict:
    mean, mx = _image_diff(a, b)
    if mean > SD_IMAGE_MEAN or mx > SD_IMAGE_MAX:
        raise AssertionError(f"{what}: images differ by mean {mean:.3f}, "
                             f"max {mx} levels (bound {SD_IMAGE_MEAN}, "
                             f"{SD_IMAGE_MAX})")
    return {"mean": mean, "max": mx}


def _sd_denoise_checked(torch, pipe, ids, un, lat, steps: int):
    """``txt2img_batch``'s work, step for step, also returning whether the
    final latents and the decoded float image are finite."""
    with torch.inference_mode():
        ctx2 = pipe._context(ids, un)
        out = pipe._denoise(lat, ctx2, steps, SD_GUIDANCE)
        img = pipe.vae.decode(out)
        finite = bool(torch.isfinite(out).all()) and bool(
            torch.isfinite(img).all())
        u8 = torch.round(torch.clamp(img * 127.5 + 127.5, 0.0, 255.0)).to(
            torch.uint8).cpu().numpy()
    return u8, finite


def phase_engine_sd(ctx):
    """SD2.1 at full width and depth (seeded), through
    ``models.sd.StableDiffusion``: 512 x 512, 25 DDIM steps, guidance 7.5,
    at batch 1 and 4; 768 x 768 under v-prediction at ``SD_768_STEPS``.
    B1 exactly 32 launches a UNet forward and 23 a text encode; a
    ``SD_CHECK_STEPS``-step run through B1 against the same run through
    B1's plain version; a request's image in a batch of 4 against its image
    alone; the same seed twice; the conditioning against the fp32 plain
    forward on the CPU. Prints ms per UNet step at UNet batch 2 and 8 (wall
    and device), text encode and VAE decode ms, images/s, peak bytes, and
    a profiled run's busy share and device time by class."""
    import numpy as np
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models import clip, sd

    _drop_engine_model(ctx)
    timer = ctx["timer"]
    variant = sd.SDVariant.sd21_base()
    t0 = time.monotonic()
    text, unet, vae = _sd_models(torch, variant)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    pipe = sd.StableDiffusion(variant, unet, vae, clip.encode_fn(text),
                              scheduler="ddim")
    f = pipe.vae_scale
    h = w = SD_SIZE // f
    ids4, un4 = _sd_ids(torch, 4, seed=1)
    ids1, un1 = ids4[:1], un4[:1]
    lat4 = torch.cat([pipe.init_latents(s, h, w, SD_STEPS)
                      for s in range(4)])
    lat1 = lat4[:1]
    kw = dict(height=SD_SIZE, width=SD_SIZE, steps=SD_STEPS,
              guidance_scale=SD_GUIDANCE)
    row = {"build_s": build_s,
           "params": {n: sum(p.numel() for p in m.parameters())
                      for n, m in (("text", text), ("unet", unet),
                                   ("vae", vae))}}
    # one run of each shape first (cuDNN's algorithm choice, the allocator)
    t0 = time.monotonic()
    for ids, un, lat in ((ids1, un1, lat1), (ids4, un4, lat4)):
        pipe.txt2img_batch(ids, un, lat, **dict(kw, steps=2))
    torch.cuda.synchronize()
    row["warm_s"] = time.monotonic() - t0

    # the main path: one image, then a batch of 4, launch-counted
    torch.cuda.reset_peak_memory_stats()
    expect = SD_TEXT_B1 + SD_UNET_B1 * SD_STEPS
    runs = {}
    for name, ids, un, lat in (("b1", ids1, un1, lat1),
                               ("b4", ids4, un4, lat4)):
        _reset_counters()
        t0 = time.perf_counter()
        img = pipe.txt2img_batch(ids, un, lat, **kw)
        wall = time.perf_counter() - t0
        counts = _read_counters()
        _check_counters(f"engine_sd {name}", counts, {"flash_attention"})
        if counts["flash_attention"] != expect:
            raise AssertionError(
                f"engine_sd {name}: B1 launched {counts['flash_attention']} "
                f"times, expected {SD_TEXT_B1} + {SD_UNET_B1} x {SD_STEPS}")
        if img.shape != (lat.shape[0], SD_SIZE, SD_SIZE, 3) or \
                img.dtype != np.uint8:
            raise AssertionError(f"engine_sd {name}: image {img.shape} "
                                 f"{img.dtype}")
        runs[name] = (img, wall, counts)
    ctx.setdefault("launches", {})["engine_sd"] = runs["b1"][2]
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    row["wall_s"] = {k: v[1] for k, v in runs.items()}
    row["images_per_s"] = {"b1": 1 / runs["b1"][1], "b4": 4 / runs["b4"][1]}
    row["b1_launches"] = runs["b1"][2]["flash_attention"]

    # per UNet forward and per text encode, counted apart
    with torch.inference_mode():
        _reset_counters()
        ctx2 = pipe._context(ids1, un1)
        torch.cuda.synchronize()
        n_text = _read_counters()["flash_attention"]
        _reset_counters()
        pair = torch.cat([lat1, lat1])
        tt = torch.full((2,), 981, dtype=torch.int32, device="cuda")
        unet(pair, tt, ctx2)
        torch.cuda.synchronize()
        n_unet = _read_counters()["flash_attention"]
    row["b1_per_text_encode"], row["b1_per_unet_forward"] = n_text, n_unet
    if (n_text, n_unet) != (SD_TEXT_B1, SD_UNET_B1):
        raise AssertionError(f"engine_sd: B1 {n_text} a text encode, "
                             f"{n_unet} a UNet forward; expected "
                             f"{SD_TEXT_B1}, {SD_UNET_B1}")

    # the same seed twice; a request in a batch of 4 against it alone
    again = pipe.txt2img_batch(ids1, un1, lat1, **kw)
    row["same_seed_equal"] = bool(np.array_equal(again, runs["b1"][0]))
    if not row["same_seed_equal"]:
        raise AssertionError(
            f"engine_sd: the same seed gave another image "
            f"({_image_diff(again, runs['b1'][0])})")
    row["batch4_vs_alone"] = _check_image_pair(
        "engine_sd: a request in a batch of 4 against it alone",
        runs["b4"][0][0], runs["b1"][0][0])

    # a short run through B1 against the same run through B1's plain
    # version (fp32 softmax), finite latents and image
    lat_c = pipe.init_latents(7, h, w, SD_CHECK_STEPS)
    got, finite = _sd_denoise_checked(torch, pipe, ids1, un1, lat_c,
                                      SD_CHECK_STEPS)
    with _plain_attention():
        _reset_counters()
        plain, finite_p = _sd_denoise_checked(torch, pipe, ids1, un1, lat_c,
                                              SD_CHECK_STEPS)
        if _read_counters()["flash_attention"]:
            raise AssertionError("engine_sd: the plain run launched B1")
    if not (finite and finite_p):
        raise AssertionError("engine_sd: non-finite latents or image")
    row["b1_vs_plain"] = _check_image_pair(
        f"engine_sd: {SD_CHECK_STEPS} steps through B1 against its plain "
        f"version", got, plain)

    # the conditioning through B1 against the fp32 plain forward (CPU)
    with torch.inference_mode():
        cond = pipe._context(ids1, un1).float()
        cpu = clip.build(text.cfg, {k: v.cpu() for k, v in
                                    text.state_dict().items()})
        ref = cpu(torch.cat([un1, ids1]))[0]
    dev = (cond.cpu() - ref).abs().max().item() / ref.pow(2).mean().sqrt(
    ).item()
    row["text_vs_fp32_plain_rrms"] = dev
    del cpu
    if not dev <= SD_TEXT_RRMS:
        raise AssertionError(f"engine_sd: the conditioning through B1 is "
                             f"{dev:.3f} rms from the fp32 plain forward "
                             f"(bound {SD_TEXT_RRMS})")

    # one UNet step (the pair through the UNet, guidance, DDIM update) at
    # UNet batch 2 and 8, wall and device; the text encode; the VAE decode
    ts, a_t, a_p = pipe.tables(SD_STEPS)
    steps = {}
    with torch.inference_mode():
        for name, ids, un, lat in (("unet_batch_2", ids1, un1, lat1),
                                   ("unet_batch_8", ids4, un4, lat4)):
            c2 = pipe._context(ids, un)
            one = pipe._make_step(lat.shape[0])

            def fn():
                return one(lat, ts[0], a_t[0], a_p[0], c2, SD_GUIDANCE)

            by_kernel = _device_us_by_kernel(torch, fn, calls=5)
            steps[name] = {
                "wall_ms": _step_wall_ms(torch, fn, reps=10),
                "device_ms": sum(us for us, _ in by_kernel.values()) / 1e3,
                "b1_ms": sum(us for k, (us, _) in by_kernel.items()
                             if "flash_kernel" in k) / 1e3}
        row["step"] = steps
        row["text_encode_ms"] = timer(lambda: pipe._context(ids1, un1),
                                      reps=5)
        z = lat1.clone()
        row["vae_decode_ms"] = {
            "b1": timer(lambda: pipe._decode_body(z), reps=5),
            "b4": timer(lambda: pipe._decode_body(lat4), reps=3)}
    img = runs["b1"][0][0]
    t0 = time.perf_counter()
    png = sd.to_png_base64(img)
    row["png_encode_ms"] = (time.perf_counter() - t0) * 1e3
    row["png_bytes"] = len(png) * 3 // 4

    # 768 x 768, v-prediction (stable-diffusion-2-1), the same weights
    v768 = sd.SDVariant.sd21()
    pipe768 = sd.StableDiffusion(v768, unet, vae, clip.encode_fn(text),
                                 scheduler="ddim")
    h7 = 768 // f
    lat7 = pipe768.init_latents(0, h7, h7, SD_768_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    img7 = pipe768.txt2img_batch(ids1, un1, lat7, height=768, width=768,
                                 steps=SD_768_STEPS,
                                 guidance_scale=SD_GUIDANCE)
    wall7 = time.perf_counter() - t0
    n7 = _read_counters()["flash_attention"]
    if img7.shape != (1, 768, 768, 3) or \
            n7 != SD_TEXT_B1 + SD_UNET_B1 * SD_768_STEPS:
        raise AssertionError(f"engine_sd 768: image {img7.shape}, B1 {n7}")
    peak7 = torch.cuda.max_memory_allocated()
    # the same short run through B1 and through its plain version, at the
    # 768 px shapes (9,216, 2,304, 576 and 144 tokens)
    got7, finite7 = _sd_denoise_checked(torch, pipe768, ids1, un1, lat7,
                                        SD_CHECK_STEPS)
    with _plain_attention():
        plain7, finite7p = _sd_denoise_checked(torch, pipe768, ids1, un1,
                                               lat7, SD_CHECK_STEPS)
    if not (finite7 and finite7p):
        raise AssertionError("engine_sd 768: non-finite latents or image")
    row["v768"] = {"steps": SD_768_STEPS, "wall_s": wall7, "b1_launches": n7,
                   "peak_bytes": peak7,
                   "b1_vs_plain": _check_image_pair(
                       f"engine_sd 768: {SD_CHECK_STEPS} steps through B1 "
                       f"against its plain version", got7, plain7)}
    del got7, plain7
    with torch.inference_mode():
        c2 = pipe768._context(ids1, un1)
        one = pipe768._make_step(1)
        t7, a7, p7 = pipe768.tables(SD_768_STEPS)
        row["v768"]["step_wall_ms"] = _step_wall_ms(
            torch, lambda: one(lat7, t7[0], a7[0], p7[0], c2, SD_GUIDANCE),
            reps=5)
    del pipe768, img7

    # the device's busy share and time by class over one batch-1 image
    row["profile"] = _profile(
        torch, lambda: pipe.txt2img_batch(ids1, un1, lat1, **kw),
        "(no paged walk)")
    ctx["engine_sd"] = row
    log("engine_sd: " + json.dumps(row))
    del pipe, text, unet, vae
    gc.collect()
    torch.cuda.empty_cache()


#: the synthetic CLIP vocabulary's corpus (serve_sd's tokenizer)
SD_CORPUS = ("a photo of an astronaut riding a horse on the moon, a "
             "painting of a red fox in the snow, trending on artstation, "
             "highly detailed, 4k, sharp focus, studio lighting, a cat "
             "sitting on a windowsill at sunset")


def _write_clip_tokenizer(path: Path, n_merges: int = 300) -> None:
    """A CLIP ``tokenizer/`` in SD2.1's layout: ``vocab.json`` (the 256
    byte characters, each again with ``</w>``, ``n_merges`` merges learnt
    on ``SD_CORPUS``, the start and end tokens at CLIP's ids 49406 and
    49407), ``merges.txt``, and SD2.1's configs (``!`` as the pad token in
    ``special_tokens_map.json``)."""
    import collections
    import re

    from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
        BYTE_TO_CHAR,
    )

    path.mkdir(parents=True, exist_ok=True)
    base = [BYTE_TO_CHAR[b] for b in sorted(BYTE_TO_CHAR)]
    vocab = base + [c + "</w>" for c in base]
    counts = collections.Counter()
    for word in re.findall(r"[a-z]+|\d|[^\w\s]+", SD_CORPUS):
        chars = [BYTE_TO_CHAR[b] for b in word.encode()]
        counts[tuple(chars[:-1] + [chars[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for word, n in counts.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        vocab.append(a + b)
        new = collections.Counter()
        for word, n in counts.items():
            out, i = [], 0
            while i < len(word):
                if word[i:i + 2] == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new[tuple(out)] += n
        counts = new
    ids = {t: i for i, t in enumerate(vocab)}
    ids.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    (path / "vocab.json").write_text(json.dumps(ids))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                     + "\n")
    tok = {"lstrip": False, "normalized": True, "rstrip": False,
           "single_word": False}
    (path / "tokenizer_config.json").write_text(json.dumps({
        "add_prefix_space": False, "do_lower_case": True,
        "bos_token": {"__type": "AddedToken", "content": "<|startoftext|>",
                      **tok},
        "eos_token": {"__type": "AddedToken", "content": "<|endoftext|>",
                      **tok},
        "unk_token": {"__type": "AddedToken", "content": "<|endoftext|>",
                      **tok},
        "errors": "replace", "model_max_length": 77,
        "pad_token": "<|endoftext|>", "tokenizer_class": "CLIPTokenizer"}))
    (path / "special_tokens_map.json").write_text(json.dumps({
        "bos_token": {"content": "<|startoftext|>", **tok},
        "eos_token": {"content": "<|endoftext|>", **tok},
        "unk_token": {"content": "<|endoftext|>", **tok},
        "pad_token": "!"}))


def _seeded_sd_dir(ctx):
    """A seeded directory in stabilityai/stable-diffusion-2-1-base's
    diffusers layout at full width and depth: ``unet/`` and
    ``text_encoder/`` in fp16 (the hub's fp16 variant's dtype), ``vae/`` in
    fp32, each ``diffusion_pytorch_model.safetensors`` or
    ``model.safetensors`` under diffusers' and HF's names, the checkpoint's
    ``config.json`` files, a DDIM ``scheduler/`` (epsilon), the synthetic
    CLIP ``tokenizer/`` and ``model_index.json``. Returns the path and the
    bytes written."""
    import tempfile

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
        save_safetensors,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models import (
        clip,
        sd,
        unet,
        vae,
    )

    variant = sd.SDVariant.sd21_base()
    text, un, va = _sd_models(torch, variant, seed=5)
    path = Path(tempfile.mkdtemp(prefix="shai-sd-")) / "sd-2-1-base"
    cnames = clip.hf_names(text.cfg)
    vnames = vae.diffusers_names(
        variant.vae, {"decoder.mid_block.attentions.0.to_q.weight"})
    comps = {
        "unet": ("diffusion_pytorch_model.safetensors", un,
                 unet.diffusers_name, torch.float16),
        "vae": ("diffusion_pytorch_model.safetensors", va,
                vnames.__getitem__, torch.float32),
        "text_encoder": ("model.safetensors", text, cnames.__getitem__,
                         torch.float16)}
    written = 0
    for comp, (fname, module, name, dtype) in comps.items():
        (path / comp).mkdir(parents=True)
        tensors = {}
        for k, t in module.state_dict().items():
            t = t.to(dtype)
            if comp == "vae" and k.startswith("post_quant") and t.ndim == 2:
                t = t[:, :, None, None]      # diffusers' 1x1 conv
            tensors[name(k)] = t
        save_safetensors(tensors, path / comp / fname)
        written += (path / comp / fname).stat().st_size
        del tensors
    # diffusers' configs of stable-diffusion-2-1-base (the keys the loaders
    # read, and the published geometry)
    (path / "unet" / "config.json").write_text(json.dumps({
        "_class_name": "UNet2DConditionModel", "act_fn": "silu",
        "attention_head_dim": [5, 10, 20, 20],
        "block_out_channels": [320, 640, 1280, 1280],
        "cross_attention_dim": 1024,
        "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
        "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
        "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
        "layers_per_block": 2, "norm_eps": 1e-05, "norm_num_groups": 32,
        "out_channels": 4, "sample_size": 64,
        "use_linear_projection": True}))
    (path / "vae" / "config.json").write_text(json.dumps({
        "_class_name": "AutoencoderKL", "act_fn": "silu",
        "block_out_channels": [128, 256, 512, 512], "in_channels": 3,
        "latent_channels": 4, "layers_per_block": 2, "norm_num_groups": 32,
        "out_channels": 3, "sample_size": 768, "scaling_factor": 0.18215}))
    (path / "text_encoder" / "config.json").write_text(json.dumps({
        "architectures": ["CLIPTextModel"], "hidden_act": "gelu",
        "hidden_size": 1024, "intermediate_size": 4096,
        "layer_norm_eps": 1e-05, "max_position_embeddings": 77,
        "model_type": "clip_text_model", "num_attention_heads": 16,
        "num_hidden_layers": 23, "projection_dim": 512,
        "torch_dtype": "float16", "vocab_size": 49408}))
    (path / "scheduler").mkdir()
    (path / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "DDIMScheduler", "beta_end": 0.012,
        "beta_schedule": "scaled_linear", "beta_start": 0.00085,
        "clip_sample": False, "num_train_timesteps": 1000,
        "prediction_type": "epsilon", "set_alpha_to_one": False,
        "steps_offset": 1}))
    (path / "model_index.json").write_text(json.dumps({
        "_class_name": "StableDiffusionPipeline",
        "scheduler": ["diffusers", "DDIMScheduler"],
        "text_encoder": ["transformers", "CLIPTextModel"],
        "tokenizer": ["transformers", "CLIPTokenizer"],
        "unet": ["diffusers", "UNet2DConditionModel"],
        "vae": ["diffusers", "AutoencoderKL"]}))
    _write_clip_tokenizer(path / "tokenizer")
    del text, un, va
    gc.collect()
    torch.cuda.empty_cache()
    return path, written


def _genimage_round(base: str, payloads):
    """Concurrent ``POST /genimage``, the client threads released from one
    barrier: ``([(status, body, seconds)], wall seconds)``."""
    out = [None] * len(payloads)
    go = threading.Barrier(len(payloads))

    def one(i):
        go.wait(timeout=60)
        t0 = time.perf_counter()
        status, body = _http(base + "/genimage", payloads[i], timeout=600)
        out[i] = (status, body, time.perf_counter() - t0)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return out, time.perf_counter() - t0


def phase_serve_sd(ctx):
    """The ``sd2`` unit on a seeded SD2.1-base directory written here
    (``_seeded_sd_dir``), ``SD_BATCH_MAX=4`` at 512 px and 25 DDIM steps,
    warmed before readiness (buckets 1, 2, 4): 4 concurrent ``POST
    /genimage`` coalesced into one batch-4 denoise (``/stats``'
    ``coalesced_*``), then a solo request, a 400 for a steps value outside
    the set, every PNG decoded back at 512 x 512; B1 exactly 23 + 32 x 25
    launches a batch, nothing else launched; latency p50 and p99,
    ``/metrics``, and a profiled second concurrent round's busy share."""
    import base64

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models import imageio
    from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
        ClipTokenizer,
    )

    _drop_engine_model(ctx)
    t0 = time.monotonic()
    path, n_bytes = _seeded_sd_dir(ctx)
    write_s = time.monotonic() - t0
    log(f"serve_sd: wrote {path} ({n_bytes / 1e9:.2f} GB) in {write_s:.1f} "
        f"s")
    env = {"DEVICE": "cuda", "MODEL_ID": str(path), "APP": "sd2",
           "SD_BATCH_MAX": str(SERVE_SD_BATCH),
           "NUM_INFERENCE_STEPS": str(SD_STEPS), "HEIGHT": str(SD_SIZE),
           "WIDTH": str(SD_SIZE), "GUIDANCE_SCALE": str(SD_GUIDANCE),
           "SCHEDULER": "ddim", "PORT": "0"}
    per_batch = SD_TEXT_B1 + SD_UNET_B1 * SD_STEPS
    with _env(env):
        from scalable_hw_agnostic_inference_tpu_torch.serve.app import (
            create_app,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import (
            Server,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
            MetricsPublisher,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.units import (
            UNITS,
        )
        from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
            ServeConfig,
        )

        cfg = ServeConfig.from_env()
        service = UNITS["sd2"](cfg)
        app = create_app(cfg, service, publisher=MetricsPublisher(
            cfg.app, cfg.nodepool, cfg.pod_name, stream=io.StringIO()))
        server = Server(app, host="127.0.0.1", port=0)
        host, port = server.start_background()
        base = f"http://{host}:{port}"
        try:
            t0 = time.monotonic()
            while True:
                status, body = _http(base + "/readiness")
                if status == 200:
                    break
                if status == 500 or time.monotonic() - t0 > 600:
                    raise AssertionError(f"serve_sd: not ready: {status} "
                                         f"{body}")
                time.sleep(0.25)
            ready_s = time.monotonic() - t0
            if not isinstance(service.tokenizer, ClipTokenizer) or \
                    service.pipe.unet.dtype != torch.bfloat16:
                raise AssertionError("serve_sd: the unit did not load the "
                                     "directory's tokenizer and bf16 UNet")
            prompts = ["a photo of an astronaut riding a horse on the moon",
                       "A painting of a red fox in the snow, trending!",
                       "a cat sitting on a windowsill at sunset, 4k",
                       "studio lighting, sharp focus, highly detailed"]
            payloads = [{"prompt": p, "seed": i}
                        for i, p in enumerate(prompts)]
            stats0 = _http(base + "/stats")[1]["service"]
            _reset_counters()
            res, wall = _genimage_round(base, payloads)
            counts = _read_counters()
            stats1 = _http(base + "/stats")[1]["service"]
            if any(r is None or r[0] != 200 for r in res):
                raise AssertionError(f"serve_sd: the concurrent round "
                                     f"failed: {[r and r[0] for r in res]}")
            batches = stats1["coalesced_batches"] - stats0[
                "coalesced_batches"]
            coalesced = stats1["coalesced_requests"] - stats0[
                "coalesced_requests"]
            _check_counters("serve_sd", counts, {"flash_attention"})
            if batches != 1 or coalesced != 4 or \
                    counts["flash_attention"] != per_batch:
                raise AssertionError(
                    f"serve_sd: 4 concurrent requests ran as {batches} "
                    f"batches of {coalesced} requests, B1 "
                    f"{counts['flash_attention']} launches (one batch: "
                    f"{per_batch})")
            ctx.setdefault("launches", {})["serve_sd"] = counts
            images = [imageio.decode_png(base64.b64decode(
                r[1]["image_b64"])) for r in res]
            # a solo request: its own batch of 1
            _reset_counters()
            solo = _genimage_round(base, payloads[:1])[0][0]
            solo_b1 = _read_counters()["flash_attention"]
            if solo[0] != 200 or solo_b1 != per_batch:
                raise AssertionError(f"serve_sd: solo {solo[0]}, B1 "
                                     f"{solo_b1}")
            solo_img = imageio.decode_png(base64.b64decode(
                solo[1]["image_b64"]))
            for img in images + [solo_img]:
                if img.shape != (SD_SIZE, SD_SIZE, 3):
                    raise AssertionError(f"serve_sd: image {img.shape}")
            in_batch_vs_alone = _check_image_pair(
                "serve_sd: a request in the batch of 4 against it alone",
                images[0], solo_img)
            bad = _http(base + "/genimage", {"prompt": "x", "steps": 3})
            if bad[0] != 400 or "STEPS_BUCKETS" not in json.dumps(bad[1]):
                raise AssertionError(f"serve_sd: steps=3 answered {bad}")
            metrics = urllib.request.urlopen(base + "/metrics",
                                             timeout=60).read().decode()
            families = ("shai_requests_total", "shai_request_latency_seconds",
                        "shai_service_coalesced_requests",
                        "shai_service_coalesce_occupancy")
            missing = [f for f in families if f not in metrics]
            if missing:
                raise AssertionError(f"serve_sd: /metrics lacks {missing}")
            lat = [r[2] for r in res] + [solo[2]]
            ids = service._tokenize(prompts[1])
            row = {"write_s": write_s, "written_bytes": n_bytes,
                   "ready_s": ready_s, "round_wall_s": wall,
                   "latency_s": {"p50": _pct(lat, 0.5),
                                 "p99": _pct(lat, 0.99), "solo": solo[2]},
                   "images_per_s": 4 / wall, "coalesced": {
                       "batches": batches, "requests": coalesced,
                       "occupancy": stats1["coalesce_occupancy"]},
                   "b1_launches": counts["flash_attention"],
                   "in_batch_vs_alone": in_batch_vs_alone,
                   "bad_steps": bad[0],
                   "prompt_ids": [int(x) for x in ids[0][:16]],
                   "metrics_families": list(families)}
            # the traced pass: the concurrent round again under the profiler
            row["profile"] = _profile(
                torch, lambda: _genimage_round(base, payloads),
                "(no paged walk)")
            ctx["serve_sd"] = row
            log("serve_sd: " + json.dumps(row))
        finally:
            server.stop()
            shutil.rmtree(path.parent, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()


# -- Flux (FLUX.1 schnell and dev) and the T5 embeddings unit -----------------

#: the deployment's FLUX.1-schnell (deploy/units/flux-tpu-deploy.yaml): 512
#: px, 4 steps, 256 T5 tokens; FLUX.1-dev's geometry at 1,024 px with 512
#: T5 tokens and the guidance embedding, 2 steps of it
FLUX_SIZE, FLUX_STEPS, FLUX_T5 = 512, 4, 256
FLUX_DEV_SIZE, FLUX_DEV_STEPS, FLUX_DEV_T5 = 1024, 2, 512
FLUX_GUIDANCE = 3.5
#: B1 launches: one per double and single block a transformer forward (19
#: + 38), one per CLIP-L layer a text encode (12)
FLUX_B1, FLUX_CLIP_B1 = 19 + 38, 12
#: serve_flux's directory: full widths, depth cut (double and single
#: blocks, T5 layers); its requests
SERVE_FLUX_DOUBLE, SERVE_FLUX_SINGLE, SERVE_FLUX_T5_LAYERS = 2, 4, 2
SERVE_FLUX_REQUESTS = 3
#: engine_flux (c): the 4-step 512 px image through B1 against the same
#: image through B1's plain version (fp32 softmax), uint8 levels of 255,
#: mean and max of |a - b|. Flux's own, set between the sound reading (B1:
#: 0.864 mean, 6 max on the H100) and its controls': the plain version
#: with the scores q.k rounded to 5 mantissa bits reads 0.948 / 7 (any
#: perturbation of the size of bf16's rounding reads about as B1 does
#: through 57 random-gated blocks), to 4 bits (3% an entry) 1.120 / 11
FLUX_IMAGE_MEAN, FLUX_IMAGE_MAX = 1.0, 9
#: (c)'s controls, by the mantissa bits of their scores: the first is
#: logged only, the second must fall outside the bounds, or they could not
#: tell that defect from rounding
FLUX_CONTROL_BITS = (5, 4)


def _flux_configs():
    """``(CLIP-L, the FLUX.1 VAE)``: openai/clip-vit-large-patch14's text
    tower (12 layers of 768, quick GELU) and the VAE of 16 latent channels
    without quant convs (scaling 0.3611, shift 0.1159)."""
    from scalable_hw_agnostic_inference_tpu_torch.models import clip, vae

    return (clip.ClipTextConfig(vocab_size=49408, max_position=77, dim=768,
                                n_layers=12, heads=12, mlp_dim=3072,
                                act="quick_gelu"),
            vae.VAEConfig(latent_channels=16, scaling_factor=0.3611,
                          shift_factor=0.1159, use_quant_conv=False))


def _flux_models(torch, fcfg, tcfg, seed: int = 0):
    """FLUX's four models seeded on the card: the transformer and T5 in
    bf16, CLIP-L fp32, the VAE decoder's weights fp32 (bf16 compute)."""
    from scalable_hw_agnostic_inference_tpu_torch.models import (
        clip,
        flux,
        t5,
        vae,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.encoder import (
        seeded_init_,
    )

    ccfg, vcfg = _flux_configs()
    model = flux.seeded(fcfg, seed, dtype=torch.bfloat16, device="cuda")
    t5m = seeded_init_(t5.T5Encoder(tcfg, dtype=torch.bfloat16,
                                    device="cuda"), seed + 1)
    clipm = seeded_init_(clip.ClipTextEncoder(ccfg, device="cuda"), seed + 2)
    va = seeded_init_(vae.AutoencoderKL(vcfg, device="cuda", encoder=False),
                      seed + 3)
    return model, t5m, clipm, va


def _flux_ids(torch, t5_len: int, seed: int):
    """``(T5 ids [1, t5_len], CLIP ids [1, 77])`` as the tokenizers give
    them: T5's 40 pieces, ``</s>`` (1), pads of 0; CLIP's start, 20 ids,
    end, end-token pads."""
    g = torch.Generator().manual_seed(seed)
    t5_ids = torch.zeros((1, t5_len), dtype=torch.int64)
    t5_ids[0, :40] = torch.randint(3, 32000, (40,), generator=g)
    t5_ids[0, 40] = 1
    clip_ids = torch.full((1, 77), 49407, dtype=torch.int64)
    clip_ids[0, 0] = 49406
    clip_ids[0, 1:21] = torch.randint(1, 49406, (20,), generator=g)
    return t5_ids.numpy(), clip_ids.numpy()


def _flux_checked(torch, pipe, t5_ids, clip_ids, lat, steps: int):
    """``txt2img``'s work on given latents, also returning whether the
    final latents and the decoded float image are finite."""
    with torch.inference_mode():
        txt, pooled = pipe.condition(t5_ids, clip_ids)
        out = pipe.denoise(lat, txt, pooled, steps, FLUX_GUIDANCE)
        img = pipe.vae.decode(out)
        finite = bool(torch.isfinite(out).all()) and bool(
            torch.isfinite(img).all())
        u8 = torch.round(torch.clamp(img * 127.5 + 127.5, 0.0, 255.0)).to(
            torch.uint8).cpu().numpy()
    return u8, finite


def _round_mantissa(torch, x, bits: int):
    """fp32 ``x`` rounded to nearest, ties to even, at ``bits`` mantissa
    bits (bf16 keeps 7)."""
    shift = 23 - bits
    i = x.contiguous().view(torch.int32)
    i = i + ((1 << (shift - 1)) - 1) + ((i >> shift) & 1)
    return (i & ~((1 << shift) - 1)).view(torch.float32)


@contextlib.contextmanager
def _coarse_scores_attention(bits: int):
    """Swap B1 for its plain version with the scores ``q.k * scale``
    rounded to ``bits`` mantissa bits before the softmax (fp32
    otherwise): a small defect that engine_flux (c)'s bounds must catch.
    Flux's and CLIP-L's attention only (MHA, no lengths)."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops import attention

    def flash(q, k, v, *, causal=False, scale=None, lengths=None):
        T, D, S = q.shape[1], q.shape[3], k.shape[1]
        if lengths is not None or k.shape[2] != q.shape[2]:
            raise ValueError("the coarse-score control takes MHA without "
                             "lengths")
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (
            D ** -0.5 if scale is None else scale)
        s = _round_mantissa(torch, s, bits)
        if causal:
            q_pos = torch.arange(T, device=q.device) + (S - T)
            s = s.masked_fill(q_pos[:, None] < torch.arange(
                S, device=q.device)[None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)

    saved = attention.flash_attention
    attention.flash_attention = flash
    try:
        yield
    finally:
        attention.flash_attention = saved


def _flux_step(torch, pipe, t5_ids, clip_ids, size: int, steps: int):
    """One denoise step's work at ``size`` px (the transformer and the
    Euler update), its launches of B1, wall ms and device ms with B1's
    share."""
    from scalable_hw_agnostic_inference_tpu_torch.models import flux

    h = w = size // pipe.vae_scale
    txt, pooled = pipe.condition(t5_ids, clip_ids)
    tok = flux.patchify(pipe.init_latents(0, 1, h, w))
    ts, sig, nxt = pipe.tables(steps, (h // 2) * (w // 2))
    ids = pipe.ids(1, txt.shape[1], h, w)

    def fn():
        with torch.inference_mode():
            return pipe.step(tok, txt, pooled, ts[0], sig[0], nxt[0],
                             FLUX_GUIDANCE, ids)

    _reset_counters()
    fn()
    torch.cuda.synchronize()
    launches = _read_counters()["flash_attention"]
    by_kernel = _device_us_by_kernel(torch, fn, calls=3)
    device_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    b1_ms = sum(us for k, (us, _) in by_kernel.items()
                if "flash_kernel" in k) / 1e3
    return {"tokens": txt.shape[1] + (h // 2) * (w // 2),
            "b1_launches": launches,
            "wall_ms": _step_wall_ms(torch, fn, reps=5),
            "device_ms": device_ms, "b1_ms": b1_ms,
            "b1_share": b1_ms / device_ms if device_ms else None}


def phase_engine_flux(ctx):
    """FLUX.1 at full width and depth (19 + 38 blocks, T5-XXL's 24
    layers, CLIP-L, the FLUX VAE), seeded on the card, through
    ``models.flux_pipeline.FluxPipeline``: (a) schnell at 512 px, 4 steps,
    256 T5 tokens: one image's wall and device time, the text encode, one
    step and the VAE decode, peak bytes, B1 exactly 12 + 57 x 4 launches
    (57 a transformer forward) and its share of a step's device time; (b)
    the dev geometry (the guidance embedder added over the same blocks) at
    1,024 px with 512 T5 tokens, 2 steps, a step's wall and device time and
    B1's share; (c) the 4-step 512 px image through B1 against the same
    image through B1's plain version (``FLUX_IMAGE_*``), and a control
    with coarse scores that must fall outside those bounds; (d) the same seed
    twice, bit for bit; (e) finite latents and image. Starts from what the
    earlier phases left allocated, and says how much."""
    import dataclasses

    import numpy as np
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models import (
        clip,
        flux,
        t5,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.flow_match import (
        FlowMatchConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.flux_pipeline import (
        FluxPipeline,
    )

    _drop_engine_model(ctx)
    timer = ctx["timer"]
    left = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    model, t5m, clipm, va = _flux_models(
        torch, flux.FluxConfig.flux_schnell(), t5.T5Config.t5_v1_1_xxl())
    torch.cuda.synchronize()
    row = {"left_allocated_bytes": left, "build_s": time.monotonic() - t0,
           "weights_bytes": torch.cuda.memory_allocated() - left,
           "params": {n: sum(p.numel() for p in m.parameters())
                      for n, m in (("transformer", model), ("t5", t5m),
                                   ("clip", clipm), ("vae", va))}}
    pipe = FluxPipeline(model, va, t5.encode_fn(t5m), clip.pooled_fn(clipm),
                        schedule=FlowMatchConfig(use_dynamic_shifting=False,
                                                 shift=1.0))
    t5_ids, clip_ids = _flux_ids(torch, FLUX_T5, seed=1)
    kw = dict(height=FLUX_SIZE, width=FLUX_SIZE, steps=FLUX_STEPS,
              guidance=FLUX_GUIDANCE)
    t0 = time.monotonic()
    pipe.txt2img(t5_ids, clip_ids, rng=0, **dict(kw, steps=1))
    torch.cuda.synchronize()
    row["warm_s"] = time.monotonic() - t0

    # (a) the main path: one schnell image, launch-counted
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    img = pipe.txt2img(t5_ids, clip_ids, rng=0, **kw)
    wall = time.perf_counter() - t0
    counts = _read_counters()
    _check_counters("engine_flux (a)", counts, {"flash_attention"})
    expect = FLUX_CLIP_B1 + FLUX_B1 * FLUX_STEPS
    if counts["flash_attention"] != expect:
        raise AssertionError(
            f"engine_flux (a): B1 launched {counts['flash_attention']} "
            f"times, expected {FLUX_CLIP_B1} + {FLUX_B1} x {FLUX_STEPS}")
    if img.shape != (1, FLUX_SIZE, FLUX_SIZE, 3) or img.dtype != np.uint8:
        raise AssertionError(f"engine_flux (a): image {img.shape} "
                             f"{img.dtype}")
    ctx.setdefault("launches", {})["engine_flux"] = counts
    row["a"] = {"wall_s": wall, "b1_launches": counts["flash_attention"],
                "peak_bytes": torch.cuda.max_memory_allocated()}
    dev_ms, n_launch = _device_step(
        torch, lambda: pipe.txt2img(t5_ids, clip_ids, rng=0, **kw), calls=1)
    row["a"]["device_ms"], row["a"]["device_launches"] = dev_ms, n_launch
    step = _flux_step(torch, pipe, t5_ids, clip_ids, FLUX_SIZE, FLUX_STEPS)
    if step["b1_launches"] != FLUX_B1:
        raise AssertionError(f"engine_flux (a): a step launched B1 "
                             f"{step['b1_launches']} times, expected "
                             f"{FLUX_B1}")
    row["a"]["step"] = step
    row["a"]["text_encode_ms"] = timer(
        lambda: pipe.condition(t5_ids, clip_ids), reps=5)
    h = w = FLUX_SIZE // pipe.vae_scale
    z = pipe.init_latents(3, 1, h, w)
    row["a"]["vae_decode_ms"] = timer(lambda: pipe.vae.decode_uint8(z),
                                      reps=5)
    t0 = time.perf_counter()
    from scalable_hw_agnostic_inference_tpu_torch.models import sd

    png = sd.to_png_base64(img[0])
    row["a"]["png_encode_ms"] = (time.perf_counter() - t0) * 1e3
    row["a"]["png_bytes"] = len(png) * 3 // 4

    # (d) the same seed twice
    again = pipe.txt2img(t5_ids, clip_ids, rng=0, **kw)
    row["same_seed_equal"] = bool(np.array_equal(again, img))
    if not row["same_seed_equal"]:
        raise AssertionError(f"engine_flux (d): the same seed gave another "
                             f"image ({_image_diff(again, img)})")

    # (c), (e) the 4-step image through B1 against B1's plain version
    lat = pipe.init_latents(7, 1, h, w)
    got, finite = _flux_checked(torch, pipe, t5_ids, clip_ids, lat,
                                FLUX_STEPS)
    with _plain_attention():
        _reset_counters()
        plain, finite_p = _flux_checked(torch, pipe, t5_ids, clip_ids, lat,
                                        FLUX_STEPS)
        if _read_counters()["flash_attention"]:
            raise AssertionError("engine_flux (c): the plain run launched "
                                 "B1")
    row["finite"] = finite and finite_p
    if not row["finite"]:
        raise AssertionError("engine_flux (e): non-finite latents or image")
    mean, mx = _image_diff(got, plain)
    row["b1_vs_plain"] = {"mean": mean, "max": mx}
    row["controls_vs_plain"] = {}
    for bits in FLUX_CONTROL_BITS:
        with _coarse_scores_attention(bits):
            control, _ = _flux_checked(torch, pipe, t5_ids, clip_ids, lat,
                                       FLUX_STEPS)
        c_mean, c_max = _image_diff(control, plain)
        row["controls_vs_plain"][bits] = {"mean": c_mean, "max": c_max}
    log("engine_flux (c): " + json.dumps({k: row[k] for k in (
        "b1_vs_plain", "controls_vs_plain")}))
    if mean > FLUX_IMAGE_MEAN or mx > FLUX_IMAGE_MAX:
        raise AssertionError(
            f"engine_flux (c): {FLUX_STEPS} steps through B1 against its "
            f"plain version differ by mean {mean:.3f}, max {mx} levels "
            f"(bound {FLUX_IMAGE_MEAN}, {FLUX_IMAGE_MAX})")
    ctl = row["controls_vs_plain"][FLUX_CONTROL_BITS[-1]]
    if ctl["mean"] <= FLUX_IMAGE_MEAN and ctl["max"] <= FLUX_IMAGE_MAX:
        raise AssertionError(
            f"engine_flux (c): the control (scores at "
            f"{FLUX_CONTROL_BITS[-1]} mantissa bits) differs by "
            f"{ctl}, within the bounds ({FLUX_IMAGE_MEAN}, "
            f"{FLUX_IMAGE_MAX})")
    row["image_std"] = float(np.asarray(got, np.float32).std())
    del got, plain, control

    # (b) FLUX.1-dev's geometry: the guidance embedder over the same blocks
    dcfg = flux.FluxConfig.flux_dev()
    gin = flux.seeded(dataclasses.replace(dcfg, n_double=0, n_single=0), 9,
                      dtype=torch.bfloat16, device="cuda").guidance_in
    devm = flux.build(dcfg, {**model.state_dict(), **{
        f"guidance_in.{k}": v for k, v in gin.state_dict().items()}})
    dpipe = FluxPipeline(devm, va, t5.encode_fn(t5m), clip.pooled_fn(clipm),
                         schedule=FlowMatchConfig())
    t5d, _ = _flux_ids(torch, FLUX_DEV_T5, seed=2)
    dkw = dict(height=FLUX_DEV_SIZE, width=FLUX_DEV_SIZE,
               steps=FLUX_DEV_STEPS, guidance=FLUX_GUIDANCE)
    dpipe.txt2img(t5d, clip_ids, rng=0, **dict(dkw, steps=1))
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    dimg = dpipe.txt2img(t5d, clip_ids, rng=0, **dkw)
    dwall = time.perf_counter() - t0
    nd = _read_counters()["flash_attention"]
    dh = FLUX_DEV_SIZE // dpipe.vae_scale
    _, dfinite = _flux_checked(torch, dpipe, t5d, clip_ids,
                               dpipe.init_latents(0, 1, dh, dh),
                               FLUX_DEV_STEPS)
    if dimg.shape != (1, FLUX_DEV_SIZE, FLUX_DEV_SIZE, 3) or \
            nd != FLUX_CLIP_B1 + FLUX_B1 * FLUX_DEV_STEPS or not dfinite:
        raise AssertionError(f"engine_flux (b): image {dimg.shape}, B1 {nd}, "
                             f"finite latents and image {dfinite}")
    row["b"] = {"wall_s": dwall, "b1_launches": nd,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "step": _flux_step(torch, dpipe, t5d, clip_ids,
                                   FLUX_DEV_SIZE, FLUX_DEV_STEPS)}
    del dpipe, devm, gin

    # the device's busy share and time by class over one schnell image
    row["profile"] = _profile(
        torch, lambda: pipe.txt2img(t5_ids, clip_ids, rng=0, **kw),
        "(no paged walk)")
    ctx["engine_flux"] = row
    log("engine_flux: " + json.dumps(row))
    del pipe, model, t5m, clipm, va
    gc.collect()
    torch.cuda.empty_cache()


#: the synthetic Unigram vocabulary's corpus (serve_flux's T5 tokenizer)
FLUX_CORPUS = (SD_CORPUS + " a watercolor fox in a misty forest at dawn, "
               "cinematic, 35mm photo, a red apple on a wooden table")


def _write_t5_tokenizer(path: Path, extra_ids: int = 100) -> None:
    """A T5 ``tokenizer/`` in the layout ``transformers`` converts T5's to:
    a Unigram ``tokenizer.json`` (``<pad>``, ``</s>``, ``<unk>`` at 0 to 2,
    "▁", every character of ``FLUX_CORPUS``, each word with "▁" and its
    prefixes and suffixes, scored by length; ``<extra_id_N>`` appended in
    reverse), the normalizer ``Strip`` then ``Replace(" {2,}", "▁")``,
    ``Metaspace``, the template ``$A </s>``, and its config."""
    import re

    words = sorted(set(re.findall(r"[a-z0-9]+", FLUX_CORPUS.lower())))
    pieces = {"▁": -3.0}
    for c in sorted(set(FLUX_CORPUS) - {" "}):
        pieces.setdefault(c, -9.0)
    for word in words:
        pieces.setdefault("▁" + word, -2.0 - 0.1 * len(word))
        for i in range(1, len(word)):
            pieces.setdefault("▁" + word[:i], -6.0 + 0.2 * i)
            pieces.setdefault(word[i:], -7.0 + 0.2 * (len(word) - i))
    specials = ["<pad>", "</s>", "<unk>"]
    vocab = [[t, 0.0] for t in specials] + [[p, s] for p, s in
                                              pieces.items()]
    extra = [f"<extra_id_{i}>" for i in range(extra_ids - 1, -1, -1)]
    vocab += [[t, 0.0] for t in extra]
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, (t, _) in enumerate(vocab) if t in specials or t in extra]
    meta = {"type": "Metaspace", "replacement": "▁",
            "prepend_scheme": "always", "split": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": "▁"}]},
        "pre_tokenizer": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                        "tokens": ["</s>"]}}},
        "decoder": meta,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab,
                  "byte_fallback": False}}
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>",
        "extra_ids": extra_ids, "model_max_length": 512,
        "tokenizer_class": "T5Tokenizer"}))


def _seeded_flux_dir(ctx):
    """A seeded directory in black-forest-labs/FLUX.1-schnell's layout at
    full width, depth cut (``SERVE_FLUX_*``): the BFL single file
    ``flux1-schnell.safetensors`` (bf16), ``text_encoder_2/`` (T5-XXL's
    widths, bf16), ``text_encoder/`` (CLIP-L, fp16), ``vae/`` (the decoder,
    fp32), their ``config.json`` files, the schnell
    ``scheduler_config.json``, the synthetic Unigram ``tokenizer_2/`` and
    CLIP ``tokenizer/``. Returns the path and the bytes written."""
    import dataclasses
    import tempfile

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
        save_safetensors,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models import (
        clip,
        flux,
        t5,
        vae,
    )

    fcfg = dataclasses.replace(flux.FluxConfig.flux_schnell(),
                               n_double=SERVE_FLUX_DOUBLE,
                               n_single=SERVE_FLUX_SINGLE)
    tcfg = dataclasses.replace(t5.T5Config.t5_v1_1_xxl(),
                               n_layers=SERVE_FLUX_T5_LAYERS)
    model, t5m, clipm, va = _flux_models(torch, fcfg, tcfg, seed=5)
    path = Path(tempfile.mkdtemp(prefix="shai-flux-")) / "flux-1-schnell"
    ccfg, vcfg = _flux_configs()
    vnames = vae.diffusers_names(
        vcfg, {"decoder.mid_block.attentions.0.to_q.weight"})
    files = {
        "flux1-schnell.safetensors": (model, flux.bfl_names(fcfg),
                                      torch.bfloat16),
        "text_encoder_2/model.safetensors": (
            t5m, t5.hf_names(tcfg, {"shared.weight", "encoder."}),
            torch.bfloat16),
        "text_encoder/model.safetensors": (clipm, clip.hf_names(ccfg),
                                           torch.float16),
        "vae/diffusion_pytorch_model.safetensors": (va, vnames,
                                                    torch.float32)}
    written = 0
    for fname, (module, names, dtype) in files.items():
        (path / fname).parent.mkdir(parents=True, exist_ok=True)
        save_safetensors({names[k]: t.to(dtype) for k, t in
                          module.state_dict().items()}, path / fname)
        written += (path / fname).stat().st_size
    # the published configs' keys that the loaders read
    (path / "text_encoder_2" / "config.json").write_text(json.dumps({
        "architectures": ["T5EncoderModel"], "d_ff": 10240, "d_kv": 64,
        "d_model": 4096, "feed_forward_proj": "gated-gelu",
        "layer_norm_epsilon": 1e-06, "num_heads": 64,
        "num_layers": SERVE_FLUX_T5_LAYERS,
        "relative_attention_max_distance": 128,
        "relative_attention_num_buckets": 32, "vocab_size": 32128}))
    (path / "text_encoder" / "config.json").write_text(json.dumps({
        "architectures": ["CLIPTextModel"], "hidden_act": "quick_gelu",
        "hidden_size": 768, "intermediate_size": 3072,
        "layer_norm_eps": 1e-05, "max_position_embeddings": 77,
        "num_attention_heads": 12, "num_hidden_layers": 12,
        "vocab_size": 49408}))
    (path / "vae" / "config.json").write_text(json.dumps({
        "_class_name": "AutoencoderKL", "block_out_channels":
        [128, 256, 512, 512], "latent_channels": 16, "layers_per_block": 2,
        "norm_num_groups": 32, "scaling_factor": 0.3611,
        "shift_factor": 0.1159, "use_post_quant_conv": False,
        "use_quant_conv": False}))
    (path / "scheduler").mkdir()
    (path / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "FlowMatchEulerDiscreteScheduler",
        "base_image_seq_len": 256, "base_shift": 0.5,
        "max_image_seq_len": 4096, "max_shift": 1.15,
        "num_train_timesteps": 1000, "shift": 1.0,
        "use_dynamic_shifting": False}))
    (path / "model_index.json").write_text(json.dumps({
        "_class_name": "FluxPipeline",
        "scheduler": ["diffusers", "FlowMatchEulerDiscreteScheduler"],
        "text_encoder": ["transformers", "CLIPTextModel"],
        "text_encoder_2": ["transformers", "T5EncoderModel"],
        "tokenizer": ["transformers", "CLIPTokenizer"],
        "tokenizer_2": ["transformers", "T5TokenizerFast"],
        "transformer": ["diffusers", "FluxTransformer2DModel"],
        "vae": ["diffusers", "AutoencoderKL"]}))
    _write_t5_tokenizer(path / "tokenizer_2")
    # a T5 directory holds its own tokenizer.json, as the t5 unit reads it
    _write_t5_tokenizer(path / "text_encoder_2")
    _write_clip_tokenizer(path / "tokenizer")
    del model, t5m, clipm, va
    gc.collect()
    torch.cuda.empty_cache()
    return path, written


@contextlib.contextmanager
def _unit_up(name: str, env):
    """The unit ``name`` under ``env`` behind the stdlib server, ready,
    for the block: ``(service, base URL, ready seconds)``."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import (
        create_app,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
    from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
        MetricsPublisher,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    with _env(env):
        cfg = ServeConfig.from_env()
        service = UNITS[name](cfg)
        app = create_app(cfg, service, publisher=MetricsPublisher(
            cfg.app, cfg.nodepool, cfg.pod_name, stream=io.StringIO()))
        server = Server(app, host="127.0.0.1", port=0)
        host, port = server.start_background()
        base = f"http://{host}:{port}"
        try:
            t0 = time.monotonic()
            while True:
                status, body = _http(base + "/readiness")
                if status == 200:
                    break
                if status == 500 or time.monotonic() - t0 > 600:
                    raise AssertionError(f"{name}: not ready: {status} "
                                         f"{body}")
                time.sleep(0.25)
            yield service, base, time.monotonic() - t0
        finally:
            server.stop()


def phase_serve_flux(ctx):
    """The ``flux`` unit on a seeded FLUX.1-schnell directory written here
    (``_seeded_flux_dir``: the BFL single file, full widths, 2 + 4 blocks,
    T5 at 2 layers), ``SUBMESH=0:1``, 512 px, 4 steps: a few ``POST
    /genimage`` (``SERVE_FLUX_REQUESTS``; PNGs decoded back at 512 x 512),
    a 400 for a steps value outside the set, no shape first run after
    warmup;
    B1 exactly (12 + 6 x 4) launches a request and nothing else launched.
    Then the ``t5`` unit on the directory's ``text_encoder_2/`` (the
    Unigram ``tokenizer.json`` written there too): ``/embed`` of 4096 finite values, the
    400 for a request without text, no kernel launched. Ready seconds and
    latency p50 of each."""
    import base64

    import numpy as np
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models import imageio
    from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
        UnigramTokenizer,
    )

    _drop_engine_model(ctx)
    t0 = time.monotonic()
    path, n_bytes = _seeded_flux_dir(ctx)
    write_s = time.monotonic() - t0
    # kept for tp_diffusion; main() removes it after the phases
    ctx["seeded_flux"] = path
    log(f"serve_flux: wrote {path} ({n_bytes / 1e9:.2f} GB) in "
        f"{write_s:.1f} s")
    layers = SERVE_FLUX_DOUBLE + SERVE_FLUX_SINGLE
    per_request = FLUX_CLIP_B1 + layers * FLUX_STEPS
    prompts = ["a watercolor fox in a misty forest at dawn",
               "A red apple on a wooden table, 35mm photo",
               "a photo of an astronaut riding a horse on the moon"]
    row = {"write_s": write_s, "written_bytes": n_bytes}
    try:
        with _unit_up("flux", {
                "DEVICE": "cuda", "MODEL_ID": str(path), "APP": "flux",
                "SUBMESH": "0:1", "NUM_INFERENCE_STEPS": str(FLUX_STEPS),
                "HEIGHT": str(FLUX_SIZE), "WIDTH": str(FLUX_SIZE),
                "PORT": "0"}) as (service, base, ready_s):
            pipe = service.pipe
            if not isinstance(service.t5_tok, UnigramTokenizer) or \
                    service.t5_len != FLUX_T5 or \
                    pipe.model.cfg.guidance_embed or \
                    pipe.model.cfg.n_single != SERVE_FLUX_SINGLE:
                raise AssertionError("serve_flux: the unit did not load the "
                                     "schnell directory as written")
            lat = []
            _reset_counters()
            for i, p in enumerate(prompts[:SERVE_FLUX_REQUESTS]):
                t1 = time.perf_counter()
                status, body = _http(base + "/genimage",
                                     {"prompt": p, "seed": i}, timeout=600)
                lat.append(time.perf_counter() - t1)
                if status != 200:
                    raise AssertionError(f"serve_flux: {status} {body}")
                img = imageio.decode_png(base64.b64decode(body["image_b64"]))
                if img.shape != (FLUX_SIZE, FLUX_SIZE, 3):
                    raise AssertionError(f"serve_flux: image {img.shape}")
            counts = _read_counters()
            _check_counters("serve_flux", counts, {"flash_attention"})
            want = per_request * SERVE_FLUX_REQUESTS
            if counts["flash_attention"] != want:
                raise AssertionError(
                    f"serve_flux: B1 {counts['flash_attention']} launches, "
                    f"expected ({FLUX_CLIP_B1} + {layers} x {FLUX_STEPS}) x "
                    f"{SERVE_FLUX_REQUESTS}")
            ctx.setdefault("launches", {})["serve_flux"] = counts
            bad = _http(base + "/genimage", {"prompt": "x", "steps": 3})
            if bad[0] != 400 or "STEPS_BUCKETS" not in json.dumps(bad[1]):
                raise AssertionError(f"serve_flux: steps=3 answered {bad}")
            if service.recompiles():
                raise AssertionError(f"serve_flux: {service.recompiles()} "
                                     f"shapes first run after warmup")
            row["flux"] = {
                "ready_s": ready_s, "latency_s": {
                    "p50": _pct(lat, 0.5), "max": max(lat)},
                "b1_launches": counts["flash_attention"],
                "bad_steps": bad[0], "recompiles": service.recompiles(),
                "t5_ids": [int(x) for x in service.t5_tok.encode(
                    prompts[1])[:16]]}
            del service, pipe
        gc.collect()
        torch.cuda.empty_cache()

        with _unit_up("t5", {
                "DEVICE": "cuda", "MODEL_ID": str(path / "text_encoder_2"),
                "APP": "t5", "SUBMESH": "0:1", "PORT": "0"}) as (
                service, base, ready_s):
            lat = []
            _reset_counters()
            for p in prompts:
                t1 = time.perf_counter()
                status, body = _http(base + "/embed", {"text": p})
                lat.append(time.perf_counter() - t1)
                if status != 200 or body["dim"] != 4096 or not np.isfinite(
                        body["embedding"]).all():
                    raise AssertionError(f"serve_flux t5: {status} "
                                         f"{str(body)[:200]}")
            counts = _read_counters()
            _check_counters("serve_flux t5", counts, set())
            bad = _http(base + "/embed", {})
            if bad[0] != 400:
                raise AssertionError(f"serve_flux t5: no text answered "
                                     f"{bad}")
            row["t5"] = {"ready_s": ready_s, "seq": service.seq,
                         "latency_s": {"p50": _pct(lat, 0.5),
                                       "max": max(lat)},
                         "launches": sum(counts.values()),
                         "missing_text": bad[0]}
            del service
        ctx["serve_flux"] = row
        log("serve_flux: " + json.dumps(row))
    finally:
        gc.collect()
        torch.cuda.empty_cache()


# -- serve_encoders ----------------------------------------------------------

#: the bert unit's texts (the second and third past a few words; none
#: near the 512-token pad length)
ENCODER_TEXTS = ("i love this framework",
                 "The plot was slow, the acting wooden; I left early.",
                 "Café déjà vu 日本語 numbers 12345 and a ☃ snowman!")
#: B1 against its plain version through a whole encoder: the relative rms
#: distance of the encoder's output (all rows) is held to this bound. Each
#: block's attention moves by bf16 rounding (B1 rounds P and its output to
#: bf16, about 2^-9 relative), which the bf16 dense layers and the
#: residual stream carry through 6 to 12 blocks; 0.05 is some 5x the
#: largest share that predicts. A wrong mask or a lost key tile moves the
#: output by tens of percent: bert's control (its plain version with each
#: row's key length cut by one) must fall outside the bound
ENCODER_RRMS = 0.05


def _wordpiece_vocab(n: int):
    """A synthetic WordPiece vocabulary of exactly ``n`` entries: the BERT
    special tokens first, then lowercase letters, digits and ASCII
    punctuation with their ``##`` forms, then two- and three-letter pieces
    and their ``##`` forms, in order, until ``n``."""
    import itertools
    import string

    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    singles = list(string.ascii_lowercase + string.digits
                   + string.punctuation)
    toks += singles + ["##" + c for c in singles]
    for k in (2, 3):
        for combo in itertools.product(string.ascii_lowercase, repeat=k):
            w = "".join(combo)
            toks += [w, "##" + w]
            if len(toks) >= n:
                return {t: i for i, t in enumerate(toks[:n])}
    raise ValueError(f"a synthetic vocabulary stops at {len(toks)} entries")


def _wordpiece_spec(vocab):
    """A BERT ``tokenizer.json`` (a dict) over ``vocab``: BertNormalizer
    (lowercase), BertPreTokenizer, WordPiece, ``[CLS] $A [SEP]``."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tmpl = {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
            for t in ("[CLS]", "[SEP]")}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for t in specials],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": tmpl},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }


def _encoder_hf_config(kind: str, cfg, model_type=None):
    """The ``config.json`` of an HF DistilBERT classifier, ViT classifier
    or YOLOS detector with ``cfg``'s widths and synthetic labels."""
    if kind == "bert":
        labels = ["NEGATIVE", "POSITIVE"][:cfg.n_labels]
        return {"model_type": model_type or "distilbert",
                "architectures": ["DistilBertForSequenceClassification"],
                "vocab_size": cfg.vocab_size,
                "max_position_embeddings": cfg.max_position, "dim": cfg.dim,
                "n_layers": cfg.n_layers, "n_heads": cfg.heads,
                "hidden_dim": cfg.mlp_dim, "activation": cfg.act,
                "id2label": dict(enumerate(labels)),
                "label2id": {v: i for i, v in enumerate(labels)}}
    common = {"patch_size": cfg.patch_size, "hidden_size": cfg.dim,
              "num_hidden_layers": cfg.n_layers,
              "num_attention_heads": cfg.heads,
              "intermediate_size": cfg.mlp_dim, "hidden_act": cfg.act,
              "layer_norm_eps": cfg.ln_eps, "num_channels": 3}
    if kind == "vit":
        return {"model_type": "vit",
                "architectures": ["ViTForImageClassification"],
                "image_size": cfg.image_size, **common,
                "id2label": {i: f"label_{i}" for i in range(cfg.n_labels)}}
    return {"model_type": "yolos",
            "architectures": ["YolosForObjectDetection"],
            "image_size": list(cfg.image_size),
            "num_detection_tokens": cfg.n_det_tokens, **common,
            "id2label": {i: f"object_{i}" for i in range(cfg.n_labels - 1)}}


def _write_encoder_dir(path, kind: str, cfg, seed: int,
                       vocab_txt: bool = False, model_type=None):
    """A seeded HF-layout directory for the ``bert``, ``vit`` or ``yolo``
    unit: ``config.json``, ``model.safetensors`` (fp32, the HF names) and,
    for DistilBERT, a synthetic WordPiece vocabulary of ``vocab_size``
    entries (``tokenizer.json``, or ``vocab.txt`` alone). LayerNorm scales
    1, other vectors N(0, 0.02), the class, detection and position tokens
    N(0, 0.02), every matrix N(0, 1/fan_in). Returns the port's state dict
    (CPU tensors)."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
        save_safetensors,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models import (
        bert,
        vit,
        yolos,
    )

    mod, cls = {"bert": (bert, bert.DistilBertClassifier),
                "vit": (vit, vit.ViTClassifier),
                "yolo": (yolos, yolos.YolosForObjectDetection)}[kind]
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    shapes = {k: tuple(v.shape)
              for k, v in cls(cfg, device="meta").state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)
        if len(shape) == 1 and leaf[-1] == "weight" and "ln" in leaf[0]:
            t = torch.ones(shape)
        elif len(shape) == 1 or name in ("cls", "det", "pos"):
            t = torch.randn(shape, generator=gen) * 0.02
        else:
            fan = 1
            for s in shape[1:]:
                fan *= s
            t = torch.randn(shape, generator=gen) / fan ** 0.5
        state[name] = t
    names = mod.hf_names(cfg)
    save_safetensors({names[k]: v for k, v in state.items()},
                     path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(
        _encoder_hf_config(kind, cfg, model_type)))
    if kind == "bert":
        vocab = _wordpiece_vocab(cfg.vocab_size)
        if vocab_txt:
            (path / "vocab.txt").write_text(
                "\n".join(vocab) + "\n", encoding="utf-8")
        else:
            (path / "tokenizer.json").write_text(
                json.dumps(_wordpiece_spec(vocab)), encoding="utf-8")
        (path / "tokenizer_config.json").write_text(json.dumps({
            "do_lower_case": True, "model_max_length": cfg.max_position,
            "pad_token": "[PAD]", "unk_token": "[UNK]",
            "cls_token": "[CLS]", "sep_token": "[SEP]",
            "mask_token": "[MASK]", "tokenizer_class": "DistilBertTokenizer"}))
    return state


def _encoder_configs():
    """The encoder units' published widths: DistilBERT-base-uncased
    fine-tuned on SST-2 (6 layers of 768, 12 heads, 30,522 tokens, 2
    labels), ViT-base-patch16-224 (12 layers of 768, 1,000 labels),
    YOLOS-tiny at 512 x 864 (12 layers of 192, 3 heads, 100 detection
    tokens, 92 labels)."""
    from scalable_hw_agnostic_inference_tpu_torch.models import (
        bert,
        vit,
        yolos,
    )

    return {"bert": bert.BertConfig(), "vit": vit.ViTConfig(),
            "yolo": yolos.YolosConfig()}


def _encoder_inputs(kind, service, payload):
    """The model inputs the unit builds for ``payload``, on the card."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.serve.units import common

    if kind == "bert":
        ids, mask = service._encode(payload["text"])
        return (torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())
    c = service.mcfg
    if kind == "vit":
        px = common.decode_image(payload, c.image_size)
    else:
        px = common.decode_image(payload, *c.image_size,
                                 mean=common.IMAGENET_MEAN,
                                 std=common.IMAGENET_STD)
    return (torch.from_numpy(px).cuda(),)


def _encoder_agreement(kind, service, inputs):
    """B1 against its plain version on one request's inputs: the relative
    rms distance of the encoder's output, the largest logit change, the
    top-1 labels; for bert also the control (the plain version with each
    row's key length cut by one)."""
    import torch

    model = service.model
    outs = []
    hook = model.encoder.register_forward_hook(
        lambda m, i, o: outs.append(o.float()))
    try:
        with torch.inference_mode():
            logits = model(*inputs)
            with _plain_attention():
                plain = model(*inputs)
            control = None
            if kind == "bert":
                ids, mask = inputs
                cut = mask.clone()
                cut[0, int(mask.sum()) - 1] = 0
                with _plain_attention():
                    model(ids, cut)
                control = outs[2]
    finally:
        hook.remove()
    if kind == "yolo":
        logits, plain = logits[0], plain[0]

    def rrms(a):
        return float((a - outs[1]).pow(2).mean().sqrt()
                     / outs[1].pow(2).mean().sqrt())

    row = {"hidden_rrms": rrms(outs[0]),
           "control_rrms": None if control is None else rrms(control),
           "logits_max_abs": float((logits - plain).abs().max()),
           "argmax_equal": bool(torch.equal(logits.argmax(-1),
                                            plain.argmax(-1)))}
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"serve_encoders {kind}: non-finite logits")
    if row["hidden_rrms"] > ENCODER_RRMS:
        raise AssertionError(f"serve_encoders {kind}: B1 against its plain "
                             f"version {row['hidden_rrms']:.4f} > "
                             f"{ENCODER_RRMS}")
    if control is not None and row["control_rrms"] <= ENCODER_RRMS:
        raise AssertionError(f"serve_encoders {kind}: the bound is too "
                             f"loose: one key less gives "
                             f"{row['control_rrms']:.4f}")
    if not row["argmax_equal"]:
        top2 = plain.float().topk(2, -1).values
        gap = float((top2[..., 0] - top2[..., 1]).min())
        if gap >= 2 * row["logits_max_abs"]:
            raise AssertionError(f"serve_encoders {kind}: B1's label parts "
                                 f"from the plain version's at a gap of "
                                 f"{gap:.4f}")
    return row


def _check_encoder_body(kind, cfg, payload, body):
    import numpy as np

    if kind == "bert":
        ok = (body["label"] in ("NEGATIVE", "POSITIVE")
              and len(body["logits"]) == cfg.n_labels
              and np.isfinite(body["logits"]).all())
    elif kind == "vit":
        ok = (len(body["top5"]) == 5
              and body["label"] == body["top5"][0]["label"]
              and body["label"].startswith("label_"))
    else:
        n = body["count"]
        ok = (n == len(body["detections"])
              and (payload["threshold"] > 0 or n == cfg.n_det_tokens)
              and all(d["label"].startswith("object_")
                      for d in body["detections"]))
    if not ok:
        raise AssertionError(f"serve_encoders {kind}: {str(body)[:300]}")


def phase_serve_encoders(ctx):
    """The ``bert``, ``vit`` and ``yolo`` units, each on a seeded
    HF-layout directory at published widths written here
    (``_write_encoder_dir``, ``_encoder_configs``): 3 requests over HTTP
    each (bert's texts, PNGs from the port's encoder and ``"random"``), B1
    exactly one launch a layer a request and nothing else launched, a
    request's latency and one forward's device time; B1 against its plain
    version through the whole encoder (``ENCODER_RRMS``); on the card a
    mask that is no prefix raises; the bert unit's WordPiece ids."""
    import base64
    import tempfile

    import numpy as np
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models import imageio
    from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
    )

    _drop_engine_model(ctx)
    rng = np.random.default_rng(11)
    pngs = [base64.b64encode(imageio.encode_png(rng.integers(
        0, 256, (h, w, 3), dtype=np.uint8))).decode()
        for h, w in ((480, 640), (300, 200))]
    requests = {
        "bert": ("/predict", [{"text": t} for t in ENCODER_TEXTS]),
        "vit": ("/classify", [{"image_b64": pngs[0]}, {"image_b64": pngs[1]},
                              {"image_b64": "random"}]),
        "yolo": ("/detectobj", [
            {"image_b64": pngs[0], "threshold": 0.0},
            {"image_b64": pngs[1], "threshold": 0.5},
            {"image_b64": "random", "threshold": 0.9}])}
    root = Path(tempfile.mkdtemp(prefix="shai-encoders-"))
    rows = {}
    timer = ctx["timer"]
    try:
        for seed, (kind, cfg) in enumerate(_encoder_configs().items()):
            path = root / kind
            t0 = time.monotonic()
            _write_encoder_dir(path, kind, cfg, seed=20 + seed)
            write_s = time.monotonic() - t0
            route, reqs = requests[kind]
            with _unit_up(kind, {"DEVICE": "cuda", "MODEL_ID": str(path),
                                 "APP": kind, "PORT": "0",
                                 "MAX_SEQ_LEN": "512"}) as (
                    service, base, ready_s):
                lat = []
                _reset_counters()
                for p in reqs:
                    t1 = time.perf_counter()
                    status, body = _http(base + route, p)
                    lat.append(time.perf_counter() - t1)
                    if status != 200:
                        raise AssertionError(f"serve_encoders {kind}: "
                                             f"{status} {body}")
                    _check_encoder_body(kind, cfg, p, body)
                counts = _read_counters()
                _check_counters(f"serve_encoders {kind}", counts,
                                {"flash_attention"})
                want = cfg.n_layers * len(reqs)
                if counts["flash_attention"] != want:
                    raise AssertionError(
                        f"serve_encoders {kind}: B1 "
                        f"{counts['flash_attention']} launches, expected "
                        f"{cfg.n_layers} x {len(reqs)}")
                ctx.setdefault("launches", {})[
                    f"serve_encoders {kind}"] = counts
                inputs = _encoder_inputs(kind, service, reqs[0])
                agree = _encoder_agreement(kind, service, inputs)
                with torch.inference_mode():
                    fwd_ms = timer(lambda: service.model(*inputs), reps=10)
                row = {"write_s": write_s, "ready_s": ready_s,
                       "latency_s": {"p50": _pct(lat, 0.5),
                                     "max": max(lat)},
                       "forward_ms": fwd_ms, "b1_launches": want,
                       "agreement": agree}
                if kind == "bert":
                    if not isinstance(service.tokenizer, WordPieceTokenizer) \
                            or service.seq != 512:
                        raise AssertionError("serve_encoders bert: not the "
                                             "directory's WordPiece at 512")
                    ids, mask = inputs
                    row["ids"] = ids[0, :int(mask.sum())].tolist()
                    holed = mask.clone()
                    holed[0, 1] = 0
                    try:
                        with torch.inference_mode():
                            service.model(ids, holed)
                    except ValueError as e:
                        row["holed_mask"] = str(e)[:60]
                    else:
                        raise AssertionError("serve_encoders bert: a mask "
                                             "that is no prefix ran on the "
                                             "card")
                rows[kind] = row
                log(f"serve_encoders {kind}: " + json.dumps(row))
                del service, inputs
            gc.collect()
            torch.cuda.empty_cache()
        ctx["serve_encoders"] = rows
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- serve_causal ------------------------------------------------------------

#: the llama unit's rounds on the seeded 1B directory: new tokens a
#: request, and the prompts (the checkpoint phase's)
CAUSAL_NEW = 32
CAUSAL_PROMPTS = (CKPT_CORPUS[:60], "Café déjà vu 🚀 " * 3,
                  "numbers 12345 and more")
#: the full-size round: llama-8b-geometry, one 128-token generate
GEOMETRY_NEW = 128


def _forwards(toks, eos: int, n_new: int) -> int:
    """The decode forwards a generate of ``n_new`` tokens ran for one row
    whose tokens are ``toks``: up to its first EOS, else ``n_new - 1``
    (the last token needs none)."""
    hits = [i for i, t in enumerate(toks) if int(t) == eos]
    return hits[0] if hits else n_new - 1


def _stream(toks, eos: int):
    """A row's tokens up to and with its first EOS."""
    out = []
    for t in toks:
        out.append(int(t))
        if int(t) == eos:
            break
    return out


def _dense_step_ms(ctx, service) -> float:
    """Device ms of one decode step of the unit's smallest bucket: its
    captured graph replayed at one row, half its cache in (CUDA events;
    the replay rewrites one cache slot, which the next generate
    overwrites); the counters are restored after."""
    import torch

    gen = service._gen[service.buckets.buckets[0]]
    cache, step = gen.steps[1]
    dev = step.tok.device
    tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    pos = torch.full((1,), cache.n_slots // 2, dtype=torch.int64,
                     device=dev)
    saved = _read_counters()
    ms = ctx["timer"](lambda: step(tok, pos), reps=10)
    for name, (fn, attr) in _counters().items():
        setattr(fn, attr, saved[name])
    return ms


def _dense_replay_equals_eager(service) -> bool:
    """One decode step of the unit's smallest bucket replayed from its
    graph and run eagerly on the same cache, token and position (both
    write the same slot): the logits bit for bit. The counters are
    restored after."""
    import torch

    cache, step = service._gen[service.buckets.buckets[0]].steps[1]
    dev = step.tok.device
    tok = torch.full((1, 1), 7, dtype=torch.int64, device=dev)
    pos = torch.full((1,), cache.n_slots // 2, dtype=torch.int64,
                     device=dev)
    saved = _read_counters()
    with torch.inference_mode():
        replayed = step(tok, pos).clone()
        eager = service.model(tok, pos[:, None], cache=cache,
                              write_pos=pos)[:, -1]
    for name, (fn, attr) in _counters().items():
        setattr(fn, attr, saved[name])
    return bool(torch.equal(replayed, eager))


def phase_serve_causal(ctx):
    """The ``llama`` unit on the seeded Llama-3.2-1B-width directory
    (``_seeded_1b_dir``, the checkpoint phase's weights), bf16:
    ``/generate`` greedy for ``CAUSAL_PROMPTS`` and ``/sentiment``, B1
    exactly one launch a layer a prefill and B2 one a layer a decode step
    (nothing else launched), the 400 past ``MAX_NEW_TOKENS``; its greedy
    tokens held against the scoring forward through the plain versions
    (``TIE_TOL``), and the ``vllm`` unit's greedy tokens on the same
    directory and prompts held against the same forward by the same rule,
    every token (the streams' partings logged), a decode step's graph
    replay bit for bit against its eager run; then ``deepseek`` with
    ``QUANTIZATION=int8`` on the directory (B4 one launch a projection a
    forward); then ``llama-8b-geometry`` at full width and depth, one
    ``GEOMETRY_NEW``-token generate: ms a token, B1 and B2 launches."""
    import types

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.causal_lm import (
        SENTIMENT_PROMPT,
    )

    _drop_engine_model(ctx)
    path = _seeded_1b_dir(ctx)
    env = {"DEVICE": "cuda", "MODEL_ID": str(path), "PORT": "0",
           "MAX_NEW_TOKENS": str(CAUSAL_NEW), "MAX_SEQ_LEN": "512"}
    row = {"write_s": ctx.get("seeded_1b_write_s")}
    review = "A moving, beautifully shot film."
    t_part = time.monotonic()
    # the vllm unit (the paged engine) on the same directory and prompts,
    # first, so that the llama unit's model scores both units' tokens
    vservice, vbase, vserver = _ckpt_boot(ctx, path, False)
    try:
        vprompts = [vservice._encode(p) for p in CAUSAL_PROMPTS]
        vfins = []
        for p in CAUSAL_PROMPTS:
            status, body = _http(vbase + "/generate", {
                "prompt": p, "temperature": 0.0, "max_new_tokens": 16,
                "logprobs": 2})
            if status != 200:
                raise AssertionError(f"serve_causal vllm: {status} {body}")
            vfins.append(types.SimpleNamespace(
                token_ids=[e["token"] for e in body["logprobs"]],
                logprobs=body["logprobs"]))
    finally:
        vserver.stop()
        vservice.close()
    del vservice
    gc.collect()
    torch.cuda.empty_cache()
    row["vllm_seconds"] = time.monotonic() - t_part
    t_part = time.monotonic()
    with _unit_up("llama", {**env, "APP": "llama"}) as (service, base,
                                                        ready_s):
        L, eos = service.mcfg.n_layers, service.eos_id
        lat, bodies = [], []
        _reset_counters()
        for p in CAUSAL_PROMPTS:
            t1 = time.perf_counter()
            status, body = _http(base + "/generate",
                                 {"prompt": p, "temperature": 0.0})
            lat.append(time.perf_counter() - t1)
            if status != 200 or not isinstance(body.get("generated_text"),
                                               str):
                raise AssertionError(f"serve_causal: {status} {body}")
            bodies.append(body)
        status, sent = _http(base + "/sentiment", {"text": review})
        if status != 200 or not isinstance(sent.get("sentiment"), str):
            raise AssertionError(f"serve_causal: /sentiment {status} {sent}")
        counts = _read_counters()
        _check_counters("serve_causal", counts,
                        {"flash_attention", "paged_decode_attention"})
        toks = [service.generate_ids(p, 0.0) for p in CAUSAL_PROMPTS]
        sent_toks = service.generate_ids(
            SENTIMENT_PROMPT.format(text=review), 0.0)
        fwd = sum(_forwards(t, eos, CAUSAL_NEW) for t in toks + [sent_toks])
        want = {"flash_attention": L * (len(toks) + 1),
                "paged_decode_attention": L * fwd}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"serve_causal: launches {got}, expected "
                                 f"{want} (one a layer a prefill and a "
                                 f"decode step)")
        ctx.setdefault("launches", {})["serve_causal"] = counts
        bad = _http(base + "/generate", {"prompt": "x",
                                         "max_new_tokens": CAUSAL_NEW + 1})
        if bad[0] != 400:
            raise AssertionError(f"serve_causal: past the cap: {bad}")
        ids = [service._encode(p) for p in CAUSAL_PROMPTS]
        prompts = [i[0][0, :int(i[1][0])].tolist() for i in ids]
        streams = [_stream(t, eos) for t in toks]
        fins = [types.SimpleNamespace(token_ids=s, logprobs=None)
                for s in streams]
        score = _score(service.model, prompts, fins)
        step_ms = _dense_step_ms(ctx, service)
        if not _dense_replay_equals_eager(service):
            raise AssertionError("serve_causal: a decode step's graph "
                                 "replay differs from its eager run")
        if score["plain"][1] > TIE_TOL:
            raise AssertionError(f"serve_causal: a greedy token "
                                 f"{score['plain'][1]:.3f} below the plain "
                                 f"scoring forward's maximum (> {TIE_TOL})")
        # the vllm unit's tokens, every one of them, held to the same
        # plain scoring forward by the same rule: where the two decode
        # paths part, each one's token is within TIE_TOL of that forward's
        # maximum at the parting
        if vprompts != prompts:
            raise AssertionError("serve_causal: the vllm unit encodes the "
                                 "prompts differently")
        vscore = _score(service.model, prompts, vfins)
        row["llama"] = {
            "ready_s": ready_s, "latency_s": {"p50": _pct(lat, 0.5),
                                              "max": max(lat)},
            "ms_per_token": [1e3 * s / max(1, b["n_tokens"])
                             for s, b in zip(lat, bodies)],
            "n_tokens": [b["n_tokens"] for b in bodies],
            "sentiment": sent["sentiment"][:40], "launches": counts,
            "decode_forwards": fwd, "score": score, "past_cap": bad[0],
            "decode_step_device_ms": step_ms, "replay_equals_eager": True,
            "graphs": {str(b): {str(n): st.launches for n, (_, st)
                                in g.steps.items()}
                       for b, g in service._gen.items()}}
        log("serve_causal llama: " + json.dumps(row["llama"]))
        partings = []
        for m, v in zip(streams, vfins):
            i = next((n for n, (x, y) in enumerate(zip(m, v.token_ids))
                      if x != y), None)
            top = None if i is None else v.logprobs[i]["top_logprobs"]
            partings.append(None if i is None else {
                "token": i, "vllm_top2_gap": float(top[0]) - float(top[1])})
        row["vllm"] = {"score": vscore, "partings": partings,
                       "seconds": row.pop("vllm_seconds")}
        log("serve_causal vs vllm: " + json.dumps(row["vllm"]))
        if vscore["plain"][1] > TIE_TOL:
            raise AssertionError(f"serve_causal vllm: a greedy token "
                                 f"{vscore['plain'][1]:.3f} below the plain "
                                 f"scoring forward's maximum (> {TIE_TOL})")
        if vscore["lp_err"] > LP_TOL:
            raise AssertionError(f"serve_causal vllm: a logprob is "
                                 f"{vscore['lp_err']:.4f} from the plain "
                                 f"scoring forward's, over {LP_TOL}")
        del service
    gc.collect()
    torch.cuda.empty_cache()
    row["llama"]["seconds"] = time.monotonic() - t_part
    t_part = time.monotonic()

    # deepseek, int8 weights: every projection on B4
    with _unit_up("deepseek", {**env, "APP": "deepseek",
                               "QUANTIZATION": "int8"}) as (
            service, base, ready_s):
        L, eos = service.mcfg.n_layers, service.eos_id
        _reset_counters()
        t1 = time.perf_counter()
        status, body = _http(base + "/generate", {
            "prompt": CAUSAL_PROMPTS[0], "temperature": 0.0})
        wall = time.perf_counter() - t1
        counts = _read_counters()
        if status != 200:
            raise AssertionError(f"serve_causal deepseek: {status} {body}")
        _check_counters("serve_causal deepseek", counts,
                        {"flash_attention", "paged_decode_attention",
                         "int8_matmul"})
        fwd = _forwards(service.generate_ids(CAUSAL_PROMPTS[0], 0.0), eos,
                        CAUSAL_NEW)
        want = {"flash_attention": L, "paged_decode_attention": L * fwd,
                "int8_matmul": 7 * L * (1 + fwd)}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"serve_causal deepseek: launches {got}, "
                                 f"expected {want}")
        ctx["launches"]["serve_causal deepseek"] = counts
        row["deepseek_int8"] = {"ready_s": ready_s, "wall_s": wall,
                                "n_tokens": body["n_tokens"],
                                "launches": counts,
                                "seconds": time.monotonic() - t_part}
        log("serve_causal deepseek int8: "
            + json.dumps(row["deepseek_int8"]))
        del service
    gc.collect()
    torch.cuda.empty_cache()

    # full width and depth: llama-8b-geometry, one 128-token generate
    t_part = time.monotonic()
    with _unit_up("llama", {"DEVICE": "cuda", "MODEL_ID": "llama-8b-geometry",
                            "APP": "llama", "PORT": "0",
                            "MAX_NEW_TOKENS": str(GEOMETRY_NEW)}) as (
            service, base, ready_s):
        L = service.mcfg.n_layers
        _reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        status, body = _http(base + "/generate", {
            "prompt": "the quick brown fox", "temperature": 0.0})
        wall = time.perf_counter() - t1
        counts = _read_counters()
        if status != 200:
            raise AssertionError(f"serve_causal 8b: {status} {body}")
        _check_counters("serve_causal 8b", counts,
                        {"flash_attention", "paged_decode_attention"})
        want = {"flash_attention": L,
                "paged_decode_attention": L * (GEOMETRY_NEW - 1)}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"serve_causal 8b: launches {got}, "
                                 f"expected {want}")
        ctx["launches"]["serve_causal 8b"] = counts
        peak = torch.cuda.max_memory_allocated()
        row["llama_8b_geometry"] = {
            "ready_s": ready_s, "wall_s": wall,
            "ms_per_token": 1e3 * wall / GEOMETRY_NEW,
            "decode_step_device_ms": _dense_step_ms(ctx, service),
            "cache_bytes": 2 * L * 2 * (32 + GEOMETRY_NEW) * 8 * 128,
            "launches": counts, "peak_bytes": peak,
            "seconds": time.monotonic() - t_part}
        log("serve_causal 8b: " + json.dumps(row["llama_8b_geometry"]))
        del service
    gc.collect()
    torch.cuda.empty_cache()
    ctx["serve_causal"] = row


# -- tensor parallelism: one rank's shapes, the boot gate, the rank-local
# -- forward (tp_plan) ---------------------------------------------------------

#: the tensor-parallel plans one rank of which a card runs (label, preset,
#: tp): deploy/units/llama- and mistral-tpu-deploy.yaml (MESH_SPEC=tp=4),
#: tp=2 and tp=8 of the same 8B widths, llama-mh-tpu-deploy.yaml (tp=16)
#: and dsr70b-mh-tpu-deploy.yaml (tp=32), whose 8 kv heads are widened to
#: tp (``models.llama.replicate_kv_heads``)
TP_PLANS = (("8B tp=2", "llama3_8b", 2), ("8B tp=4", "llama3_8b", 4),
            ("8B tp=8", "llama3_8b", 8), ("70B tp=16", "llama3_70b", 16),
            ("70B tp=32", "llama3_70b", 32))
#: the plans whose per-rank projections B4 is held and timed at, each at a
#: decode batch and a 512-token prefill
TP_INT8_PLANS = ("8B tp=4", "70B tp=32")
TP_INT8_ROWS = (8, 512)
#: the gate's refusal: llama-8b-geometry with 48,000 blocks of 16 tokens,
#: 2 MiB a block over 32 layers, 93.75 GiB of bf16 KV
TP_GATE_BLOCKS = 48_000
#: the rank-local forward: a 512-token prompt, then 8 greedy steps, at
#: Llama-3-8B's widths and 16 of its 32 layers (the depth cut keeps the
#: smoke inside its time; every check counts from the config's layers)
TP_PROMPT, TP_STEPS, TP_SEED = 512, 8, 21
TP_LAYERS = 16
#: the rank-local forward's last-position logits against tp=1's through
#: the same kernels, relative rms (PERF.md §6 states the prediction): each
#: rank's partial sums round to bf16 before the all-reduce adds them in
#: bf16, so the logits move by rounding alone; a control whose first
#: o-projection all-reduce drops one rank's partial must fall outside
TP_RRMS = 0.1


def _rank_plans():
    """``{label: EngineShardings}`` of ``TP_PLANS``."""
    import dataclasses

    from scalable_hw_agnostic_inference_tpu_torch.engine.runner import (
        EngineShardings,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
    )

    out = {}
    for label, preset, tp in TP_PLANS:
        cfg = getattr(LlamaConfig, preset)()
        if tp > cfg.n_kv_heads:
            cfg = dataclasses.replace(cfg, n_kv_heads=tp)
        out[label] = EngineShardings(cfg, tp)
    return out


def _rank_heads():
    """The distinct per-rank ``(H, Hkv)`` of the plans, each with the plans
    that give it."""
    heads = {}
    for label, plan in _rank_plans().items():
        heads.setdefault((plan.n_heads, plan.n_kv_heads), []).append(label)
    return heads


def _paged_rank_row(ctx, torch, gen, pa, H, Hkv, lengths):
    """B2 at one rank's heads, the B=8 decode shape of the paged phase (a
    pool of 1,024 shuffled blocks, M=128), held and timed."""
    timer = ctx["timer"]
    B, D, bs, N, M = len(lengths), 128, 16, 1024, 128
    q, kp, vp, tables, lens = _paged_case(torch, gen, B, H, Hkv, D, bs, N,
                                          M, lengths)
    out = pa.paged_decode_attention(q, kp, vp, tables, lens)
    f32 = (q.float(), kp.float(), vp.float(), tables)
    ref = pa.paged_decode_attention_reference(*f32, lens)
    dropped = pa.paged_decode_attention_reference(*f32, _cut(lens))
    torch.cuda.synchronize()
    shape = (f"rank B={B} H={H} Hkv={Hkv} D={D} bs={bs} N={N} M={M} "
             f"lengths={lengths}")
    err, share, d_share = _check_close(f"paged_decode_attention {shape}",
                                       out, ref, dropped)
    del f32, ref, dropped
    n_bytes, flops = _paged_work(B, H, Hkv, D, bs, M, lengths)
    bms, by = bound_ms(n_bytes, flops)
    line = {"shape": shape, "max_abs_err": err, "tol_share": share,
            "dropped_keys_tol_share": d_share,
            "ms": timer(lambda: pa.paged_decode_attention(q, kp, vp, tables,
                                                          lens)),
            "plain_ms": timer(lambda: pa.paged_decode_attention_reference(
                q, kp, vp, tables, lens), reps=5),
            "bound_ms": bms, "bound_by": by, "library_ms": None}
    log("paged_decode_attention: " + json.dumps(line))
    return line


def _ragged_rank_row(ctx, torch, gen, rpa, H, Hkv, quant):
    """B3 at one rank's heads, the ragged phase's B=8 decode shape (2,048
    shuffled blocks, M=128, lengths 1 to 2048), bf16 or int8, held and
    timed."""
    timer = ctx["timer"]
    lengths = [1, 17, 255, 512, 1000, 1500, 2047, 2048]
    D, bs, N, M = 128, 16, 2048, 128
    q, kp, vp, ks, vs, tables, lens = _ragged_inputs(
        torch, gen, len(lengths), H, Hkv, D, bs, N, M, lengths, quant, "own")
    args = (q, kp, vp, tables, lens, ks, vs)
    out = rpa.ragged_paged_attention(*args)
    qf = q.float()
    ref = rpa.ragged_paged_attention_reference(qf, kp, vp, tables, lens, ks,
                                               vs)
    dropped = rpa.ragged_paged_attention_reference(qf, kp, vp, tables,
                                                   _cut(lens), ks, vs)
    torch.cuda.synchronize()
    kind = "int8" if quant else "bf16"
    shape = (f"rank decode B=8 {kind}: H={H} Hkv={Hkv} D={D} bs={bs} N={N} "
             f"M={M} lengths {lengths}")
    err, share, d_share = _check_close(f"ragged_paged_attention {shape}",
                                       out, ref, dropped)
    del qf, ref, dropped
    n_bytes, flops = _ragged_work(tables.cpu(), lens.cpu(), H, Hkv, D, bs,
                                  quant)
    bms, by = bound_ms(n_bytes, flops)
    line = {"shape": shape, "max_abs_err": err, "tol_share": share,
            "dropped_keys_tol_share": d_share,
            "ms": timer(lambda: rpa.ragged_paged_attention(*args)),
            "plain_ms": timer(lambda: rpa.ragged_paged_attention_reference(
                *args), reps=5),
            "bound_ms": bms, "bound_by": by, "library_ms": None}
    log("ragged_paged_attention: " + json.dumps(line))
    return line


def _int8_rank_rows(ctx, torch, i8, quantize_weight, gen, failed):
    """B4 at the per-rank projection widths of ``TP_INT8_PLANS`` (q, k/v,
    o, gate/up, down, lm_head; ``EngineShardings.projection_shapes``) and
    M in ``TP_INT8_ROWS``: within ``INT8_ULPS`` of the plain version, which
    short of one K slice must fail; kernel, plain version and bf16
    ``F.linear`` timed with the L2 flushed. Failures go to ``failed``."""
    timer = ctx["timer"]
    plans = _rank_plans()
    shapes = {}
    for label in TP_INT8_PLANS:
        for proj, nk in plans[label].projection_shapes().items():
            shapes.setdefault(nk, []).append(f"{label} {proj}")
    rows = []
    for (N, K), names in shapes.items():
        w = torch.randn(N, K, generator=gen, device="cuda") * 0.02
        wq, scale = quantize_weight(w)
        wb = w.to(torch.bfloat16)
        del w
        for M in TP_INT8_ROWS:
            x = torch.randn(M, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            out = i8.int8_matmul(x, wq, scale)
            ref = i8.int8_matmul_reference(x, wq, scale)
            cut = i8.int8_matmul_reference(x[:, 16:], wq[:, 16:], scale)
            torch.cuda.synchronize()
            ulps = _int8_ulps(torch, out, ref, x, wq, scale)
            cut_ulps = _int8_ulps(torch, cut, ref, x, wq, scale)
            n_bytes = N * K + 4 * N + 2 * M * K + 2 * M * N
            bms, by = bound_ms(n_bytes, 2.0 * M * N * K)
            line = {"shape": f"M={M} N={N} K={K}", "M": M, "N": N, "K": K,
                    "plans": names,
                    "instantiation": ("wide" if i8.int8_plan(
                        M, N, K, torch.cuda.get_device_properties(
                            0).multi_processor_count).wide else "decode"),
                    "max_abs_err": float((out.float() - ref.float()).abs()
                                         .max()),
                    "max_ulps": ulps, "dropped_slice_ulps": cut_ulps,
                    "ms": timer(lambda: i8.int8_matmul(x, wq, scale),
                                clean=True),
                    "plain_ms": timer(lambda: i8.int8_matmul_reference(
                        x, wq, scale), clean=True),
                    "library_ms": timer(lambda: torch.nn.functional.linear(
                        x, wb), clean=True),
                    "bound_ms": bms, "bound_by": by}
            log("int8_matmul rank: " + json.dumps(line))
            if ulps > INT8_ULPS:
                failed.append(f"rank {line['shape']}: {ulps:.2f} ulps")
            if cut_ulps <= INT8_ULPS:
                failed.append(f"rank {line['shape']}: the check misses a "
                              f"dropped K slice")
            rows.append(line)
            del x, out, ref, cut
        del wq, scale, wb
    return rows


def _watch_engines(ctx):
    """Every engine the run builds: its boot gate's ``describe()`` line
    when it is built, and after its warmup the peak device memory since its
    construction began, less what was resident then besides its model's
    weights (``engine_peak_gib``, beside the budget's per-chip total).
    Instruments ``LLMEngine`` for this process; returns the undo."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
    )

    init, warm = LLMEngine.__init__, LLMEngine.warm_executables
    gib = float(1 << 30)

    def watched_init(self, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        init(self, *a, **k)
        b = self.hbm_budget
        weights = sum(t.nbytes for t in self.model.state_dict().values())
        self._gate_line = {"phase": ctx.get("phase"),
                           "budget": b.describe(),
                           "budget_total_gib": b.total_gib,
                           "budget_params_gib": b.params_gib,
                           "budget_kv_gib": b.kv_gib,
                           "budget_act_gib": b.act_gib,
                           "weights_gib": weights / gib,
                           "other_resident_gib": (before - weights) / gib}
        ctx.setdefault("gate", []).append(self._gate_line)
        log("hbm gate: " + b.describe())

    def watched_warm(self, *a, **k):
        n = warm(self, *a, **k)
        torch.cuda.synchronize()
        line = self._gate_line
        peak = torch.cuda.max_memory_allocated() / gib
        line["peak_after_warmup_gib"] = peak
        line["engine_peak_gib"] = peak - line["other_resident_gib"]
        log("hbm gate after warmup: " + json.dumps(line))
        return n

    LLMEngine.__init__ = watched_init
    LLMEngine.warm_executables = watched_warm

    def undo():
        LLMEngine.__init__, LLMEngine.warm_executables = init, warm

    return undo


def phase_tp_plan(ctx):
    """(a) the boot gate on the card; (b) the rank-local Llama-3-8B over
    the loopback group at tp 1, 2, 4, 8 (bf16) and 1, 4 (int8). The
    per-rank kernel rows are in the flash, paged, ragged and int8_matmul
    phases."""
    t0 = time.monotonic()
    ctx["tp_plan"] = {"gate": _tp_gate(ctx)}
    ctx["tp_plan"]["gate"]["seconds"] = time.monotonic() - t0
    t0 = time.monotonic()
    ctx["tp_plan"]["forward"] = _tp_forward(ctx)
    ctx["tp_plan"]["forward_seconds"] = time.monotonic() - t0


def _tp_gate(ctx):
    """``llama-8b-geometry`` (zeros, 16 GB on the card) under
    ``TP_GATE_BLOCKS`` blocks is refused with the budget's breakdown before
    the engine allocates a byte; the same tier at serve's geometry boots
    and warms (its gate line and peak logged by ``_watch_engines``)."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.core.budget import (
        HbmBudgetError,
        causal_lm_budget,
        detect_hbm_gib,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        geometry_params,
    )

    if os.environ.get("SHAI_HBM_GIB"):
        raise AssertionError("tp_plan reads the card's memory: unset "
                             "SHAI_HBM_GIB")
    _drop_engine_model(ctx)
    cfg = LlamaConfig.llama3_8b()
    model = LlamaForCausalLM.from_state_dict(cfg, geometry_params(cfg))
    hbm = detect_hbm_gib(torch.device("cuda"))
    over = EngineConfig(model="llama-8b-geometry", max_model_len=2048,
                        max_num_seqs=8, context_encoding_buckets=(128, 512),
                        num_blocks=TP_GATE_BLOCKS)
    want = causal_lm_budget(cfg, over, hbm_gib_per_chip=hbm)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        LLMEngine(cfg, model, over, device="cuda")
    except HbmBudgetError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"tp_plan: {TP_GATE_BLOCKS} blocks booted")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if refusal != want.describe() or after != before:
        raise AssertionError(f"tp_plan: the refusal {refusal!r} (want "
                             f"{want.describe()!r}); allocated {before} -> "
                             f"{after} bytes across it")
    log(f"tp_plan gate: refused: {refusal}; allocated {before} bytes before "
        f"and after")
    fits = EngineConfig(model="llama-8b-geometry", max_model_len=2048,
                        max_num_seqs=8, context_encoding_buckets=(128, 512))
    t0 = time.monotonic()
    eng = LLMEngine(cfg, model, fits, device="cuda")
    eng.warm_executables()
    line = dict(getattr(eng, "_gate_line", {}),
                warm_s=time.monotonic() - t0, hbm_gib=hbm)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"refused": refusal, "allocated_before": before,
            "allocated_after": after, "kv_gib_refused": want.kv_gib,
            "booted": line}


def _rank_models(cfg, state, tp, group, n_slots):
    """Each rank's model over its shard and its dense cache, built on the
    caller's thread."""
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaForCausalLM,
        init_cache,
        tp_rules,
    )
    from scalable_hw_agnostic_inference_tpu_torch.parallel.sharding import (
        shard_state_dict,
    )

    return [(LlamaForCausalLM.from_state_dict(
                cfg, shard_state_dict(state, tp_rules(), tp, r), group=group),
             init_cache(cfg, 1, n_slots, group=group)) for r in range(tp)]


def _drop_first_partial_group(tp):
    """A loopback group whose first all-reduce (layer 0's o projection)
    sums all partials but the last rank's: the control of the rank-local
    forward's bound."""
    from scalable_hw_agnostic_inference_tpu_torch.parallel.loopback import (
        LoopbackGroup,
    )

    class DropFirstPartial(LoopbackGroup):
        def __init__(self, size):
            super().__init__(size)
            self.calls = [0] * size

        def all_reduce(self, t):
            first = self.calls[self.rank] == 0
            self.calls[self.rank] += 1
            if not first:
                return super().all_reduce(t)

            def partial(ts):
                out = ts[0].clone()
                for other in ts[1:-1]:
                    out += other
                return out

            return self._exchange(t, partial)

    return DropFirstPartial(tp)


def _rank_run(cfg, state, tp, prompt, steps, control=False):
    """The rank-local model at ``tp`` over a loopback group: the prompt's
    prefill (B1 on every rank), then ``steps`` greedy decode steps over
    each rank's dense cache (B2 on every rank), eager. Returns the
    prefill's last-position logits [V] fp32, the greedy tokens (1 +
    ``steps``), the launch counts and the seconds; every rank's logits and
    tokens must be the same bits."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.parallel.loopback import (
        LoopbackGroup,
        run_ranks,
    )

    group = _drop_first_partial_group(tp) if control else LoopbackGroup(tp)
    ranks = _rank_models(cfg, state, tp, group, prompt.shape[1] + steps)
    plen = torch.tensor([prompt.shape[1]], device="cuda")

    def rank(r):
        m, cache = ranks[r]
        last = m(prompt, cache=cache, lengths=plen)[0, -1]
        tok = last.argmax()
        toks = [tok]
        for t in range(steps):
            pos = plen + t
            tok = m(tok.view(1, 1), pos[:, None], cache=cache,
                    write_pos=pos)[0, -1].argmax()
            toks.append(tok)
        return last, torch.stack(toks)

    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.monotonic()
    with torch.inference_mode():
        outs = run_ranks(rank, group)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = _read_counters()
    last, toks = outs[0]
    for other_last, other_toks in outs[1:]:
        if not (torch.equal(other_last, last) and torch.equal(other_toks,
                                                              toks)):
            raise AssertionError(f"tp={tp}: the ranks' logits differ")
    del ranks, outs
    gc.collect()
    torch.cuda.empty_cache()
    return last.float(), toks.tolist(), counts, seconds


def _rrms(a, b) -> float:
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def _tp_forward(ctx):
    """Llama-3-8B at full width, ``TP_LAYERS`` layers, seeded N(0, 0.02)
    bf16 weights (``random_params``), through the rank-local modules at tp
    1, 2, 4, 8,
    each tp in turn (shards freed between), then int8 weights at tp 1 and
    4: the last-position logits against tp=1's within ``TP_RRMS``, the
    control (tp=4, layer 0's o all-reduce one partial short) outside it;
    the greedy tokens held to the plain scoring forward's deficit rule
    (``TIE_TOL``); B1 exactly one launch a layer a rank a prefill, B2 one
    a layer a rank a step, B4 seven a layer and the head a rank a forward
    (wide at the prefill, decode at a step), nothing else."""
    import dataclasses
    import types

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        random_params,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_state_dict,
    )

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=TP_LAYERS)
    L = cfg.n_layers
    state = random_params(cfg, seed=TP_SEED, std=0.02)
    base = LlamaForCausalLM.from_state_dict(cfg, state)
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, TP_PROMPT), generator=gen,
                           device="cuda")
    plist = prompt[0].tolist()
    rows, ref = [], {}

    def check(what, tp, quant, last, toks, counts, seconds, model):
        want = {"flash_attention": tp * L,
                "paged_decode_attention": tp * L * TP_STEPS}
        if quant:
            want.update(int8_matmul_wide=tp * (7 * L + 1),
                        int8_matmul=tp * (7 * L + 1) * TP_STEPS)
        _check_counters(what, counts, set(want))
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        score = _score(model, [plist], [types.SimpleNamespace(
            token_ids=toks, logprobs=None)])
        line = {"what": what, "tp": tp, "int8": quant, "seconds": seconds,
                "launches": got, "tokens": toks, "score": score}
        if tp == 1:
            ref[quant] = last
        else:
            line["rrms_vs_tp1"] = _rrms(last, ref[quant])
        log("tp_plan forward: " + json.dumps(line))
        if score["plain"][1] > TIE_TOL:
            raise AssertionError(f"{what}: a greedy token "
                                 f"{score['plain'][1]:.3f} below the plain "
                                 f"scoring forward's maximum (> {TIE_TOL})")
        if line.get("rrms_vs_tp1", 0.0) > TP_RRMS:
            raise AssertionError(f"{what}: logits {line['rrms_vs_tp1']:.4f}"
                                 f" relative rms from tp=1's (> {TP_RRMS})")
        ctx.setdefault("launches", {})[f"tp_plan {what}"] = counts
        rows.append(line)

    for tp in (1, 2, 4, 8):
        last, toks, counts, seconds = _rank_run(cfg, state, tp, prompt,
                                                TP_STEPS)
        check(f"bf16 tp={tp}", tp, False, last, toks, counts, seconds, base)
        if tp == 4:
            c_last = _rank_run(cfg, state, tp, prompt, 0, control=True)[0]
            control = _rrms(c_last, ref[False])
            log(f"tp_plan forward: control (tp=4, layer 0's o all-reduce "
                f"without rank 3's partial): {control:.4f} relative rms "
                f"from tp=1's (must exceed {TP_RRMS})")
            if control <= TP_RRMS:
                raise AssertionError(f"tp_plan: the control passes the "
                                     f"bound ({control:.4f})")
            rows.append({"what": "control tp=4", "rrms_vs_tp1": control})
    qstate = quantize_state_dict(state)
    del base, state
    gc.collect()
    torch.cuda.empty_cache()
    qbase = LlamaForCausalLM.from_state_dict(cfg, qstate)
    for tp in (1, 4):
        last, toks, counts, seconds = _rank_run(cfg, qstate, tp, prompt,
                                                TP_STEPS)
        check(f"int8 tp={tp}", tp, True, last, toks, counts, seconds, qbase)
    del qbase, qstate
    gc.collect()
    torch.cuda.empty_cache()
    return rows


#: tp_engine's requests: prompt lengths (seeded ids), tokens each, the
#: sampled round's requests (the first two), and the engine geometry (the
#: engine phases', 8 slots). Two ranks sharing one H100 over gloo take
#: 0.65-0.90 s a step (each staged collective waits on both processes'
#: contexts), so the rounds stay short
TPE_PROMPTS = (5, 37, 120, 300, 512, 700, 1000, 1300)
#: the engine model's first 16 layers (the depth cut keeps the smoke
#: inside its time; every check counts from the config's layers)
TPE_LAYERS = 16
TPE_NEW_TOKENS = 8
TPE_SAMPLED = 2
TPE_ENGINE = dict(max_model_len=2048, max_num_seqs=8, block_size=16,
                  context_encoding_buckets=(128, 512),
                  max_new_tokens=TPE_NEW_TOKENS)


def _first_layers(cfg, model, n: int):
    """``(cfg, model)`` cut to its first ``n`` layers, the tensors shared
    (no copy)."""
    import dataclasses

    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaForCausalLM,
    )

    cut = dataclasses.replace(cfg, n_layers=n)
    state = {k: v for k, v in model.state_dict().items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < n}
    return cut, LlamaForCausalLM.from_state_dict(cut, state)


def _tpe_drive(eng, prompts, sampled=False):
    """Every prompt through ``eng`` (greedy with the top-2 logprobs, or
    temperature 0.8 and top-k 50): the finished requests in order, the
    launch counts, the seconds and the steps."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        SamplingParams,
    )

    params = (SamplingParams(temperature=0.8, top_k=50,
                             max_new_tokens=TPE_NEW_TOKENS) if sampled else
              SamplingParams(temperature=0.0, logprobs=2,
                             max_new_tokens=TPE_NEW_TOKENS))
    steps0 = eng._step_count
    _reset_counters()
    t0 = time.monotonic()
    ids = [eng.add_request(p, params) for p in prompts]
    done = {}
    while set(ids) - set(done):
        for f in eng.step():
            done[f.req_id] = f
    eng.finish_pending()
    torch.cuda.synchronize()
    fins = [done[i] for i in ids]
    if any(len(f.token_ids) != TPE_NEW_TOKENS for f in fins):
        raise AssertionError("a request ended short")
    return (fins, _read_counters(), time.monotonic() - t0,
            eng._step_count - steps0)


def _tpe_line(what, fins, counts, seconds, steps, **extra):
    line = {"what": what, "seconds": seconds, "steps": steps,
            "launches": counts,
            "launches_a_step": {k: v / steps for k, v in counts.items() if v},
            **extra}
    log("tp_engine: " + json.dumps(line))
    return line


def phase_tp_engine(ctx):
    """The paged engine over tensor-parallel ranks on one card (module
    docstring, 7b): (a) an NCCL group of one, captured, against the
    unsharded engine; (b) two gloo ranks sharing the card; (c) (b) under
    int8 weights, int8 KV and ragged attention. Each part frees its
    engines before the next."""
    import tempfile

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine import ranks
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaForCausalLM,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_state_dict,
    )
    from scalable_hw_agnostic_inference_tpu_torch.parallel.distributed import (
        init_group,
    )

    t_phase = time.monotonic()
    out = ctx["tp_engine"] = {}
    cfg, model = _first_layers(*_engine_model(ctx), TPE_LAYERS)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in TPE_PROMPTS]
    one = EngineConfig(**TPE_ENGINE)
    two = EngineConfig(**dict(TPE_ENGINE, tensor_parallel_size=2))
    base = {"SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "",
            "SHAI_ASYNC_DECODE": "1", "SHAI_FUSED_STEP": "0"}

    # (a) tp=1 through the sharded code over an NCCL group of one
    with _env(base):
        t0 = time.monotonic()
        plain = LLMEngine(cfg, model, one, device="cuda")
        plain.warm_executables()
        want, counts, seconds, steps = _tpe_drive(plain, prompts)
        per_replay = {g.key: g.launches for g in plain.graphs()}
        ctx.setdefault("launches", {})["tp_engine unsharded"] = counts
        out["unsharded"] = _tpe_line("unsharded", want, counts, seconds,
                                     steps, warm_s=time.monotonic() - t0
                                     - seconds)
        del plain
        gc.collect()
        tmp = tempfile.mkdtemp(prefix="shai-tp1-")
        group = init_group(1, 0, os.path.join(tmp, "store"), "nccl",
                           "cuda:0")
        try:
            t0 = time.monotonic()
            eng = ranks.rank_engine(cfg, dict(model.state_dict()), one,
                                    group, "cuda")
            eng.warm_executables()
            graphs = eng.graphs()
            n_graphs = len(graphs)
            if not graphs or not all(g.captured for g in graphs):
                raise AssertionError("tp_engine (a): decode keys not "
                                     "captured over the NCCL group")
            got, counts, seconds, steps = _tpe_drive(eng, prompts)
            mine = {g.key: g.launches for g in graphs}
            eng.close()
            leaked, checks = eng.cache.leaked_blocks, eng.mirror.checks
            # the graphs go before the communicator they captured
            del eng, graphs
            gc.collect()
            torch.cuda.synchronize()
        finally:
            group.close()
            shutil.rmtree(tmp, ignore_errors=True)
    if [f.token_ids for f in got] != [f.token_ids for f in want]:
        raise AssertionError("tp_engine (a): tokens differ from the "
                             "unsharded engine's")
    if mine != per_replay or counts != ctx["launches"][
            "tp_engine unsharded"]:
        raise AssertionError(f"tp_engine (a): launches a replay {mine} / "
                             f"{per_replay}, in all {counts}")
    ctx["launches"]["tp_engine (a)"] = counts
    out["a"] = _tpe_line("(a) nccl tp=1", got, counts, seconds, steps,
                         graphs=n_graphs, per_replay=sorted(
                             {n for d in mine.values()
                              for n in d.values()}),
                         leaked=leaked, digest_checks=checks,
                         warm_s=time.monotonic() - t0 - seconds)
    if leaked:
        raise AssertionError("tp_engine (a): leaked blocks")
    torch.cuda.empty_cache()

    def two_ranks(what, state, switches, ecfg, reference, key):
        with _env({**base, **switches}):
            t0 = time.monotonic()
            eng = ranks.launch_engine(cfg, state, ecfg, 2, "gloo", "cuda",
                                      timeout_s=300.0)
            boot = time.monotonic() - t0
            try:
                if eng._graphs.capture_graphs:
                    raise AssertionError(f"{what}: a gloo rank captured")
                fins, counts, seconds, steps = _tpe_drive(eng, prompts)
                gaps = _tie_diverge(fins, reference, tie_gap=TIE_TOL)
                s_fins, s_counts, s_seconds, s_steps = _tpe_drive(
                    eng, prompts[:TPE_SAMPLED], sampled=True)
                leaked = eng.cache.leaked_blocks
            finally:
                eng.close()    # the last digest check, the follower ends
        ctx["launches"][key] = counts
        equal = sum(f.token_ids == w.token_ids
                    for f, w in zip(fins, reference))
        line = _tpe_line(what, fins, counts, seconds, steps, boot_s=boot,
                         boot=eng.mirror.boot,
                         equal_requests=equal, tie_gaps=gaps,
                         sampled_seconds=s_seconds, sampled_steps=s_steps,
                         leaked=leaked, digest_checks=eng.mirror.checks,
                         follower_exit=[p.exitcode
                                        for p in eng.mirror.followers])
        if leaked or any(p.exitcode for p in eng.mirror.followers):
            raise AssertionError(f"{what}: leaked {leaked}, followers "
                                 f"{line['follower_exit']}")
        return line

    # (b) tp=2: two processes sharing the card, gloo, eager
    out["b"] = two_ranks("(b) gloo tp=2", dict(model.state_dict()), {},
                         two, want, "tp_engine (b)")
    # rank 0 launches, kernel for kernel, what the unsharded engine did
    _check_counters("tp_engine (b)", ctx["launches"]["tp_engine (b)"],
                    {"flash_attention", "paged_decode_attention"})
    if ctx["launches"]["tp_engine (b)"] != ctx["launches"][
            "tp_engine unsharded"]:
        raise AssertionError(
            f"tp_engine (b): launches {ctx['launches']['tp_engine (b)']}, "
            f"unsharded {ctx['launches']['tp_engine unsharded']}")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) (b) under int8 weights, int8 KV and ragged attention
    switches = {"SHAI_KV_QUANT": "int8", "SHAI_RAGGED_ATTENTION": "1"}
    qcfg = cfg
    qmodel = LlamaForCausalLM.from_state_dict(
        cfg, quantize_state_dict(dict(model.state_dict())))
    del model
    _drop_engine_model(ctx)
    with _env({**base, **switches}):
        plain = LLMEngine(qcfg, qmodel, EngineConfig(
            **dict(TPE_ENGINE, quantization="int8")), device="cuda")
        qwant, counts, seconds, steps = _tpe_drive(plain, prompts)
        out["unsharded int8"] = _tpe_line("unsharded int8", qwant, counts,
                                          seconds, steps)
        del plain
        gc.collect()
    out["c"] = two_ranks("(c) gloo tp=2 int8", dict(qmodel.state_dict()),
                         switches, EngineConfig(**dict(
                             TPE_ENGINE, tensor_parallel_size=2,
                             quantization="int8")), qwant, "tp_engine (c)")
    _check_counters("tp_engine (c)", ctx["launches"]["tp_engine (c)"],
                    {"flash_attention", "ragged_paged_attention",
                     "int8_matmul", "int8_matmul_wide"})
    _drop_engine_model(ctx)
    out["seconds"] = time.monotonic() - t_phase
    log(f"tp_engine: {out['seconds']:.1f} s")


# -- the LLM units over tensor-parallel ranks (tp_units) ----------------------

#: tp_units: the llama units' cap on new tokens (two gloo ranks sharing the
#: card stage each of a 1B step's 33 collectives through host memory), and
#: the four prompts of (a) and (b)
TPU_NEW = 8
TPU_PROMPTS = CAUSAL_PROMPTS + ("the quick brown fox",)
#: the review each round sends to ``/sentiment``
TPU_REVIEW = "A moving film."


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_unit(name: str, env, backend=None, pool=None, prepare=None):
    """The unit ``name`` (its config read under ``env``) with its ranks
    started as ``serve_multihost`` starts them (``serve.multihost.
    start_ranks``: its followers spawned and joined, nothing loaded yet):
    ``(service, ranks, fails, start time)`` for :func:`_ranked_up`, or,
    with ``pool``, a future of it, so that the followers boot beside work
    of this process that joins no group (this process holds one group at
    a time). Spawned followers inherit this process's environment, so a
    pooled start runs while no ``SHAI_COORDINATOR`` is set. ``prepare(
    service)`` runs before the followers take their copies."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.multihost import (
        start_ranks,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    with _env(env):
        cfg = ServeConfig.from_env()
    service = UNITS[name](cfg)
    if prepare is not None:
        prepare(service)

    def start():
        fails = []
        t0 = time.monotonic()
        ranks = start_ranks(cfg, service, backend, on_fail=fails.append,
                            timeout_s=300.0)
        return service, ranks, fails, t0

    return pool.submit(start) if pool is not None else start()


@contextlib.contextmanager
def _ranked_up(started):
    """:func:`_start_unit`'s unit behind the stdlib server, ready, for the
    block: ``(service, base URL, ranks, ready seconds)``. Rank 0's
    ``generate_ids`` records every token row it returns in
    ``service.rows``. A failure that would end the unit together fails the
    phase instead; the ranks close after the block (the shutdown, every
    rank's mirrored counts, the followers' exit)."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import (
        create_app,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
    from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
        MetricsPublisher,
    )

    service, ranks, fails, t0 = started
    cfg = service.cfg
    if hasattr(service, "generate_ids"):
        _recording(service)   # after the followers took their copies
    server = None
    try:
        app = create_app(cfg, service, publisher=MetricsPublisher(
            cfg.app, cfg.nodepool, cfg.pod_name, stream=io.StringIO()))
        server = Server(app, host="127.0.0.1", port=0)
        host, port = server.start_background()
        base = f"http://{host}:{port}"
        while True:
            status, body = _http(base + "/readiness")
            if status == 200:
                break
            if status == 500 or fails or time.monotonic() - t0 > 600:
                raise AssertionError(f"{cfg.app} over ranks: not ready: "
                                     f"{status} {body} {fails}")
            time.sleep(0.25)
        yield service, base, ranks, time.monotonic() - t0
        if fails:
            raise AssertionError(f"{cfg.app} over ranks failed: {fails}")
    finally:
        if server is not None:
            server.stop()
        ranks.close()


def _recording(service):
    """``service`` whose ``generate_ids`` keeps each row it returns in
    ``service.rows`` (the mirrored ``generate_text`` calls it; rank 0's
    own calls, no device work of their own)."""
    inner = service.generate_ids
    service.rows = []

    def generate_ids(*args, **kwargs):
        row = inner(*args, **kwargs)
        service.rows.append(row)
        return row

    service.generate_ids = generate_ids
    return service


def _tpu_round(base, service, prompts):
    """``prompts`` greedy through ``/generate``, then ``/sentiment``: the
    token rows, the launch counts, each request's seconds and tokens."""
    _reset_counters()
    service.rows.clear()
    lat, n_tok = [], []
    for p in prompts:
        t1 = time.perf_counter()
        status, body = _http(base + "/generate",
                             {"prompt": p, "temperature": 0.0})
        lat.append(time.perf_counter() - t1)
        if status != 200:
            raise AssertionError(f"tp_units: {status} {body}")
        n_tok.append(body["n_tokens"])
    status, sent = _http(base + "/sentiment", {"text": TPU_REVIEW})
    if status != 200 or not isinstance(sent.get("sentiment"), str):
        raise AssertionError(f"tp_units: /sentiment {status} {sent}")
    return list(service.rows), _read_counters(), lat, n_tok


def _tpu_launches(what, counts, rows, L, eos, quant=False, wide=0):
    """B1 one launch a layer a prefill, B2 one a layer a decode forward
    (B4 seven a layer a forward under int8: its wide instantiation for
    the ``wide`` prefills past ``DECODE_MAX_ROWS`` rows, the decode one
    for the others), nothing else."""
    expect = {"flash_attention", "paged_decode_attention"}
    if quant:
        expect.add("int8_matmul")
        if wide:
            expect.add("int8_matmul_wide")
    _check_counters(what, counts, expect)
    fwd = sum(_forwards(r, eos, TPU_NEW) for r in rows)
    want = {"flash_attention": L * len(rows),
            "paged_decode_attention": L * fwd}
    if quant:
        want["int8_matmul"] = 7 * L * (len(rows) - wide + fwd)
        want["int8_matmul_wide"] = 7 * L * wide
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _wide_prefills(service, prompts):
    """How many of :func:`_tpu_round`'s prefills (``prompts``, then
    ``/sentiment``'s) have a bucket past B4's decode instantiation."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda.int8_matmul import (
        DECODE_MAX_ROWS,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.causal_lm import (
        SENTIMENT_PROMPT,
    )

    texts = list(prompts) + [SENTIMENT_PROMPT.format(text=TPU_REVIEW)]
    return sum(service._encode(t)[2] > DECODE_MAX_ROWS for t in texts)


def _tpu_line(what, **row):
    log("tp_units: " + json.dumps({"what": what, **row}))
    return row


def _count_collectives(group):
    """Count ``group``'s Python all-reduce and all-gather calls in
    ``group.calls``."""
    group.calls = 0
    for name in ("all_reduce", "all_gather"):
        inner = getattr(group, name)

        def counted(*args, _inner=inner, **kwargs):
            group.calls += 1
            return _inner(*args, **kwargs)

        setattr(group, name, counted)


def _replay_collectives(service, group):
    """One decode step of the unit's smallest bucket replayed from its
    graph, then run eagerly on the same cache, token and position: the
    collective calls each made in Python (``_count_collectives``) and
    whether their logits are the same bits. The counters are restored
    after."""
    import torch

    cache, step = service._gen[service.buckets.buckets[0]].steps[1]
    dev = step.tok.device
    tok = torch.full((1, 1), 7, dtype=torch.int64, device=dev)
    pos = torch.full((1,), cache.n_slots // 2, dtype=torch.int64,
                     device=dev)
    saved = _read_counters()
    with torch.inference_mode():
        c0 = group.calls
        replayed = step(tok, pos).clone()
        c1 = group.calls
        eager = service.model(tok, pos[:, None], cache=cache,
                              write_pos=pos)[:, -1]
        c2 = group.calls
    for name, (fn, attr) in _counters().items():
        setattr(fn, attr, saved[name])
    return c1 - c0, c2 - c1, bool(torch.equal(replayed, eager))


def _tpu_refusals(path):
    """(c): each refused before any allocation or spawned process."""
    import multiprocessing

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.serve.multihost import (
        start_ranks,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    tmp = Path(path).parent
    cm = tmp / "tp2-vllm.json"
    cm.write_text(json.dumps({"tensor_parallel_size": 2}))
    base = {"DEVICE": "cuda", "MODEL_ID": str(path), "PORT": "0",
            "SHAI_COORDINATOR": "", "MESH_SPEC": ""}
    coord = {"SHAI_COORDINATOR": f"127.0.0.1:{_free_port()}",
             "SHAI_NUM_PROCESSES": "3", "SHAI_PROCESS_ID": "0"}
    cases = [
        ("tp=2 over NCCL, one card", "llama", {"MESH_SPEC": "tp=2"},
         "2 NCCL ranks on this host.*1 card"),
        ("SHAI_NUM_PROCESSES=3, tp=2", "llama",
         {"MESH_SPEC": "tp=2", **coord}, "SHAI_NUM_PROCESSES=3 does not"),
        ("dp=2,tp=1", "llama", {"MESH_SPEC": "dp=2,tp=1"},
         "tensor parallelism only"),
        ("bert tp=2", "bert", {"MESH_SPEC": "tp=2"}, "A7.3c"),
        ("vllm tensor_parallel_size 2", "vllm", {"VLLM_CONFIG": str(cm)},
         "tensor_parallel_size=2 exceeds the 1 local devices"),
    ]
    import re

    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    kids = multiprocessing.active_children()
    out = {}
    for what, name, env, match in cases:
        with _env({**base, **env}):
            cfg = ServeConfig.from_env()
            service = UNITS[name](cfg)
            try:
                if name == "vllm":
                    service.load()
                else:
                    start_ranks(cfg, service)
                raise AssertionError(f"tp_units (c) {what}: not refused")
            except ValueError as e:
                if not re.search(match, str(e)):
                    raise AssertionError(f"tp_units (c) {what}: {e}")
                out[what] = str(e)[:160]
        if torch.cuda.memory_allocated() != mem or \
                multiprocessing.active_children() != kids:
            raise AssertionError(f"tp_units (c) {what}: refused after an "
                                 f"allocation or a spawn")
    return out


def phase_tp_units(ctx):
    """The LLM units over tensor-parallel ranks on one card (module
    docstring, 7c)."""
    import concurrent.futures

    t_phase = time.monotonic()
    out = ctx["tp_units"] = {}
    _drop_engine_model(ctx)
    path = _seeded_1b_dir(ctx)
    env = {"DEVICE": "cuda", "MODEL_ID": str(path), "PORT": "0",
           "APP": "llama", "MAX_NEW_TOKENS": str(TPU_NEW),
           "MAX_SEQ_LEN": "512", "QUANTIZATION": "", "SHAI_COORDINATOR": "",
           "MESH_SPEC": ""}
    envs = {"b": {**env, "MESH_SPEC": "tp=2"},
            "8b": {**env, "MODEL_ID": "llama-8b-geometry",
                   "MESH_SPEC": "tp=2"},
            "plain_int8": {**env, "APP": "deepseek", "QUANTIZATION": "int8"},
            "int8": {**env, "APP": "deepseek", "QUANTIZATION": "int8",
                     "MESH_SPEC": "tp=2"}}
    # pooled starts not yet run: if the phase fails first, their ranks
    # are ended here (no shutdown: their followers wait in the boot)
    pending = set()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            _tp_units(ctx, out, path, env, envs, pool, pending)
    finally:
        for future in pending:
            try:
                ranks = future.result()[1]
            except BaseException as e:
                log(f"tp_units: a pending start failed: {e}")
                continue
            ranks.closing = True
            for p in ranks.procs:
                p.kill()
                p.join(5.0)
            ranks.group.close()
    out["seconds"] = time.monotonic() - t_phase
    log(f"tp_units: {out['seconds']:.1f} s")


def _held(what, got, plain, model, prompts, eos):
    """Token rows ``got`` equal to the plain unit's ``plain``, or each
    token within TIE_TOL of the plain scoring forward's maximum (on
    ``model``, the plain unit's)."""
    import types

    equal = sum(bool((a == b).all()) for a, b in zip(got, plain))
    score = _score(model, prompts, [
        types.SimpleNamespace(token_ids=_stream(r, eos), logprobs=None)
        for r in got[:len(prompts)]])
    if equal < len(plain) and score["plain"][1] > TIE_TOL:
        raise AssertionError(f"{what}: a greedy token "
                             f"{score['plain'][1]:.3f} below the plain "
                             f"scoring forward's maximum (> {TIE_TOL})")
    return equal, score


def _tp_units(ctx, out, path, env, envs, pool, pending):
    """phase_tp_units' runs. A tp=2 run's follower (an interpreter, torch,
    CUDA, the port: some 8 s) boots on ``pool`` beside the plain unit its
    run is held against, where one is; ``pending``: those starts until
    their run takes them."""
    import torch

    launches = ctx.setdefault("launches", {})

    def started(future):
        pending.discard(future)
        return future.result()

    # (b)'s follower boots beside the plain unit
    start_b = _start_unit("llama", envs["b"], "gloo", pool)
    pending.add(start_b)

    # the plain unit: the tokens, the launches, the scoring model
    with _unit_up("llama", env) as (service, base, ready_s):
        _recording(service)
        rows, counts, lat, n_tok = _tpu_round(base, service, TPU_PROMPTS)
        L, eos = service.mcfg.n_layers, service.eos_id
        _tpu_launches("tp_units plain", counts, rows, L, eos)
        plain_model = service.model
        prompts = [service._encode(p) for p in TPU_PROMPTS]
        prompts = [i[0][0, :int(i[1][0])].tolist() for i in prompts]
        plain = rows
        launches["tp_units plain"] = counts
        out["plain"] = _tpu_line("plain", ready_s=ready_s, latency_s=lat,
                                 n_tokens=n_tok, launches=counts)
        del service
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two gloo ranks sharing the card
    with _ranked_up(started(start_b)) as (service, base, ranks, ready_s):
        rows, counts, lat, n_tok = _tpu_round(base, service, TPU_PROMPTS)
        past = _http(base + "/generate", {"prompt": "x",
                                          "max_new_tokens": TPU_NEW + 1})
        after = _http(base + "/generate", {"prompt": TPU_PROMPTS[0],
                                           "temperature": 0.0})
        alive = [p.exitcode for p in ranks.procs]
        if past[0] != 400 or after[0] != 200 or alive != [None]:
            raise AssertionError(f"tp_units (b): past the cap {past[0]}, "
                                 f"then {after[0]}, follower {alive}")
        boot = ranks.boot
    _tpu_launches("tp_units (b)", counts, rows, L, eos)
    equal, score = _held("tp_units (b)", rows[:len(plain)], plain,
                         plain_model, prompts, eos)
    if equal == len(plain) and counts != launches["tp_units plain"]:
        raise AssertionError(f"tp_units (b): launches {counts}, plain "
                             f"{launches['tp_units plain']}")
    # the warmup, 4 requests, /sentiment, the 400 and the one after it
    want = [{"generate_text": len(TPU_PROMPTS) + 4}] * 2
    if ranks.mirrored != want or [p.exitcode for p in ranks.procs] != [0]:
        raise AssertionError(f"tp_units (b): mirrored {ranks.mirrored}, "
                             f"follower exit "
                             f"{[p.exitcode for p in ranks.procs]}")
    launches["tp_units (b)"] = counts
    out["b"] = _tpu_line(
        "(b) gloo tp=2", ready_s=ready_s, boot=boot, latency_s=lat,
        n_tokens=n_tok,
        ms_per_token=[1e3 * s / max(1, n) for s, n in zip(lat, n_tok)],
        launches=counts, equal_rows=equal, score=score,
        mirrored=ranks.mirrored)
    del plain_model
    gc.collect()
    torch.cuda.empty_cache()

    # (a) a group of one over NCCL, through the env path
    coord = {"SHAI_COORDINATOR": f"127.0.0.1:{_free_port()}",
             "SHAI_NUM_PROCESSES": "1", "SHAI_PROCESS_ID": "0",
             "MESH_SPEC": "tp=1"}
    # the unit reads the coordinator from the environment at its load
    with _env({**env, **coord}), _ranked_up(
            _start_unit("llama", {**env, **coord})) as (service, base,
                                                         ranks, ready_s):
        group = service.model.group
        if group is None or group.backend != "nccl" or ranks.layout.tp != 1:
            raise AssertionError(f"tp_units (a): not a group of one over "
                                 f"NCCL: {group}")
        _count_collectives(group)
        rows, counts, lat, n_tok = _tpu_round(base, service, TPU_PROMPTS)
        steps = [st for g in service._gen.values()
                 for _, st in g.steps.values()]
        if not steps or not all(st.graph is not None for st in steps):
            raise AssertionError("tp_units (a): a decode step not captured")
        replays = sum(st.replays for st in steps)
        calls = group.calls
        # a replay makes no collective call and equals the eager step,
        # which makes them: the all-reduces are inside the graph
        replay_calls, eager_calls, same = _replay_collectives(service,
                                                              group)
        if not same or replay_calls or not eager_calls:
            raise AssertionError(
                f"tp_units (a): replay equals eager {same}, collective "
                f"calls of a replay {replay_calls}, of the eager step "
                f"{eager_calls}")
        boot = ranks.boot
    if [r.tolist() for r in rows] != [r.tolist() for r in plain]:
        raise AssertionError("tp_units (a): tokens differ from the plain "
                             "unit's")
    if counts != launches["tp_units plain"]:
        raise AssertionError(f"tp_units (a): launches {counts}, plain "
                             f"{launches['tp_units plain']}")
    launches["tp_units (a)"] = counts
    out["a"] = _tpu_line(
        "(a) nccl tp=1, env path", ready_s=ready_s, boot=boot,
        latency_s=lat, n_tokens=n_tok,
        ms_per_token=[1e3 * s / max(1, n) for s, n in zip(lat, n_tok)],
        launches=counts, decode_replays=replays, collective_calls=calls,
        replay_collectives=replay_calls, eager_step_collectives=eager_calls,
        mirrored=ranks.mirrored)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) deepseek, int8 weights: the plain unit, then tp=2 (B4 at one
    # rank's widths), whose follower boots beside the plain unit
    start_q = _start_unit("deepseek", envs["int8"], "gloo", pool)
    pending.add(start_q)
    q_prompts = TPU_PROMPTS[:2]
    with _unit_up("deepseek", envs["plain_int8"]) as (service, base,
                                                       ready_s):
        _recording(service)
        plain_q, counts_q, lat, n_tok = _tpu_round(base, service, q_prompts)
        wide = _wide_prefills(service, q_prompts)
        _tpu_launches("tp_units plain int8", counts_q, plain_q, L, eos,
                      quant=True, wide=wide)
        plain_q_model = service.model
        launches["tp_units plain int8"] = counts_q
        out["plain_int8"] = _tpu_line("plain deepseek int8",
                                      ready_s=ready_s, latency_s=lat,
                                      n_tokens=n_tok, launches=counts_q)
        del service
    with _ranked_up(started(start_q)) as (service, base, ranks, ready_s):
        rows, counts, lat, n_tok = _tpu_round(base, service, q_prompts)
        boot = ranks.boot
    _tpu_launches("tp_units (b) deepseek int8", counts, rows, L, eos,
                  quant=True, wide=wide)
    equal, score = _held("tp_units (b) deepseek int8", rows, plain_q,
                         plain_q_model, prompts[:len(q_prompts)], eos)
    if equal == len(plain_q) and counts != counts_q:
        raise AssertionError(f"tp_units (b) deepseek int8: launches "
                             f"{counts}, plain int8 {counts_q}")
    if ranks.mirrored != [{"generate_text": len(q_prompts) + 2}] * 2:
        raise AssertionError(f"tp_units (b) deepseek int8: mirrored "
                             f"{ranks.mirrored}")
    launches["tp_units (b) deepseek"] = counts
    out["b_int8"] = _tpu_line(
        "(b) deepseek int8 tp=2", ready_s=ready_s, boot=boot,
        latency_s=lat, n_tokens=n_tok, launches=counts, equal_rows=equal,
        score=score, mirrored=ranks.mirrored)
    del plain_q_model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the manifest's model at full width and depth, tp=2
    with _ranked_up(_start_unit("llama", envs["8b"], "gloo")) as (
            service, base, ranks, ready_s):
        L8 = service.mcfg.n_layers
        _reset_counters()
        t1 = time.perf_counter()
        status, body = _http(base + "/generate", {
            "prompt": "the quick brown fox", "temperature": 0.0})
        wall = time.perf_counter() - t1
        counts = _read_counters()
        boot = ranks.boot
        if status != 200:
            raise AssertionError(f"tp_units 8b: {status} {body}")
    _check_counters("tp_units 8b", counts,
                    {"flash_attention", "paged_decode_attention"})
    want = {"flash_attention": L8,
            "paged_decode_attention": L8 * (TPU_NEW - 1)}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"tp_units 8b: launches {counts}, expected "
                             f"{want}")
    launches["tp_units (b) 8b"] = counts
    out["b_8b"] = _tpu_line("(b) llama-8b-geometry tp=2", ready_s=ready_s,
                            boot=boot, wall_s=wall,
                            ms_per_token=1e3 * wall / TPU_NEW,
                            launches=counts, mirrored=ranks.mirrored)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the refusals
    out["c"] = _tpu_line("(c) refusals", **_tpu_refusals(path))


# -- tp_diffusion ----------------------------------------------------------

#: tp_diffusion's prompts (one image or embedding each)
TPD_PROMPTS = ("a watercolor fox in a misty forest at dawn",
               "A red apple on a wooden table, 35mm photo")
#: tp_diffusion (b): the t5 unit's ``/embed`` at tp=2 (two gloo ranks)
#: against the plain unit's, relative rms (PERF.md states the
#: prediction). Each rank's partial sums after ``o`` and ``wo`` round to
#: bf16 before the all-reduce adds them in bf16, so the embedding moves by
#: bf16 rounding through 2 layers, some 2^-8 relative; 0.05 is many times
#: that. A control whose layer-0 ``o`` all-reduce keeps one rank's
#: partial alone must fall outside
T5_TP_RRMS = 0.05


def _rank_launch_counts(where, reset=False):
    """A mirrored call of tp_diffusion's units (each rank runs it in
    order with the others): this process's kernel launch counts written
    to ``where/<pid>.json``; ``reset`` then zeroes them."""
    Path(where, f"{os.getpid()}.json").write_text(
        json.dumps(_read_counters()))
    if reset:
        _reset_counters()
    return {}


def _counting(where):
    """A ``_start_unit`` ``prepare``: the unit mirrors
    :func:`_rank_launch_counts` too, so the leader reads every rank's
    launches."""
    import functools

    def prepare(service):
        service.mirror_methods = tuple(service.mirror_methods) + (
            "launch_counts",)
        service.launch_counts = functools.partial(_rank_launch_counts,
                                                  where)

    return prepare


def _rank_counts(service, where, n_ranks, timeout=120.0):
    """Every rank's launch counts, rank 0's first: the mirrored
    :func:`_rank_launch_counts`, then its files, once each rank wrote
    one."""
    for f in Path(where).glob("*.json"):
        f.unlink()
    service.launch_counts()
    deadline = time.monotonic() + timeout
    while len(list(Path(where).glob("*.json"))) < n_ranks:
        if time.monotonic() > deadline:
            raise AssertionError("tp_diffusion: a rank wrote no launch "
                                 "counts")
        time.sleep(0.05)
    time.sleep(0.1)
    mine = Path(where, f"{os.getpid()}.json")
    others = sorted(f for f in Path(where).glob("*.json") if f != mine)
    return [json.loads(f.read_text()) for f in [mine] + others]


def _t5_partial_control(torch, model, ids, mask):
    """The control of (b): rank 0's embedding of the encoder at tp=2 over
    a loopback group on this card whose first all-reduce (layer 0's
    ``o``) keeps each rank's own partial."""
    from scalable_hw_agnostic_inference_tpu_torch.models import t5
    from scalable_hw_agnostic_inference_tpu_torch.parallel.loopback import (
        LoopbackGroup,
        run_ranks,
    )
    from scalable_hw_agnostic_inference_tpu_torch.parallel.sharding import (
        shard_state_dict,
    )

    class Dropped(LoopbackGroup):
        def __init__(self, size):
            super().__init__(size)
            self.skipped = set()

        def all_reduce(self, t):
            if self.rank not in self.skipped:
                self.skipped.add(self.rank)
                return t
            return super().all_reduce(t)

    group, state = Dropped(2), model.state_dict()

    def rank(r):
        m = t5.build(model.cfg, shard_state_dict(state, t5.tp_rules(), 2, r),
                     dtype=model.dtype, group=group)
        return t5.mean_pool(m(ids, mask), mask)

    with torch.inference_mode():
        return run_ranks(rank, group)[0].float().cpu()


def _tpd_refusals(fenv, tenv):
    """(c): each refused before any allocation or spawned process."""
    import multiprocessing
    import re

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.serve.multihost import (
        start_ranks,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    hosts = {"SHAI_COORDINATOR": f"127.0.0.1:{_free_port()}",
             "SHAI_NUM_PROCESSES": "2", "SHAI_PROCESS_ID": "0"}
    unshared = "does not declare supports_multihost"
    one_card = "2 NCCL ranks on this host.*1 card"
    cases = [
        ("t5 SHAI_NUM_PROCESSES=2", "t5",
         {**tenv, "MESH_SPEC": "tp=2", **hosts}, None,
         "SHAI_NUM_PROCESSES=2 .*" + unshared),
        ("flux SHAI_NUM_PROCESSES=2", "flux",
         {**fenv, "SUBMESH": "0:2", **hosts}, None,
         "SHAI_NUM_PROCESSES=2 .*" + unshared),
        ("t5 tp=3 (64 heads)", "t5", {**tenv, "MESH_SPEC": "tp=3"}, "gloo",
         "tp=3: tp must divide heads=64"),
        ("flux SUBMESH=1:3, past the cards", "flux",
         {**fenv, "SUBMESH": "1:3"}, None,
         r"SUBMESH='1:3' asks for cards 1 to 2 \(nccl: a card a rank\), "
         r"and this host has 1 card"),
        ("t5 tp=2 over NCCL, one card", "t5", {**tenv, "MESH_SPEC": "tp=2"},
         None, one_card),
    ]
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    kids = multiprocessing.active_children()
    out = {}
    for what, name, env, backend, match in cases:
        with _env(env):
            cfg = ServeConfig.from_env()
            service = UNITS[name](cfg)
            try:
                start_ranks(cfg, service, backend)
                raise AssertionError(f"tp_diffusion (c) {what}: not "
                                     f"refused")
            except ValueError as e:
                if not re.search(match, str(e)):
                    raise AssertionError(f"tp_diffusion (c) {what}: {e}")
                out[what] = str(e)[:160]
        if torch.cuda.memory_allocated() != mem or \
                multiprocessing.active_children() != kids:
            raise AssertionError(f"tp_diffusion (c) {what}: refused after "
                                 f"an allocation or a spawn")
    return out


def _tpd_round(base, route, payloads):
    """Each payload on ``route``: the bodies and each request's seconds;
    anything but a 200 fails."""
    bodies, lat = [], []
    for p in payloads:
        t1 = time.perf_counter()
        status, body = _http(base + route, p, timeout=600)
        lat.append(time.perf_counter() - t1)
        if status != 200:
            raise AssertionError(f"tp_diffusion {route}: {status} "
                                 f"{str(body)[:300]}")
        bodies.append(body)
    return bodies, lat


def phase_tp_diffusion(ctx):
    """The ``t5`` and ``flux`` units over tensor-parallel ranks on one card
    (module docstring, 28b)."""
    import base64
    import concurrent.futures
    import tempfile

    import numpy as np
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.models import imageio

    t_phase = time.monotonic()
    out = ctx["tp_diffusion"] = {}
    launches = ctx.setdefault("launches", {})
    _drop_engine_model(ctx)
    if "seeded_flux" not in ctx:
        ctx["seeded_flux"] = _seeded_flux_dir(ctx)[0]
    path = ctx["seeded_flux"]
    where = tempfile.mkdtemp(prefix="shai-tpd-")
    clear = {"SHAI_COORDINATOR": "", "MESH_SPEC": "", "SUBMESH": ""}
    fenv = {"DEVICE": "cuda", "MODEL_ID": str(path), "APP": "flux",
            "NUM_INFERENCE_STEPS": str(FLUX_STEPS), "HEIGHT": str(FLUX_SIZE),
            "WIDTH": str(FLUX_SIZE), "PORT": "0", **clear}
    tenv = {"DEVICE": "cuda", "MODEL_ID": str(path / "text_encoder_2"),
            "APP": "t5", "PORT": "0", **clear}
    layers = SERVE_FLUX_DOUBLE + SERVE_FLUX_SINGLE
    n_req = len(TPD_PROMPTS)
    flux_req = [{"prompt": p, "seed": i} for i, p in enumerate(TPD_PROMPTS)]
    t5_req = [{"text": p} for p in TPD_PROMPTS]
    pending = set()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            # (b)'s flux follower boots beside the plain units
            start_fb = _start_unit("flux", {**fenv, "SUBMESH": "0:2"},
                                   "gloo", pool, prepare=_counting(where))
            pending.add(start_fb)

            # the plain units: the PNGs, the embeddings, the launches
            with _unit_up("flux", fenv) as (service, base, ready_s):
                _reset_counters()
                plain_f, lat = _tpd_round(base, "/genimage", flux_req)
                counts = _read_counters()
                del service
            _check_counters("tp_diffusion plain flux", counts,
                            {"flash_attention"})
            if counts["flash_attention"] != \
                    (FLUX_CLIP_B1 + layers * FLUX_STEPS) * n_req:
                raise AssertionError(f"tp_diffusion plain flux: launches "
                                     f"{counts}")
            launches["tp_diffusion plain flux"] = counts
            out["plain_flux"] = {"ready_s": ready_s, "latency_s": lat}
            with _unit_up("t5", tenv) as (service, base, ready_s):
                plain_t, lat = _tpd_round(base, "/embed", t5_req)
                ids, mask = (torch.from_numpy(a).to(service.device)
                             for a in service._encode(TPD_PROMPTS[0]))
                control = _t5_partial_control(torch, service.model, ids,
                                              mask)
                del service
            out["plain_t5"] = {"ready_s": ready_s, "latency_s": lat}
            gc.collect()
            torch.cuda.empty_cache()

            # (b) flux over two gloo ranks sharing the card
            pending.discard(start_fb)
            with _ranked_up(start_fb.result()) as (service, base, ranks,
                                                   ready_s):
                service.launch_counts(reset=True)
                got_f, lat = _tpd_round(base, "/genimage", flux_req)
                bad = [_http(base + "/genimage", {"prompt": "x", "steps": s})
                       for s in (3, "many")]
                again, _ = _tpd_round(base, "/genimage", flux_req[:1])
                alive = [p.exitcode for p in ranks.procs]
                counts = _rank_counts(service, where, 2)
                boot = ranks.boot
            if [b[0] for b in bad] != [400, 400] or alive != [None]:
                raise AssertionError(f"tp_diffusion (b) flux: the 400s "
                                     f"{bad}, follower {alive}")
            want = [{"warmup": 1, "infer": n_req + 3, "launch_counts": 2}] * 2
            if ranks.mirrored != want or \
                    [p.exitcode for p in ranks.procs] != [0]:
                raise AssertionError(
                    f"tp_diffusion (b) flux: mirrored {ranks.mirrored}, "
                    f"follower exit {[p.exitcode for p in ranks.procs]}")
            for i, (c, per) in enumerate(zip(counts, (
                    FLUX_CLIP_B1 + layers * FLUX_STEPS,
                    layers * FLUX_STEPS))):
                _check_counters(f"tp_diffusion (b) flux rank {i}", c,
                                {"flash_attention"})
                if c["flash_attention"] != per * (n_req + 1):
                    raise AssertionError(f"tp_diffusion (b) flux rank {i}: "
                                         f"B1 {c['flash_attention']}, "
                                         f"expected {per} a request")
            diffs = []
            for a, b in zip(got_f + again, plain_f + plain_f[:1]):
                pa, pb = (imageio.decode_png(base64.b64decode(x[
                    "image_b64"])) for x in (a, b))
                mean, mx = _image_diff(pa, pb)
                diffs.append({"mean": mean, "max": mx})
                if mean > FLUX_IMAGE_MEAN or mx > FLUX_IMAGE_MAX:
                    raise AssertionError(
                        f"tp_diffusion (b) flux: the image at tp=2 differs "
                        f"from the plain unit's by mean {mean:.3f}, max "
                        f"{mx} (bound {FLUX_IMAGE_MEAN}, {FLUX_IMAGE_MAX})")
            launches["tp_diffusion (b) flux"] = counts[0]
            launches["tp_diffusion (b) flux follower"] = counts[1]
            out["b_flux"] = {"ready_s": ready_s, "boot": boot,
                             "latency_s": lat, "vs_plain": diffs,
                             "launches": counts, "mirrored": ranks.mirrored}
            log("tp_diffusion (b) flux: " + json.dumps(out["b_flux"]))
            gc.collect()
            torch.cuda.empty_cache()

            # (b) t5 over two gloo ranks sharing the card
            with _ranked_up(_start_unit(
                    "t5", {**tenv, "MESH_SPEC": "tp=2"}, "gloo",
                    prepare=_counting(where))) as (service, base, ranks,
                                                   ready_s):
                service.launch_counts(reset=True)
                got_t, lat = _tpd_round(base, "/embed", t5_req)
                bad = _http(base + "/embed", {})
                again, _ = _tpd_round(base, "/embed", t5_req[:1])
                alive = [p.exitcode for p in ranks.procs]
                counts = _rank_counts(service, where, 2)
                boot = ranks.boot
            if bad[0] != 400 or alive != [None]:
                raise AssertionError(f"tp_diffusion (b) t5: no text "
                                     f"answered {bad}, follower {alive}")
            want = [{"infer": 1 + n_req + 2, "launch_counts": 2}] * 2
            if ranks.mirrored != want or \
                    [p.exitcode for p in ranks.procs] != [0]:
                raise AssertionError(
                    f"tp_diffusion (b) t5: mirrored {ranks.mirrored}, "
                    f"follower exit {[p.exitcode for p in ranks.procs]}")
            for i, c in enumerate(counts):
                _check_counters(f"tp_diffusion (b) t5 rank {i}", c, set())
            rrms = [_rrms(torch.tensor(a["embedding"]),
                          torch.tensor(b["embedding"]))
                    for a, b in zip(got_t + again, plain_t + plain_t[:1])]
            ctl = _rrms(control[0], torch.tensor(plain_t[0]["embedding"]))
            log(f"tp_diffusion (b) t5: relative rms {rrms} (bound "
                f"{T5_TP_RRMS}), control {ctl:.4f} (must exceed it)")
            if max(rrms) > T5_TP_RRMS or ctl <= T5_TP_RRMS:
                raise AssertionError(f"tp_diffusion (b) t5: relative rms "
                                     f"{rrms}, control {ctl}, bound "
                                     f"{T5_TP_RRMS}")
            if not all(np.isfinite(b["embedding"]).all() and b["dim"] == 4096
                       for b in got_t):
                raise AssertionError("tp_diffusion (b) t5: an embedding not "
                                     "finite or not 4096 wide")
            out["b_t5"] = {"ready_s": ready_s, "boot": boot,
                           "latency_s": lat, "rrms_vs_plain": rrms,
                           "control_rrms": ctl, "mirrored": ranks.mirrored}
            gc.collect()
            torch.cuda.empty_cache()

        # (a) each unit as a group of one over NCCL, through the env path
        for name, env, route, req, plain in (
                ("flux", fenv, "/genimage", flux_req, plain_f),
                ("t5", tenv, "/embed", t5_req, plain_t)):
            coord = {"SHAI_COORDINATOR": f"127.0.0.1:{_free_port()}",
                     "SHAI_NUM_PROCESSES": "1", "SHAI_PROCESS_ID": "0"}
            with _env({**env, **coord}), _ranked_up(
                    _start_unit(name, {**env, **coord})) as (
                    service, base, ranks, ready_s):
                group = service.group
                if group is None or group.backend != "nccl" or \
                        ranks.layout.tp != 1:
                    raise AssertionError(f"tp_diffusion (a) {name}: not a "
                                         f"group of one over NCCL: {group}")
                _reset_counters()
                got, lat = _tpd_round(base, route, req)
                counts = _read_counters()
            key = "image_b64" if name == "flux" else "embedding"
            if [b[key] for b in got] != [b[key] for b in plain]:
                raise AssertionError(f"tp_diffusion (a) {name}: the answer "
                                     f"differs from the plain unit's")
            if name == "flux" and counts != \
                    launches["tp_diffusion plain flux"]:
                raise AssertionError(f"tp_diffusion (a) flux: launches "
                                     f"{counts}")
            if name == "t5":
                _check_counters("tp_diffusion (a) t5", counts, set())
            launches[f"tp_diffusion (a) {name}"] = counts
            out[f"a_{name}"] = {"ready_s": ready_s, "latency_s": lat,
                                "launches": counts,
                                "mirrored": ranks.mirrored}
            gc.collect()
            torch.cuda.empty_cache()

        # (c) the refusals
        out["c"] = _tpd_refusals(fenv, tenv)
    finally:
        for future in pending:
            try:
                ranks = future.result()[1]
            except BaseException as e:
                log(f"tp_diffusion: a pending start failed: {e}")
                continue
            ranks.closing = True
            for p in ranks.procs:
                p.kill()
                p.join(5.0)
            ranks.group.close()
        shutil.rmtree(where, ignore_errors=True)
    out["seconds"] = time.monotonic() - t_phase
    log("tp_diffusion: " + json.dumps({k: v for k, v in out.items()
                                       if k != "b_flux"}))
    log(f"tp_diffusion: {out['seconds']:.1f} s")


def kernels_line(ctx):
    cuda_dir = "scalable_hw_agnostic_inference_tpu_torch/csrc"
    pallas = f"{TPU_PKG}/ops/pallas"
    # (name, ctx key of its timed row, source, TPU kernel, serve phase)
    spec = [
        ("flash_attention", "flash", f"{cuda_dir}/flash_attention.cu",
         f"{pallas}/flash_attention.py:132", "serve"),
        ("paged_decode_attention", "paged",
         f"{cuda_dir}/ragged_paged_attention.cu",
         f"{pallas}/paged_attention.py:101", "serve"),
        ("ragged_paged_attention", "ragged",
         f"{cuda_dir}/ragged_paged_attention.cu",
         f"{pallas}/ragged_paged_attention.py:121", "serve_ragged"),
    ]
    out = []
    for name, key, src, replaces, phase in spec:
        row = ctx[key]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": ctx["launches"][phase][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "launches_in": phase,
            "tpu_kernel": replaces,
            # the cached-admission callers (cached continuations, decode
            # of shared, restored and pulled blocks), in engine_prefix's
            # three runs and in serve_disagg's pods
            "prefix_launches": ctx["launches"]["engine_prefix"][name],
            "disagg_launches": ctx["launches"]["serve_disagg"][name],
            # the fleet's callers: the fabric-warm continuation and the
            # decode of migrated and resumed requests (serve_fleet)
            "fleet_launches": ctx["launches"]["serve_fleet"][name],
        })
    # the W8A16 projection (B4): no Pallas kernel (XLA's fused int8 dot);
    # its decode instantiation timed at serve's decode batch on the gate/up
    # shape, its wide one at a 512-token prefill call on the same shape,
    # both launched in serve_int8; the library time is bf16 F.linear on the
    # unquantized weight (the projection int8 replaces)
    for name, key in (("int8_matmul", "int8"), ("int8_matmul_wide",
                                                  "int8_wide")):
        row = ctx[key]
        out.append({
            "name": name, "route": "cuda",
            "source": f"{cuda_dir}/int8_matmul.cu",
            "replaces": f"{TPU_PKG}/ops/quant.py:142", "tpu_kernel": None,
            "launches": ctx["launches"]["serve_int8"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": "bf16 F.linear", "max_ulps": row["max_ulps"],
            "replaced_route_ms": row["replaced_route_ms"],
            "shape": row["shape"], "launches_in": "serve_int8"})
    # speculative verify (PR 13): B2's and B3's verify shape (40 rows over
    # repeated tables) timed in the paged and ragged phases, and their
    # launches by verify replays on the main path: B2 in serve_spec, B3 in
    # engine_spec (b) (ragged + int8 KV)
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    out[1]["verify"] = {
        "launches": ctx["verify_launches"]["serve_spec"][
            "paged_decode_attention"], "launches_in": "serve_spec",
        **{k: ctx["paged_verify"][k] for k in keys}}
    out[2]["verify"] = {
        "launches": ctx["engine_spec"]["engine_spec (b)"]["verify_walk"][
            "ragged_paged_attention"], "launches_in": "engine_spec (b)",
        **{k: ctx["ragged_verify"]["int8"][k] for k in keys},
        "bf16": {k: ctx["ragged_verify"]["bf16"][k] for k in keys}}
    # B1's cross shapes (mllama): timed in the flash phase, launched by
    # engine_mllama and serve_mllama
    out[0]["cross"] = {
        "launches": {ph: ctx["launches"][ph]["flash_attention"]
                     for ph in ("engine_mllama", "serve_mllama")},
        "shapes": [{k: r[k] for k in keys} for r in ctx["flash_cross"]]}
    # the soft-prefix VLM (LLaVA-1.5-7B): B1's tower and prefix-prefill
    # shapes timed in the flash phase and B2's group of one in the paged
    # phase, launched by engine_llava (a) and serve_llava (B1: the tower
    # and the prefill; B2: decode), B3 by engine_llava (b)
    out[0]["llava"] = {
        "launches": {ph: ctx["launches"][ph]["flash_attention"]
                     for ph in ("engine_llava (a)", "serve_llava")},
        "shapes": [{k: r[k] for k in keys} for r in ctx["flash_llava"]]}
    # Stable Diffusion 2.1: B1's UNet and text-encoder shapes (vii)-(x)
    # timed in the flash phase, launched by engine_sd's batch-1 image
    # (23 + 32 x 25) and by serve_sd's coalesced batch of 4
    out[0]["sd"] = {
        "launches": {ph: ctx["launches"][ph]["flash_attention"]
                     for ph in ("engine_sd", "serve_sd")},
        "shapes": [{k: r[k] for k in keys} for r in ctx["flash_sd"]]}
    # Flux: B1's joint-attention shapes (xi) and (xii) timed in the flash
    # phase, launched by engine_flux (a)'s schnell image (12 + 57 x 4) and
    # by serve_flux's requests
    out[0]["flux"] = {
        "launches": {ph: ctx["launches"][ph]["flash_attention"]
                     for ph in ("engine_flux", "serve_flux")},
        "shapes": [{k: r[k] for k in keys} for r in ctx["flash_flux"]]}
    # the encoder units: B1's shapes (xiii)-(xv) timed in the flash phase,
    # launched by serve_encoders (one a layer a request); the llama unit's
    # dense cache: B1's prefill shapes and B2 over the dense view, timed
    # in the flash and paged phases, launched by serve_causal; B4 under
    # the deepseek unit's int8 weights
    enc = ("bert", "vit", "yolo")
    out[0]["encoders"] = {
        "launches": {k: ctx["launches"][f"serve_encoders {k}"][
            "flash_attention"] for k in enc},
        "shapes": [{k: r[k] for k in keys} for r in ctx["flash_encoders"]]}
    causal = ("serve_causal", "serve_causal deepseek", "serve_causal 8b")
    out[0]["dense"] = {
        "launches": {ph: ctx["launches"][ph]["flash_attention"]
                     for ph in causal},
        "shapes": [{k: r[k] for k in keys} for r in ctx["flash_dense"]]}
    out[1]["dense"] = {
        "launches": {ph: ctx["launches"][ph]["paged_decode_attention"]
                     for ph in causal},
        "shapes": [{k: r[k] for k in keys + ("library",)}
                   for r in ctx["paged_dense"]]}
    out[3]["deepseek_int8_launches"] = ctx["launches"][
        "serve_causal deepseek"]["int8_matmul"]
    out[1]["mha"] = {
        "launches": {ph: ctx["launches"][ph]["paged_decode_attention"]
                     for ph in ("engine_llava (a)", "serve_llava")},
        **{k: ctx["paged_mha"][k] for k in keys}}
    out[2]["llava_launches"] = ctx["launches"]["engine_llava (b)"][
        "ragged_paged_attention"]
    # B3's fused launches: the mixed-row launch timed in the ragged phase,
    # and its launches in serve_fused (every fused and chunk-only replay)
    mixed = ctx["ragged_mixed"]
    out[2]["fused"] = {
        "launches": ctx["launches"]["serve_fused"][
            "ragged_paged_attention"],
        "launches_in": "serve_fused",
        **{k: mixed[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "decode_alone_ms", "chunk_alone_ms")}}
    # one tensor-parallel rank's shapes (TP_PLANS): B1 at the rank-local
    # prefill, B2 and B3 at the B=8 decode shape, B4 at the per-rank
    # projection widths; B1's, B2's and B4's launches in tp_plan's
    # rank-local forward (the engine's over ranks below)
    tp_runs = [k for k in ctx["launches"] if k.startswith("tp_plan ")]
    for i, key in ((0, "flash_ranks"), (1, "paged_ranks"),
                   (2, "ragged_ranks")):
        out[i]["ranks"] = {
            "launches": {k: ctx["launches"][k][out[i]["name"]]
                         for k in tp_runs},
            "shapes": [{k: r[k] for k in keys + ("plans",)}
                       for r in ctx[key]]}
    for i, inst in ((3, "decode"), (4, "wide")):
        out[i]["ranks"] = {
            "launches": {k: ctx["launches"][k][out[i]["name"]]
                         for k in tp_runs},
            "shapes": [{k: r[k] for k in keys + ("plans", "max_ulps")}
                       for r in ctx["int8_ranks"]
                       if r["instantiation"] == inst]}
    # the paged engine over ranks (tp_engine): rank 0's launches in (a),
    # the NCCL group of one, captured; (b), two gloo ranks, bf16; (c), the
    # same under int8 weights, int8 KV and ragged attention
    parts = ("tp_engine (a)", "tp_engine (b)", "tp_engine (c)")
    for row in out:
        row["tp_engine_launches"] = {k: ctx["launches"][k][row["name"]]
                                     for k in parts}
    # the llama and deepseek units over ranks (tp_units): rank 0's
    # launches in (a), the NCCL group of one through the env path; (b),
    # two gloo ranks on the seeded 1B, on llama-8b-geometry and under
    # deepseek's int8 weights
    parts = ("tp_units (a)", "tp_units (b)", "tp_units (b) 8b",
             "tp_units (b) deepseek")
    for row in out:
        row["tp_units_launches"] = {k: ctx["launches"][k][row["name"]]
                                    for k in parts}
    # the flux unit over ranks (tp_diffusion): B1 at a rank's heads timed
    # in the flash phase; its launches by rank 0 in (a), the NCCL group of
    # one, and by rank 0 and the follower in (b), two gloo ranks
    parts = ("tp_diffusion (a) flux", "tp_diffusion (b) flux",
             "tp_diffusion (b) flux follower")
    out[0]["flux_ranks"] = {
        "launches": {k: ctx["launches"][k]["flash_attention"]
                     for k in parts},
        "shapes": [{k: r[k] for k in keys} for r in ctx["flash_flux_ranks"]]}
    for row in out:
        row["tp_diffusion_launches"] = {k: ctx["launches"][k][row["name"]]
                                        for k in parts}
    return {"kernels": out}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import scalable_hw_agnostic_inference_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    ctx = {"timer": Timer(torch)}
    funcs = {name: globals()["phase_" + name] for name in PHASES}
    failed = []
    unwatch = _watch_engines(ctx)
    t_all = time.monotonic()
    for name in phases:
        t0 = time.monotonic()
        ctx["phase"] = name
        log(f"== {name}")
        try:
            funcs[name](ctx)
        except Exception:
            traceback.print_exc()
            sys.stderr.flush()
            failed.append(name)
        log(f"== {name}: {'FAILED' if name in failed else 'ok'} "
            f"({time.monotonic() - t0:.1f} s)")
    log(f"total {time.monotonic() - t_all:.1f} s")
    unwatch()
    log("hbm gate, every engine built: " + json.dumps(ctx.get("gate", [])))
    for key in ("seeded_1b", "seeded_flux"):
        if key in ctx:
            shutil.rmtree(ctx[key].parent, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if phases != list(PHASES):
        log("partial run: no result line")
        return 0
    log(f"card: {ctx['card']}")
    log(json.dumps(kernels_line(ctx)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
