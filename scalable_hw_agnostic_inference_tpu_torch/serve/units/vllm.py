"""Engine-backed text generation unit: paged continuous batching behind
``POST /generate`` and the OpenAI routes.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/serve/units/vllm.py``
(``VllmService``: ``_resolve_ecfg``, ``load`` with the closed set warmed
before the loop starts, ``infer``, ``_collect``, ``_deadline_at``,
``_qos_kw``, ``_result_timeout``, ``extra_stats``, and the OpenAI surface
``:986-1351``: ``/v1/completions``, ``/v1/chat/completions`` and
``/v1/models``, ``stream: true`` as server-sent events, ``n`` parallel
samples, ``logprobs`` through ``_format_logprobs``). ``load`` serves the
``tiny`` tier (seeded random weights, the small engine shapes of the
reference's ``:177-196``; CPU only, its head_dim of 16 is not one the CUDA
kernels take) and the ``*-geometry`` tiers (full-size architecture, zero
weights, real engine shapes); a ``weights`` callable given to the
constructor replaces the tier's weights (the tests hand the port the JAX
service's). The tokenizer is the byte-level ``ByteTokenizer``, so a chat
prompt is the reference's plain ``role: content`` layout. ``n > 1`` is
one fan-out group (``EngineLoop.submit_group``: one tokenization, one
queue item; one prefill with copy-on-write forks under ``SHAI_KV_COW``),
and not streamed. The operating layer's unit half (``:22,307-345``): the
step watchdog behind ``liveness_error`` (built after ``EngineLoop.start``,
so load, warmup and graph capture never trip it; it reads the engine's
last RETIRED step), ``drain`` through ``EngineLoop.drain``, the request
trace (``tokenize`` and ``detokenize`` spans, the engine's queue, prefill
and decode phases grafted under ``model_infer``, ``engine_req_id`` on the
root) and the idempotency key and ``traceparent`` passed to the engine.
Checkpoint loading, chat templates, images, the KV network and migration
come in later slices.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import queue
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ...core.device import resolve_device
from ...engine.config import EngineConfig
from ...engine.types import K_LOGPROBS
from ...models.generate import ByteTokenizer
from ...models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    geometry_params,
    random_params,
)
from ...obs import trace as obs_trace
from ...ops.cuda.flash_attention import HEAD_DIMS
from ...resilience import deadline as rz_deadline
from ...resilience import qos as rz_qos
from ...resilience.drain import StepWatchdog
from ...utils.env import ServeConfig, env_float
from ..app import ModelService
from ..asgi import HTTPError, StreamingResponse
from .common import SseTextAssembler

log = logging.getLogger(__name__)

#: zero-weight full-size tiers: boot with no checkpoint and no network, so
#: the serving stack runs at real shapes (outputs are meaningless)
GEOMETRY_MODELS = {
    "llama-1b-geometry": LlamaConfig.llama32_1b,
    "llama-3b-geometry": LlamaConfig.llama32_3b,
    "llama-8b-geometry": LlamaConfig.llama3_8b,
    "mistral-7b-geometry": LlamaConfig.mistral_7b,
}


class VllmService(ModelService):
    """Continuous batching across concurrent HTTP requests through the
    engine loop; ``concurrency`` widens the model lane to the slot count so
    requests reach the loop together and share decode steps."""

    task = "text-generation"
    infer_route = "/generate"

    def __init__(self, cfg: ServeConfig,
                 weights: Optional[Callable[[LlamaConfig, torch.device],
                                            Dict[str, torch.Tensor]]] = None):
        """``weights(model_config, device)``, when given, returns the state
        dict ``load`` serves instead of the tier's own weights."""
        super().__init__(cfg)
        self._weights = weights
        self._openai_ids = itertools.count()
        # a bad ConfigMap must not crash construction: the error surfaces
        # from load() as a readiness failure instead of a crash loop
        self._ecfg_error: Optional[Exception] = None
        self._engine = None
        self.loop = None
        self._watchdog: Optional[StepWatchdog] = None
        self.warm_seconds = 0.0
        try:
            self.ecfg = self._resolve_ecfg(cfg)
            self.concurrency = self.ecfg.max_num_seqs
        except Exception as e:
            self.ecfg = None
            self._ecfg_error = e
            self.concurrency = 1

    @staticmethod
    def _resolve_ecfg(cfg: ServeConfig) -> EngineConfig:
        if os.path.exists(cfg.vllm_config):
            ecfg = EngineConfig.from_yaml(cfg.vllm_config)
            if ecfg.ignored_keys:
                log.info("vllm_config: ignoring keys %s", ecfg.ignored_keys)
            return ecfg
        # the largest bucket must reach MAX_SEQ_LEN (block-aligned up) or
        # long prompts truncate below the advertised limit
        top = -(-cfg.max_seq_len // 16) * 16
        buckets = sorted({b for b in (128, 512, 2048) if b < top} | {top})
        return EngineConfig(
            model=cfg.model_id,
            max_model_len=-(-(cfg.max_seq_len + cfg.max_new_tokens) // 16) * 16,
            max_num_seqs=max(cfg.batch_size, 4),
            block_size=16,
            context_encoding_buckets=tuple(buckets),
            max_new_tokens=cfg.max_new_tokens,
            quantization=cfg.quantization or None,
        )

    def load(self) -> None:
        from ...engine.engine import LLMEngine, SamplingParams
        from ...engine.loop import EngineLoop

        if self._ecfg_error is not None:
            raise self._ecfg_error
        cfg, ecfg = self.cfg, self.ecfg
        device = resolve_device(cfg.device)
        model_id = ecfg.model or cfg.model_id
        if model_id in ("", "tiny"):
            mcfg = LlamaConfig.tiny()
            # tiny engine shapes: small blocks and buckets so CI exercises
            # paging (geometry tiers keep their real engine shapes)
            ecfg = EngineConfig(
                model="tiny", max_model_len=256,
                max_num_seqs=ecfg.max_num_seqs, block_size=16,
                context_encoding_buckets=(32, 64, 128),
                token_generation_buckets=ecfg.token_generation_buckets,
                tensor_parallel_size=ecfg.tensor_parallel_size,
                quantization=ecfg.quantization,
                enable_prefix_caching=ecfg.enable_prefix_caching,
                max_new_tokens=min(ecfg.max_new_tokens, 64),
                role=ecfg.role)
        elif model_id in GEOMETRY_MODELS:
            mcfg = GEOMETRY_MODELS[model_id]()
        else:
            raise ValueError(
                f"model {model_id!r}: this port serves the 'tiny' and "
                f"geometry tiers ({', '.join(GEOMETRY_MODELS)}); checkpoint "
                f"loading is not ported yet")
        if device.type == "cuda" and mcfg.head_dim not in HEAD_DIMS:
            raise ValueError(
                f"model {model_id or 'tiny'!r} has head_dim {mcfg.head_dim}; "
                f"the CUDA attention kernels take head_dim in {HEAD_DIMS}. "
                f"Serve a geometry tier ({', '.join(GEOMETRY_MODELS)}) on "
                f"cuda, or this model with DEVICE=cpu")
        if self._weights is not None:
            state = self._weights(mcfg, device)
        elif model_id in GEOMETRY_MODELS:
            state = geometry_params(mcfg, dtype=torch.bfloat16, device=device)
        else:
            state = random_params(mcfg, cfg.seed, dtype=torch.float32,
                                  device=device)
        self.ecfg = ecfg
        model = LlamaForCausalLM.from_state_dict(mcfg, state)
        self.tokenizer = ByteTokenizer()
        self.eos_id = ByteTokenizer.eos_id
        engine = LLMEngine(mcfg, model, ecfg, device=device)
        # build the CLOSED executable set (every prefill bucket and batch
        # size, the continuation keys, every decode key captured as a CUDA
        # graph) BEFORE the engine loop starts serving, so no request
        # after readiness builds one
        t0 = time.monotonic()
        n = engine.warm_executables()
        self.warm_seconds = time.monotonic() - t0
        log.info("engine: warmed %d executables in %.1f s (buckets=%s)", n,
                 self.warm_seconds, list(engine.buckets.buckets))
        self._engine = engine
        self._SamplingParams = SamplingParams
        self.loop = EngineLoop(engine).start()
        # step watchdog (liveness): work pending but no step retiring for
        # max(SHAI_WATCHDOG_MIN_S, SHAI_WATCHDOG_MULT x p99 step) fails
        # /health. Built after the loop starts: load, warmup and every
        # graph capture are behind us
        self._watchdog = StepWatchdog(
            lambda: engine.obs, lambda: engine.has_work,
            multiplier=env_float("SHAI_WATCHDOG_MULT", 30.0),
            min_stall_s=env_float("SHAI_WATCHDOG_MIN_S", 10.0))

    def close(self) -> None:
        if self.loop is not None:
            self.loop.stop()

    def ready_error(self) -> Optional[str]:
        if self.loop is not None and not self.loop.alive:
            return "engine loop is not running"
        return None

    def liveness_error(self) -> Optional[str]:
        return None if self._watchdog is None else self._watchdog.check()

    def drain(self, budget_s: float) -> None:
        """SIGTERM: let queued and running requests finish within the
        budget, then stop the loop with no replay left in flight
        (outstanding futures fail on the way out)."""
        if self.loop is not None:
            self.loop.drain(budget_s)

    def engine_telemetry(self):
        return None if self._engine is None else self._engine.obs

    def _encode(self, text: str) -> List[int]:
        """Byte ids with BOS, cut to the engine's chunked-prefill cap (not
        the largest bucket: longer prompts chunk)."""
        with obs_trace.span("tokenize"):
            ids, n = self.tokenizer.encode(text, self._engine.max_prompt_len)
            return [int(i) for i in ids[:n]]

    def _decode(self, ids) -> str:
        return self.tokenizer.decode(ids)

    def example_payload(self) -> Dict[str, Any]:
        return {"prompt": "the quick brown fox", "temperature": 0.0,
                "max_new_tokens": 8}

    def _sampling_from(self, payload: Dict[str, Any]):
        """Validated SamplingParams from a request payload (400 on bad
        values; an over-cap max_new_tokens is a client error, not a silent
        clamp)."""
        mnt = payload.get("max_new_tokens")
        try:
            mnt = self.ecfg.max_new_tokens if mnt is None else int(mnt)
            params = self._SamplingParams(
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                max_new_tokens=mnt,
                eos_id=self.eos_id,
                logprobs=int(payload.get("logprobs") or 0),
            )
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad sampling parameter: {e}")
        if not 0 <= params.logprobs <= K_LOGPROBS:
            raise HTTPError(400, f"logprobs must be in [0, {K_LOGPROBS}]")
        if mnt < 1:
            raise HTTPError(400, "max_new_tokens must be >= 1")
        if mnt > self.ecfg.max_new_tokens:
            raise HTTPError(
                400,
                f"max_new_tokens={mnt} exceeds this deployment's engine cap "
                f"MAX_NEW_TOKENS={self.ecfg.max_new_tokens}")
        return params

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "prompt" not in payload and "text" not in payload:
            raise HTTPError(400, "missing 'prompt'")
        if payload.get("image_b64"):
            raise HTTPError(400, "multimodal requests are not served by this "
                                 "port yet")
        prompt = str(payload.get("prompt", payload.get("text", "")))
        ids = self._encode(prompt)
        params = self._sampling_from(payload)
        return self._collect(self.loop.submit(
            ids, params, deadline_at=self._deadline_at(),
            traceparent=obs_trace.current_traceparent() or "",
            idem_key=str(payload.get("idem_key") or ""), **self._qos_kw()))

    @staticmethod
    def _deadline_at() -> float:
        """The request's deadline as an absolute monotonic instant for the
        engine (0 = none), set by the serving layer on the context the
        model lane runs under."""
        dl = rz_deadline.current_deadline()
        return 0.0 if dl is None else dl.at

    @staticmethod
    def _qos_kw() -> Dict[str, Any]:
        """The request's tenant/priority tag for ``EngineLoop.submit``,
        carried the contextvars way as the deadline."""
        tag = rz_qos.current_qos()
        if tag is None:
            return {}
        return {"priority": tag.priority, "tenant": tag.tenant}

    @staticmethod
    def _result_timeout() -> float:
        """How long to block on an engine future: past the deadline (plus
        step slack for the engine's own expiry to land), or 600 s for a
        request without one."""
        dl = rz_deadline.current_deadline()
        if dl is None:
            return 600.0
        return max(0.1, dl.remaining_s) + 30.0

    def _collect(self, fut) -> Dict[str, Any]:
        """Await one engine future and shape the result: THE translation
        from Finished to the serving dict (rejected -> 503, timeout ->
        504), shared by infer and the OpenAI ``n > 1`` samples."""
        fin = fut.result(timeout=self._result_timeout())
        # graft the engine's phase timeline onto the request trace, under
        # the live span (model_infer): queue, prefill and decode ran on the
        # loop thread; the root carries the engine request id, the join
        # key with the step records' finished_ids (first id wins for n>1)
        tr = obs_trace.current_trace()
        if tr is not None and fin.timing:
            tr.add_phase_spans(fin.timing, parent=obs_trace.current_span())
            tr.root.attrs.setdefault("engine_req_id", fin.req_id)
        if fin.stop_reason == "rejected":
            raise HTTPError(503, "request rejected: prompt cannot fit the KV "
                                 "pool")
        if fin.stop_reason == "timeout":
            raise HTTPError(
                504, f"deadline exceeded: request timed out in the engine "
                     f"after {len(fin.token_ids)} tokens")
        with obs_trace.span("detokenize"):
            text = self._decode(fin.token_ids)
        out = {
            "generated_text": text,
            "n_tokens": len(fin.token_ids),
            "n_prompt": fin.n_prompt,
            "stop_reason": fin.stop_reason,
        }
        if fin.logprobs is not None:
            out["logprobs"] = fin.logprobs
        return out

    def extra_stats(self) -> Dict[str, float]:
        eng = self._engine
        out = {
            "queue_waiting": eng.n_waiting,
            "seqs_running": eng.n_running,
            "seqs_chunking": eng.n_chunking,
            "blocks_free": eng.cache.allocator.n_free,
            "blocks_total": self.ecfg.total_blocks,
            "executables": eng.n_executables,
        }
        if eng.ttft.count:
            rep = eng.ttft.report()
            out["ttft_p50_ms"] = round(rep["p50"] * 1e3, 2)
            out["ttft_p99_ms"] = round(rep["p99"] * 1e3, 2)
        if eng.tpot.count:
            out["tpot_p50_ms"] = round(eng.tpot.report()["p50"] * 1e3, 2)
        # async decode pipeline health: flushes (serialization events, one
        # flat key per reason) and the realized inter-step gap, near zero
        # when the lookahead hides the host work (SHAI_ASYNC_DECODE)
        out["pipeline_flushes"] = eng.obs.pipeline_flushes
        for reason, n in eng.obs.flush_reasons().items():
            out[f"pipeline_flush_{reason}"] = n
        gap = eng.obs.step_gap.snapshot()
        if gap["count"]:
            out["step_gap_mean_ms"] = round(
                gap["sum"] / gap["count"] * 1e3, 4)
        return out

    # -- OpenAI-compatible surface ------------------------------------------

    def _default_max_tokens(self, kind: str) -> int:
        # 16 is the legacy /v1/completions default; chat has none, so a
        # chat client omitting max_tokens gets the engine cap
        return (self.ecfg.max_new_tokens if kind == "chat"
                else min(16, self.ecfg.max_new_tokens))

    def _openai_generate(self, prompt: str, body: Dict[str, Any],
                         kind: str) -> Dict[str, Any]:
        n = self._openai_n(body)
        # logprobs: completions takes an int (capped at K_LOGPROBS, over
        # the cap is a 400); chat takes a bool plus top_logprobs, of which
        # up to K_LOGPROBS are served and exactly the requested count is
        # formatted (0 = the sampled token's logprob only)
        if kind == "chat":
            want_lp = top_n = 0
            if body.get("logprobs"):
                top_n = min(int(body.get("top_logprobs") or 0), K_LOGPROBS)
                want_lp = max(1, top_n)
        else:
            want_lp = top_n = int(body.get("logprobs") or 0)
        payload = {
            "prompt": prompt,
            "temperature": body.get("temperature", 1.0),
            "top_p": body.get("top_p", 1.0),
            "max_new_tokens": body.get("max_tokens",
                                       self._default_max_tokens(kind)),
            "logprobs": want_lp,
        }
        if n == 1:
            outs = [self.infer(payload)]
        else:
            # n samples of one tokenization: one fan-out group, one queue
            # item, one parent id (cancel and deadline act on the group;
            # under SHAI_KV_COW the group prefills once and forks its KV)
            params = self._sampling_from(payload)
            ids = self._encode(prompt)
            futs = self.loop.submit_group(
                ids, [params] * n, deadline_at=self._deadline_at(),
                traceparent=obs_trace.current_traceparent() or "",
                **self._qos_kw())
            outs = []
            try:
                for fut in futs:
                    outs.append(self._collect(fut))
            except BaseException:
                # one sample failed (rejected, timeout): the others must
                # not keep decoding for nobody (cancelling one cancels the
                # group)
                for fut in futs:
                    if not fut.done():
                        self.loop.cancel(fut)
                raise
        stop = body.get("stop")
        # falsy stops are dropped: '' would cut everything at position 0
        stops = [s for s in
                 ([stop] if isinstance(stop, str) else list(stop or [])) if s]
        choices = []
        total_completion = 0
        for i, out in enumerate(outs):
            text = out["generated_text"]
            finish = "stop" if out["stop_reason"] == "eos" else "length"
            for s in stops:
                cut = text.find(s)
                if cut >= 0:
                    text = text[:cut]
                    finish = "stop"
            total_completion += out["n_tokens"]
            lp_field = None
            if out.get("logprobs") is not None:
                entries = out["logprobs"]
                if finish == "stop" and stops:
                    # the entries cover exactly the returned text: keep the
                    # shortest token prefix whose decode reaches it
                    keep = 0
                    while (keep < len(entries)
                           and len(self._decode(
                               [e["token"] for e in entries[:keep]]))
                           < len(text)):
                        keep += 1
                    entries = entries[:keep]
                lp_field = self._format_logprobs(entries, kind, top_n)
            if kind == "chat":
                choices.append({"index": i, "finish_reason": finish,
                                "logprobs": lp_field,
                                "message": {"role": "assistant",
                                            "content": text}})
            else:
                choices.append({"index": i, "finish_reason": finish,
                                "logprobs": lp_field, "text": text})
        usage = {"prompt_tokens": outs[0]["n_prompt"],
                 "completion_tokens": total_completion,
                 "total_tokens": outs[0]["n_prompt"] + total_completion}
        return {"id": f"shai-{next(self._openai_ids)}",
                "created": int(time.time()),
                "model": self.cfg.model_id or "tiny", "usage": usage,
                "object": ("chat.completion" if kind == "chat"
                           else "text_completion"),
                "choices": choices}

    def _format_logprobs(self, entries, kind: str, top_n: int):
        """Engine logprob entries -> the OpenAI response shape of ``kind``,
        with exactly ``top_n`` alternatives per token."""
        def tok_str(tid: int) -> str:
            return self._decode([tid])

        if kind == "chat":
            return {"content": [
                {"token": tok_str(e["token"]), "logprob": e["logprob"],
                 "top_logprobs": [
                     {"token": tok_str(t), "logprob": lp}
                     for t, lp in zip(e["top_ids"][:top_n],
                                      e["top_logprobs"][:top_n])]}
                for e in entries]}
        return {
            "tokens": [tok_str(e["token"]) for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [
                {tok_str(t): lp
                 for t, lp in zip(e["top_ids"][:top_n],
                                  e["top_logprobs"][:top_n])}
                for e in entries],
        }

    def _openai_stream(self, prompt: str, body: Dict[str, Any], kind: str):
        """SSE token stream (OpenAI ``stream: true``): the engine's
        ``on_token`` puts each token onto a queue (nothing more, on the
        engine-loop thread), and the request's future puts an end marker
        behind the last one when it resolves; the response generator
        decodes incrementally on a stream thread, holding back partial
        UTF-8 sequences and stop prefixes, and ends with ``data:
        [DONE]``. Closing the generator (a client disconnect) cancels the
        request in the engine."""
        if self._openai_n(body) != 1:
            raise HTTPError(400, "n > 1 is not supported with stream: true")
        if body.get("logprobs"):
            raise HTTPError(400, "logprobs are not supported with "
                                 "stream: true")
        ids = self._encode(prompt)
        params = self._sampling_from({
            "temperature": body.get("temperature", 1.0),
            "top_p": body.get("top_p", 1.0),
            "max_new_tokens": body.get("max_tokens",
                                       self._default_max_tokens(kind))})
        stop = body.get("stop") or []
        stops = [stop] if isinstance(stop, str) else list(stop)
        tokq: "queue.Queue[Any]" = queue.Queue()
        end = object()
        fut = self.loop.submit(
            ids, params, on_token=tokq.put, deadline_at=self._deadline_at(),
            traceparent=obs_trace.current_traceparent() or "",
            **self._qos_kw())
        # the stream drains on a stream thread, outside the request's
        # context: keep its trace and span to graft the phases onto
        req_trace = obs_trace.current_trace()
        req_span = obs_trace.current_span()
        # the loop resolves the future after the last on_token call, so
        # the marker lands behind every token (the reference polls the
        # future every 0.2 s instead)
        fut.add_done_callback(lambda f: tokq.put(end))
        # read HERE, in the handler's context: the generator runs on a
        # stream thread, where the request's contextvars are absent
        result_timeout = self._result_timeout()
        rid = f"shai-{next(self._openai_ids)}"
        created = int(time.time())
        model = self.cfg.model_id or "tiny"

        def event(delta: str, finish, first: bool) -> str:
            if kind == "chat":
                d: Dict[str, Any] = {}
                if first:
                    d["role"] = "assistant"
                if delta:
                    d["content"] = delta
                choice = {"index": 0, "delta": d, "finish_reason": finish}
                obj = "chat.completion.chunk"
            else:
                choice = {"index": 0, "text": delta, "finish_reason": finish}
                obj = "text_completion"
            return "data: " + json.dumps(
                {"id": rid, "object": obj, "created": created,
                 "model": model, "choices": [choice]}) + "\n\n"

        def error(message: str, kind_: str) -> str:
            # the headers went out as 200: errors are signalled in-band
            return ("data: " + json.dumps({"error": {
                "message": message, "type": kind_}}) + "\n\n")

        asm = SseTextAssembler(self._decode, stops)

        def chunks():
            first = True
            finish = None
            try:
                if kind == "chat":
                    yield event("", None, True)  # the role preamble
                    first = False
                while True:
                    tok = tokq.get()
                    if tok is end:
                        break
                    delta = asm.push(tok)
                    if delta:
                        yield event(delta, None, first)
                        first = False
                    if asm.stopped:
                        # a stop string: abort and reclaim the slot
                        finish = "stop"
                        self.loop.cancel(fut)
                        break
                fin = fut.result(timeout=result_timeout)
                if req_trace is not None and fin.timing:
                    req_trace.add_phase_spans(fin.timing, parent=req_span)
                    req_trace.root.attrs.setdefault("engine_req_id",
                                                    fin.req_id)
                if fin.stop_reason == "rejected":
                    yield error("request rejected: prompt cannot fit the "
                                "KV pool", "server_error")
                    yield "data: [DONE]\n\n"
                    return
                if fin.stop_reason == "timeout":
                    # the tokens already sent stand
                    yield error("deadline exceeded: generation timed out "
                                "in the engine", "timeout_error")
                    yield "data: [DONE]\n\n"
                    return
                if finish is None:
                    finish = "stop" if fin.stop_reason == "eos" else "length"
                    tail = asm.finish()  # the partial-UTF-8 holdback
                    if tail:
                        yield event(tail, None, first)
                        first = False
                yield event("", finish, False)
                yield "data: [DONE]\n\n"
            finally:
                # a client disconnect closes the generator mid-stream: the
                # engine must not keep decoding into an orphan queue
                if not fut.done():
                    self.loop.cancel(fut)

        return StreamingResponse(chunks())

    @staticmethod
    def _chat_prompt(messages) -> str:
        """Messages -> prompt text: ``role: content`` lines and an
        ``assistant:`` cue (the reference's layout without a chat
        template)."""
        if not isinstance(messages, list) or not messages:
            raise HTTPError(400, "messages must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m or "content" not in m:
                raise HTTPError(400, "each message needs role and content")
        lines = [f"{m['role']}: {m['content']}" for m in messages]
        return "\n".join(lines) + "\nassistant:"

    def _openai_n(self, body: Dict[str, Any]) -> int:
        """Validated OpenAI ``n`` (parallel samples)."""
        n = body.get("n")
        if n is None:
            n = 1
        if not isinstance(n, int) or isinstance(n, bool):
            raise HTTPError(400, "n must be an integer")
        if not 1 <= n <= self.ecfg.max_num_seqs:
            raise HTTPError(
                400, f"n must be in [1, {self.ecfg.max_num_seqs}] "
                     f"(the engine's slot batch)")
        return n

    def extra_routes(self):
        def completions(request):
            body = request.json()
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                if len(prompt) != 1:
                    raise HTTPError(400, "exactly one prompt per request")
                prompt = prompt[0]
            if not isinstance(prompt, str):
                raise HTTPError(400, "missing 'prompt'")
            if body.get("stream"):
                return self._openai_stream(prompt, body, "completion")
            return self._openai_generate(prompt, body, "completion")

        def chat(request):
            body = request.json()
            prompt = self._chat_prompt(body.get("messages"))
            if body.get("stream"):
                return self._openai_stream(prompt, body, "chat")
            return self._openai_generate(prompt, body, "chat")

        def models(request):
            return {"object": "list",
                    "data": [{"id": self.cfg.model_id or "tiny",
                              "object": "model", "owned_by": "shai-cuda"}]}

        return [("/v1/completions", ("POST",), completions),
                ("/v1/chat/completions", ("POST",), chat),
                ("/v1/models", ("GET",), models)]
