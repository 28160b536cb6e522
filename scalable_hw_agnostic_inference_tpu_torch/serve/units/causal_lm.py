"""The dense-cache text-generation unit, registered as ``llama``,
``mistral`` and ``deepseek``: ``POST /generate`` and ``POST /sentiment``.

Port of ``scalable_hw_agnostic_inference_tpu/serve/units/causal_lm.py``
(``LlamaService``, ``_load_causal_lm``, ``_geometry_models``): one
``make_generate`` per prompt bucket (``models/generate.py``: the prefill
on B1, every decode step on B2 over the dense cache), buckets of powers of
two from ``min(32, max_prompt)`` up to ``max_prompt = min(MAX_SEQ_LEN,
max_seq_len - MAX_NEW_TOKENS)``; the smallest is run before readiness
(the warmup request), larger ones on first use. The responses are the
reference's: ``{"generated_text", "n_tokens"}``, a 400 for
``max_new_tokens`` past ``MAX_NEW_TOKENS`` or an empty prompt, and
``{"sentiment"}`` from the reference's prompt template.

- ``MODEL_ID=tiny`` (or empty): ``LlamaConfig.tiny`` in fp32 with seeded
  random weights drawn by torch, the byte-level tokenizer. CPU only: its
  head size of 16 is outside B1 and B2.
- ``MODEL_ID=llama-1b-geometry`` (``-3b``, ``-8b``,
  ``mistral-7b-geometry``): the full-size architecture with zero weights
  in bf16 (born int8 under quantization), the byte-level tokenizer:
  real shapes, meaningless text.
- ``MODEL_ID=<directory>``: a local HF Llama or Mistral checkpoint read by
  the ``vllm`` unit's readers (``models.convert.load_hf_checkpoint``,
  ``models.tokenizer.BpeTokenizer`` with its ``special_tokens_map``),
  bf16; EOS from the tokenizer, PAD its pad token or EOS.
- ``QUANTIZATION=int8``: every projection int8 (``quantize_state_dict``,
  ``QuantLinear``), so each runs on B4 on the card.
- The dense cache is bf16 on the card, fp32 on the CPU (the reference's
  rule). Sampling draws from a torch generator seeded by the request's
  ``seed``: greedy text is the reference's, sampled text is not a JAX
  pod's for the same seed (``ROADMAP.md`` C).
- ``SUBMESH`` or ``MESH_SPEC`` naming one device places the unit on it.
- ``MESH_SPEC=tp=N`` (the ``llama`` and ``mistral`` manifests' ``tp=4``,
  the multi-host ones' ``tp=16`` and ``tp=32`` with ``SHAI_COORDINATOR``)
  runs the unit as N ranks, one process each (``serve.multihost``, which
  mirrors every call of :attr:`LlamaService.mirror_methods` to the
  followers, as the reference's ``supports_multihost`` contract,
  ``causal_lm.py:308-309``, asks). At ``load()`` every rank prices its
  load (``core.budget.dense_lm_budget``: its shard, its caches, the
  widest prefill) against its card before it reads a weight, then reads
  the whole state dict once (:meth:`LlamaService.read_state`, the one
  seam) on the CPU, one entry at a time (a checkpoint's through the
  mapped files, which the ranks of a host share in the page cache): each
  entry is quantized under int8, its kv heads widened to tp where tp
  exceeds them (``replicate_kv_heads``), and only the rank's slice of it
  (``shard_state_dict`` over ``tp_rules``) placed on the card
  (``engine.ranks.stream_rank_state``); then the rank-local model is
  built over its group; bf16 and int8 alike. A request that one rank
  rejects (a 400) is rejected by every rank before any device work: the
  knobs and the prompt are checked inside the mirrored call, on every
  rank alike.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ...core.bucketing import BucketRegistry, pow2_buckets
from ...core.budget import HbmBudget, dense_lm_budget, detect_hbm_gib
from ...engine.ranks import stream_rank_state
from ...models.convert import config_from_hf, hf_checkpoint_items, read_config
from ...models.generate import ByteTokenizer, cache_dtype_for, make_generate
from ...models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    geometry_items,
    random_params,
)
from ...models.tokenizer import BpeTokenizer
from ...utils.env import env_bool
from ..app import ModelService
from ..asgi import HTTPError
from .common import check_head_size, unit_ranks
from .vllm import GEOMETRY_MODELS

#: the reference's ``/sentiment`` prompt (``causal_lm.py:427-430``)
SENTIMENT_PROMPT = ("Classify the sentiment of the following review as "
                    "Positive or Negative.\nReview: {text}\nSentiment:")


class LlamaService(ModelService):
    """Text generation: the reference's ``run-llama.py`` (Llama-3,
    Mistral) and ``deepseek_model_api.py`` (a causal LM behind the same
    routes)."""

    task = "text-generation"
    infer_route = "/generate"
    # every device entry (infer, /sentiment, the default warmup) funnels
    # through generate_text, so mirroring it covers the whole surface
    supports_multihost = True
    mirror_methods = ("generate_text",)

    def __init__(self, cfg, weights=None):
        """``weights(model_config, device)``, when given, returns the
        whole state dict ``load`` serves in place of the tiny or geometry
        tier's own weights (each rank calls it, with the CPU as the device
        where the unit runs over several ranks)."""
        super().__init__(cfg)
        self._weights = weights
        #: the rank's priced load (``core.budget.dense_lm_budget``), where
        #: the gate ran: on the card, or under ``SHAI_ENFORCE_HBM=1``
        self.hbm_budget: Optional[HbmBudget] = None

    def load(self) -> None:
        cfg = self.cfg
        device, group = unit_ranks(cfg, multihost=True, group=self.group)
        tp, rank = (group.size, group.rank) if group else (1, 0)
        quant = cfg.quantization == "int8"
        mcfg, dtype = self.read_config()
        what = repr(cfg.model_id or "tiny")
        check_head_size(mcfg.head_dim, device, what)
        max_prompt = min(cfg.max_seq_len,
                         mcfg.max_seq_len - cfg.max_new_tokens)
        if max_prompt < 1:
            raise ValueError(
                f"MAX_NEW_TOKENS={cfg.max_new_tokens} leaves no prompt room "
                f"within the model's max_seq_len={mcfg.max_seq_len}")
        buckets = pow2_buckets(min(32, max_prompt), max_prompt)
        # the rank's load priced before any weight is read or placed
        if device.type == "cuda" or env_bool("SHAI_ENFORCE_HBM", False):
            self.hbm_budget = dense_lm_budget(
                mcfg, tp=tp, quantization=cfg.quantization or None,
                prompt_buckets=buckets, max_new_tokens=cfg.max_new_tokens,
                hbm_gib_per_chip=detect_hbm_gib(device), what=what,
                dtype=str(dtype).split(".")[-1],
                cache_bytes=cache_dtype_for(device).itemsize).check()
        # a rank of several reads the whole model on the CPU, one entry at
        # a time, and places only its shard on its device
        source = device if tp == 1 else torch.device("cpu")
        mcfg, state = stream_rank_state(
            mcfg, self.read_state(mcfg, source, quant), tp, rank, device,
            quantize=quant)
        self.mcfg = mcfg
        self.model = LlamaForCausalLM.from_state_dict(mcfg, state,
                                                      dtype=dtype,
                                                      group=group)
        self._byte_tok = isinstance(self.tokenizer, ByteTokenizer)
        self.buckets = BucketRegistry(buckets)
        self._gen: Dict[int, Any] = {}

    def read_config(self):
        """``(model config, compute dtype)`` of the model ``MODEL_ID``
        names, read before any weight (the tokenizer, EOS and PAD set on
        the way): the tiny tier (fp32), a geometry tier, or a checkpoint
        directory's ``config.json``."""
        cfg = self.cfg
        model_id = cfg.model_id
        self.tokenizer = ByteTokenizer()
        self.eos_id, self.pad_id = ByteTokenizer.eos_id, ByteTokenizer.pad_id
        if model_id in ("", "tiny"):
            return LlamaConfig.tiny(), torch.float32
        if model_id in GEOMETRY_MODELS:
            return GEOMETRY_MODELS[model_id](), torch.bfloat16
        if os.path.isdir(model_id):
            tok = BpeTokenizer.from_dir(model_id)
            if tok.eos_token_id is None:
                raise ValueError(f"tokenizer for {model_id} has no "
                                 f"eos_token_id")
            self.tokenizer = tok
            self.eos_id = int(tok.eos_token_id)
            self.pad_id = (self.eos_id if tok.pad_token_id is None
                           else int(tok.pad_token_id))
            return config_from_hf(read_config(model_id)), torch.bfloat16
        raise ValueError(
            f"model {model_id!r} is not a directory: this port serves "
            f"the 'tiny' and geometry tiers ({', '.join(GEOMETRY_MODELS)})"
            f" and local checkpoint directories (config.json, "
            f"*.safetensors, tokenizer.json); it fetches nothing from a "
            f"hub")

    def read_state(self, mcfg: LlamaConfig, device: torch.device,
                   quant: bool) -> Iterable[Tuple[str, torch.Tensor]]:
        """The whole model's state, the one seam where it is read before
        any sharding: its ``(name, tensor)`` entries on ``device``, each
        made or read when it is taken. The tiny tier's seeded fp32
        weights, a geometry tier's zeros (born int8 under ``quant``), or a
        checkpoint directory's; ``weights``, when given, in place of a
        tier's."""
        model_id = self.cfg.model_id
        if self._weights is not None and not os.path.isdir(model_id):
            return self._weights(mcfg, device).items()
        if model_id in ("", "tiny"):
            return random_params(mcfg, self.cfg.seed, dtype=torch.float32,
                                 device=device).items()
        if model_id in GEOMETRY_MODELS:
            return geometry_items(mcfg, dtype=torch.bfloat16, device=device,
                                  quant=quant)
        return hf_checkpoint_items(model_id, device)[1]

    def _gen_for(self, bucket: int):
        if bucket not in self._gen:
            self._gen[bucket] = make_generate(
                self.model, self.mcfg, prompt_bucket=bucket,
                max_new_tokens=self.cfg.max_new_tokens, eos_id=self.eos_id,
                pad_id=self.pad_id)
        return self._gen[bucket]

    def _encode(self, text: str):
        if self._byte_tok:
            ids, n = self.tokenizer.encode(text, self.buckets.max)
            ids = ids[:n]
        else:
            ids = np.asarray(self.tokenizer.encode(
                text, max_length=self.buckets.max), np.int32)
        if len(ids) == 0:
            raise HTTPError(400, "empty prompt")
        bucket = self.buckets.bucket_for(len(ids))
        padded = np.full((1, bucket), self.pad_id, np.int32)
        padded[0, :len(ids)] = ids
        return padded, np.array([len(ids)], np.int32), bucket

    def _decode(self, ids) -> str:
        ids = [int(i) for i in ids if int(i) not in (self.pad_id,
                                                     self.eos_id)]
        if self._byte_tok:
            return self.tokenizer.decode(ids)
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    def example_payload(self) -> Dict[str, Any]:
        return {"prompt": "the quick brown fox", "temperature": 0.0}

    def generate_ids(self, prompt: str, temperature=1.0, top_k=0, top_p=1.0,
                     max_new_tokens: Optional[int] = None,
                     seed: int = 0) -> np.ndarray:
        """The generated ids of one prompt (PAD after EOS), cut to
        ``max_new_tokens``. A knob that is no number, a value past
        ``MAX_NEW_TOKENS`` or an empty prompt is a 400, raised before any
        device work (on every rank alike, where the call is mirrored)."""
        try:
            knobs = dict(seed=int(seed), temperature=float(temperature),
                         top_k=int(top_k), top_p=float(top_p))
            cut = None if max_new_tokens is None else int(max_new_tokens)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad sampling knob: {e}")
        if cut is not None and cut > self.cfg.max_new_tokens:
            raise HTTPError(
                400,
                f"max_new_tokens={max_new_tokens} exceeds this deployment's "
                f"compiled cap MAX_NEW_TOKENS={self.cfg.max_new_tokens}")
        ids, n, bucket = self._encode(prompt)
        toks = self._gen_for(bucket)(ids, n, **knobs).tokens.cpu().numpy()[0]
        if cut is not None:
            toks = toks[:max(cut, 0)]
        return toks

    def generate_text(self, prompt: str, temperature=1.0, top_k=0,
                      top_p=1.0, max_new_tokens: Optional[int] = None,
                      seed: int = 0):
        toks = self.generate_ids(prompt, temperature, top_k, top_p,
                                 max_new_tokens, seed)
        return self._decode(toks), int(np.sum(toks != self.pad_id))

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        prompt = str(payload.get("prompt", payload.get("text", "")))
        text, n_gen = self.generate_text(
            prompt,
            temperature=float(payload.get("temperature", 1.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            max_new_tokens=payload.get("max_new_tokens"),
            seed=int(payload.get("seed", 0)),
        )
        return {"generated_text": text, "n_tokens": n_gen}

    def extra_routes(self):
        def sentiment(request):
            text = str(request.json().get("text", ""))
            out, _ = self.generate_text(SENTIMENT_PROMPT.format(text=text),
                                        temperature=0.0)
            return {"sentiment": out.strip().split("\n")[0]}

        return [("/sentiment", ("POST",), sentiment)]
