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
- ``SUBMESH`` or ``MESH_SPEC`` naming one device places the unit on it;
  naming more (the ``llama`` and ``mistral`` manifests' ``tp=4``) is tensor
  parallelism (ROADMAP A7): ``load()`` refuses it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core.bucketing import BucketRegistry, pow2_buckets
from ...models.convert import load_hf_checkpoint
from ...models.generate import ByteTokenizer, make_generate
from ...models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    geometry_params,
    random_params,
)
from ...models.tokenizer import BpeTokenizer
from ...ops.quant import quantize_state_dict
from ..app import ModelService
from ..asgi import HTTPError
from .common import check_head_size, unit_device
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

    def load(self) -> None:
        cfg = self.cfg
        device = unit_device(cfg)
        quant = cfg.quantization == "int8"
        model_id = cfg.model_id
        self.tokenizer = ByteTokenizer()
        self.eos_id, self.pad_id = ByteTokenizer.eos_id, ByteTokenizer.pad_id
        dtype = torch.bfloat16
        if model_id in ("", "tiny"):
            mcfg = LlamaConfig.tiny()
            state = random_params(mcfg, cfg.seed, dtype=torch.float32,
                                  device=device)
            dtype = torch.float32
        elif model_id in GEOMETRY_MODELS:
            mcfg = GEOMETRY_MODELS[model_id]()
            state = geometry_params(mcfg, dtype=torch.bfloat16,
                                    device=device, quant=quant)
        elif os.path.isdir(model_id):
            tok = BpeTokenizer.from_dir(model_id)
            if tok.eos_token_id is None:
                raise ValueError(f"tokenizer for {model_id} has no "
                                 f"eos_token_id")
            self.tokenizer = tok
            self.eos_id = int(tok.eos_token_id)
            self.pad_id = (self.eos_id if tok.pad_token_id is None
                           else int(tok.pad_token_id))
            mcfg, state = load_hf_checkpoint(model_id, device,
                                             quantize=quant)
        else:
            raise ValueError(
                f"model {model_id!r} is not a directory: this port serves "
                f"the 'tiny' and geometry tiers ({', '.join(GEOMETRY_MODELS)})"
                f" and local checkpoint directories (config.json, "
                f"*.safetensors, tokenizer.json); it fetches nothing from a "
                f"hub")
        check_head_size(mcfg.head_dim, device, repr(model_id or "tiny"))
        if quant:   # a no-op where the weights came int8
            state = quantize_state_dict(state)
        self.mcfg = mcfg
        self.model = LlamaForCausalLM.from_state_dict(mcfg, state,
                                                      dtype=dtype)
        self._byte_tok = isinstance(self.tokenizer, ByteTokenizer)
        max_prompt = min(cfg.max_seq_len,
                         mcfg.max_seq_len - cfg.max_new_tokens)
        if max_prompt < 1:
            raise ValueError(
                f"MAX_NEW_TOKENS={cfg.max_new_tokens} leaves no prompt room "
                f"within the model's max_seq_len={mcfg.max_seq_len}")
        self.buckets = BucketRegistry(pow2_buckets(min(32, max_prompt),
                                                   max_prompt))
        self._gen: Dict[int, Any] = {}

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
        ``max_new_tokens``; a value past ``MAX_NEW_TOKENS`` is a 400."""
        if max_new_tokens is not None and \
                int(max_new_tokens) > self.cfg.max_new_tokens:
            raise HTTPError(
                400,
                f"max_new_tokens={max_new_tokens} exceeds this deployment's "
                f"compiled cap MAX_NEW_TOKENS={self.cfg.max_new_tokens}")
        ids, n, bucket = self._encode(prompt)
        res = self._gen_for(bucket)(ids, n, seed=seed,
                                    temperature=float(temperature),
                                    top_k=int(top_k), top_p=float(top_p))
        toks = res.tokens.cpu().numpy()[0]
        if max_new_tokens is not None:
            toks = toks[:max(int(max_new_tokens), 0)]
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
