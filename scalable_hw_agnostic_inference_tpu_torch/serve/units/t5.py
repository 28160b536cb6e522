"""The T5 embeddings unit (``t5``): ``POST /embed``.

Port of ``scalable_hw_agnostic_inference_tpu/serve/units/t5.py``
(``T5EmbedService``: ``load``, ``_encode``, ``infer``): a request's
``text`` (or ``prompt``) is tokenized to the unit's length, encoded by the
T5 encoder and mean-pooled over its real tokens; the response is the
reference's ``{"embedding", "dim"}``, and a request without text is a
400.

- ``MODEL_ID=tiny`` (or empty): the tiny encoder with seeded random
  weights drawn by torch, hashed tokens, ``min(MAX_SEQ_LEN, 64)`` of them.
  T5's attention is plain PyTorch (``models/t5.py``), so the tier runs on
  the card as on the CPU.
- ``MODEL_ID=<directory>``: a local T5 encoder (``config.json``,
  safetensors, possibly sharded) in bf16, as the reference casts it, with
  its Unigram ``tokenizer.json`` (``models/tokenizer.UnigramTokenizer``),
  ``min(MAX_SEQ_LEN, 512)`` tokens. A hub id is refused.
- ``SUBMESH`` or ``MESH_SPEC`` naming one device places the unit on it;
  naming more is tensor parallelism (ROADMAP A7.3b): ``load()`` refuses it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ...models import sd, t5
from ...models.encoder import seeded_init_
from ...models.tokenizer import UnigramTokenizer
from ..app import ModelService
from ..asgi import HTTPError
from .common import HashTokenizer, unit_device

#: tokens a request takes at most: the tiny tier's and a checkpoint's
TINY_SEQ, CHECKPOINT_SEQ = 64, 512


class T5EmbedService(ModelService):
    """Mean-pooled sentence embeddings: the reference's ``t5_model_api.py``
    on the port's encoder."""

    task = "embeddings"
    infer_route = "/embed"

    def load(self) -> None:
        cfg = self.cfg
        device = unit_device(cfg)
        if cfg.model_id in ("", "tiny"):
            mcfg = t5.T5Config.tiny()
            self.seq = min(cfg.max_seq_len, TINY_SEQ)
            self.model = seeded_init_(t5.T5Encoder(mcfg, device=device),
                                      cfg.seed)
            self.tokenizer = HashTokenizer(mcfg.vocab_size, self.seq)
        else:
            root = sd.resolve_checkpoint_dir(
                cfg.model_id, "config.json, model*.safetensors, "
                "tokenizer.json")
            mcfg = t5.T5Config.from_hf(json.loads(
                Path(root, "config.json").read_text()))
            ck = sd.load_torch_state(root)
            self.model = t5.build(mcfg, t5.state_from_hf(
                lambda n: ck.tensor(n, device).to(torch.bfloat16),
                ck.keys(), mcfg), dtype=torch.bfloat16)
            self.tokenizer = UnigramTokenizer.from_dir(root)
            self.seq = min(cfg.max_seq_len, CHECKPOINT_SEQ)
        self.device = device

    def _encode(self, text: str):
        if isinstance(self.tokenizer, HashTokenizer):
            ids, mask = self.tokenizer(text)
        else:
            enc = self.tokenizer(text, padding="max_length", truncation=True,
                                 max_length=self.seq)
            ids = np.array(enc["input_ids"])
            mask = np.array(enc["attention_mask"])
        return ids[None].astype(np.int64), mask[None].astype(np.int64)

    def embed(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Mean-pooled ``[B, dim]`` fp32 embeddings of ``ids``/``mask``."""
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device)
            mask_t = torch.from_numpy(mask).to(self.device)
            return t5.mean_pool(self.model(ids_t, mask_t),
                                mask_t).cpu().numpy()

    def example_payload(self) -> Dict[str, Any]:
        return {"text": "embed me"}

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        text = payload.get("text", payload.get("prompt"))
        if text is None:
            raise HTTPError(400, "missing 'text'")
        emb = self.embed(*self._encode(str(text)))
        return {"embedding": emb[0].tolist(), "dim": int(emb.shape[-1])}
