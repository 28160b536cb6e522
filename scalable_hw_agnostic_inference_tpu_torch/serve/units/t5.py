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
- ``SUBMESH`` or ``MESH_SPEC`` naming one device places the unit on it.
- ``MESH_SPEC=tp=N`` (the repo's manifest sets ``tp=4``) runs the encoder
  as N ranks of one host, one process each (``serve.multihost``: the
  leader serves ``/embed``, and every follower mirrors each ``infer``,
  the warmup's among them), the rank-local encoder of ``models/t5.py``.
  ``SHAI_COORDINATOR`` with ``SHAI_NUM_PROCESSES=1`` is a group of one
  through the env path; several hosts are refused, as the reference
  refuses a unit without ``supports_multihost``. At ``load()`` each rank
  refuses a tp that does not divide the heads (64 for T5-XXL), prices
  its load (``core.budget.rank_budget``: its shard, the widest request's
  activations) on the card (or under ``SHAI_ENFORCE_HBM=1``) before any
  weight is read, then reads the whole encoder on the CPU one entry at a
  time and places only its slice (``parallel.sharding.stream_shard``).
  The tiny tier's weights are drawn on the CPU at tp above 1, so that
  every rank slices the same ones.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core.budget import (
    HbmBudget,
    detect_hbm_gib,
    module_shapes,
    rank_budget,
)
from ...models import sd, t5
from ...models.encoder import seeded_init_
from ...models.tokenizer import UnigramTokenizer
from ...parallel.sharding import stream_shard
from ...utils.env import env_bool
from ..app import ModelService
from ..asgi import HTTPError
from .common import HashTokenizer, unit_ranks

#: tokens a request takes at most: the tiny tier's and a checkpoint's
TINY_SEQ, CHECKPOINT_SEQ = 64, 512


def encoder_act_bytes(cfg: t5.T5Config, seq: int, tp: int,
                      dtype_bytes: float) -> float:
    """An estimate of one rank's peak activations for one request of
    ``seq`` tokens: the residual and its norm, the rank's q, k, v and
    attention output, its FF slice (both halves), 1.5x for temporaries,
    beside the fp32 scores and probabilities of its heads."""
    width = 2 * cfg.dim + (4 * cfg.heads * cfg.d_kv + 2 * cfg.d_ff) // tp
    scores = 2 * (cfg.heads // tp) * seq * seq * 4.0
    return 1.5 * seq * width * dtype_bytes + scores


class T5EmbedService(ModelService):
    """Mean-pooled sentence embeddings: the reference's ``t5_model_api.py``
    on the port's encoder."""

    task = "embeddings"
    infer_route = "/embed"
    #: the tp ranks of one host, laid out by ``MESH_SPEC``
    ranks_over = "MESH_SPEC"

    def __init__(self, cfg, weights=None):
        """``weights(model_config, device)``, when given, returns the
        whole state dict the tiny tier serves in place of its own seeded
        weights (each rank calls it, with the CPU as the device where the
        unit runs over several ranks)."""
        super().__init__(cfg)
        self._weights = weights
        #: the rank's priced load, where the gate ran (on the card, or
        #: under ``SHAI_ENFORCE_HBM=1``)
        self.hbm_budget: Optional[HbmBudget] = None

    def model_config(self) -> t5.T5Config:
        """The encoder's config, read before any weight: the tiny tier's,
        or a checkpoint directory's ``config.json``."""
        if self.cfg.model_id in ("", "tiny"):
            return t5.T5Config.tiny()
        root = sd.resolve_checkpoint_dir(
            self.cfg.model_id, "config.json, model*.safetensors, "
            "tokenizer.json")
        return t5.T5Config.from_hf(json.loads(
            Path(root, "config.json").read_text()))

    def check_layout(self, tp: int) -> None:
        """Refuse a tp the encoder cannot split (``serve.multihost``
        asks before it starts a rank)."""
        t5.check_tp(self.model_config(), tp)

    def load(self) -> None:
        cfg = self.cfg
        device, group = unit_ranks(cfg, group=self.group,
                                   ranks_over=self.ranks_over)
        tp, rank = (group.size, group.rank) if group else (1, 0)
        tiny = cfg.model_id in ("", "tiny")
        mcfg = self.model_config()
        t5.check_tp(mcfg, tp)
        if tiny:
            dtype = torch.float32
            self.seq = min(cfg.max_seq_len, TINY_SEQ)
            self.tokenizer = HashTokenizer(mcfg.vocab_size, self.seq)
        else:
            root = sd.resolve_checkpoint_dir(
                cfg.model_id, "config.json, model*.safetensors, "
                "tokenizer.json")
            dtype = torch.bfloat16
            self.seq = min(cfg.max_seq_len, CHECKPOINT_SEQ)
        # the rank's load priced before any weight is read or placed
        if device.type == "cuda" or env_bool("SHAI_ENFORCE_HBM", False):
            self.hbm_budget = rank_budget(
                module_shapes(t5.T5Encoder(mcfg, dtype=dtype,
                                           device="meta")),
                t5.tp_rules(), tp, what=repr(cfg.model_id or "tiny"),
                dtype=str(dtype).split(".")[-1],
                act_bytes=encoder_act_bytes(mcfg, self.seq, tp,
                                            dtype.itemsize),
                hbm_gib_per_chip=detect_hbm_gib(device)).check()
        # a rank of several reads the whole encoder on the CPU, one entry
        # at a time, and places only its slice on its device
        source = device if tp == 1 else torch.device("cpu")
        if tiny and self._weights is not None:
            items = self._weights(mcfg, source).items()
        elif tiny:
            items = seeded_init_(t5.T5Encoder(mcfg, device=source),
                                 cfg.seed).state_dict().items()
        else:
            ck = sd.load_torch_state(root)
            items = t5.hf_items(lambda n: ck.tensor(n, source).to(dtype),
                                ck.keys(), mcfg)
            self.tokenizer = UnigramTokenizer.from_dir(root)
        self.model = t5.build(mcfg, stream_shard(items, t5.tp_rules(), tp,
                                                 rank, device),
                              dtype=dtype, group=group)
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
