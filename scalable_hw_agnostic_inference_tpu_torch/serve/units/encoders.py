"""The encoder units: ``bert`` (sentiment, ``POST /predict``) and ``vit``
(image classification, ``POST /classify``).

Port of ``scalable_hw_agnostic_inference_tpu/serve/units/encoders.py``
(``BertService``, ``ViTService``: ``load``, ``_encode``, ``infer``). The
responses are the reference's: ``{"label", "score", "logits"}`` (labels
from ``config.json``'s ``id2label``, ``NEGATIVE``/``POSITIVE`` without
one) and ``{"label", "top5"}``.

- ``MODEL_ID=tiny`` (or empty): the tiny model with seeded random weights
  drawn by torch; bert tokenizes with ``HashTokenizer`` to
  ``min(MAX_SEQ_LEN, 64)`` tokens. CPU only: its heads of 16 are outside
  B1, and ``load()`` refuses them on the card.
- ``MODEL_ID=<directory>``: a local HF checkpoint (``config.json``,
  ``model*.safetensors``), read through ``core/checkpoint.py`` without
  ``transformers``, computing in bf16 as the reference does, its
  parameters held in fp32. bert reads a DistilBERT sequence classifier
  (another ``model_type`` is refused) and its WordPiece ``tokenizer.json``
  or ``vocab.txt`` (``models.tokenizer.WordPieceTokenizer``), padding to
  ``min(MAX_SEQ_LEN, max_position_embeddings)``; the padding reaches B1
  as each row's key length. vit reads a ``ViTForImageClassification``.
- An image (``image_b64``: base64 PNG or JPEG, or ``"random"``) is decoded
  and resized bicubic without PIL (``common.decode_image``, 0.5/0.5);
  bytes that are no image this decoder reads answer 400.
- ``SUBMESH`` or ``MESH_SPEC`` naming one device places the unit on it;
  naming more is tensor parallelism (ROADMAP A7.3c): ``load()`` refuses it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...core.checkpoint import Checkpoint
from ...models import bert, vit
from ...models.convert import read_config
from ...models.encoder import seeded_init_
from ...models.imageio import ImageError
from ...models.sd import resolve_checkpoint_dir
from ...models.tokenizer import WordPieceTokenizer
from ..app import ModelService
from ..asgi import HTTPError
from .common import (
    HashTokenizer,
    check_head_size,
    decode_image,
    id2label,
    unit_device,
)


def softmax(logits: np.ndarray) -> np.ndarray:
    """fp32 softmax over the last axis (``jax.nn.softmax``'s formula)."""
    x = np.asarray(logits, np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def checkpoint_state(root: str, device: torch.device, to_state, cfg):
    """A checkpoint directory's tensors in fp32 on ``device``, through
    ``to_state(get, keys, cfg)`` (a model's ``state_from_hf``)."""
    ck = Checkpoint(root)
    return to_state(lambda n: ck.tensor(n, device).float(), ck.keys(), cfg)


def on_device(device: torch.device, arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


class BertService(ModelService):
    """Sentiment classification: the reference's ``run-bert.py``."""

    task = "text-classification"
    infer_route = "/predict"

    LABELS = ("NEGATIVE", "POSITIVE")

    def load(self) -> None:
        cfg = self.cfg
        device = unit_device(cfg)
        if cfg.model_id in ("", "tiny"):
            mcfg = bert.BertConfig.tiny()
            check_head_size(mcfg.dim // mcfg.heads, device, "the tiny tier")
            self.seq = min(cfg.max_seq_len, mcfg.max_position)
            self.model = seeded_init_(bert.DistilBertClassifier(
                mcfg, device=device), cfg.seed)
            self.tokenizer = HashTokenizer(mcfg.vocab_size, self.seq)
        else:
            hf = read_config(resolve_checkpoint_dir(
                cfg.model_id, "config.json, model*.safetensors"))
            mcfg = bert.BertConfig.from_hf(hf)
            check_head_size(mcfg.dim // mcfg.heads, device, cfg.model_id)
            self.tokenizer = WordPieceTokenizer.from_dir(cfg.model_id)
            self.seq = min(cfg.max_seq_len, mcfg.max_position)
            self.model = bert.build(
                mcfg, checkpoint_state(cfg.model_id, device,
                                       bert.state_from_hf, mcfg),
                dtype=torch.bfloat16)
            labels = id2label(hf)
            if labels:
                self.LABELS = tuple(labels[i] for i in range(len(labels)))
        self.mcfg, self.device = mcfg, device

    def _encode(self, text: str):
        if isinstance(self.tokenizer, HashTokenizer):
            ids, mask = self.tokenizer(text)
        else:
            enc = self.tokenizer(text, padding="max_length", truncation=True,
                                 max_length=self.seq)
            ids = np.array(enc["input_ids"])
            mask = np.array(enc["attention_mask"])
        return ids[None].astype(np.int64), mask[None].astype(np.int64)

    def logits(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """``[B, n_labels]`` fp32 logits of ``ids``/``mask``."""
        with torch.inference_mode():
            return self.model(on_device(self.device, ids),
                              on_device(self.device, mask)).cpu().numpy()

    def example_payload(self) -> Dict[str, Any]:
        return {"text": "i love this framework"}

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        logits = self.logits(*self._encode(str(payload.get("text", ""))))[0]
        idx = int(logits.argmax())
        probs = softmax(logits)
        return {
            "label": self.LABELS[idx % len(self.LABELS)],
            "score": round(float(probs[idx]), 4),
            "logits": [round(float(x), 4) for x in logits],
        }


class ViTService(ModelService):
    """Image classification: the reference's ``run-vit.py`` (the model
    loaded once, not per request)."""

    task = "image-classification"
    infer_route = "/classify"

    def load(self) -> None:
        cfg = self.cfg
        device = unit_device(cfg)
        if cfg.model_id in ("", "tiny"):
            mcfg = vit.ViTConfig.tiny()
            check_head_size(mcfg.dim // mcfg.heads, device, "the tiny tier")
            self.model = seeded_init_(vit.ViTClassifier(mcfg, device=device),
                                      cfg.seed)
            self.labels = {i: f"class_{i}" for i in range(mcfg.n_labels)}
        else:
            hf = read_config(resolve_checkpoint_dir(
                cfg.model_id, "config.json, model*.safetensors"))
            mcfg = vit.ViTConfig.from_hf(hf)
            check_head_size(mcfg.dim // mcfg.heads, device, cfg.model_id)
            self.model = vit.build(
                mcfg, checkpoint_state(cfg.model_id, device,
                                       vit.state_from_hf, mcfg),
                dtype=torch.bfloat16)
            self.labels = id2label(hf)
        self.mcfg, self.device = mcfg, device

    def logits(self, pixels: np.ndarray) -> np.ndarray:
        """``[B, n_labels]`` fp32 logits of NHWC ``pixels``."""
        with torch.inference_mode():
            return self.model(on_device(self.device, pixels)).cpu().numpy()

    def example_payload(self) -> Dict[str, Any]:
        return {"image_b64": "random"}

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        try:
            pixels = decode_image(payload, self.mcfg.image_size)
        except ImageError as e:
            raise HTTPError(400, f"bad image_b64: {e}")
        logits = self.logits(pixels)[0]
        top = np.argsort(logits)[::-1][:5]
        probs = softmax(logits)
        return {
            "label": self.labels.get(int(top[0]), str(int(top[0]))),
            "top5": [
                {"label": self.labels.get(int(i), str(int(i))),
                 "score": round(float(probs[i]), 4)}
                for i in top
            ],
        }
