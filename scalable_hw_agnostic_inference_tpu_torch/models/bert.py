"""DistilBERT sequence classifier: the ``bert`` unit's model.

Port of ``scalable_hw_agnostic_inference_tpu/models/bert.py``
(``BertConfig``, ``DistilBertClassifier``, ``params_from_torch``): token
and learned position embeddings, the embedding LayerNorm, a post-LN
encoder (``models/encoder.py``, exact GELU, 1e-12 epsilons), the [CLS]
row through ``pre_classifier``, ReLU and ``classifier``. Parameters are
held in fp32 and cast to the compute dtype at use, as flax casts them;
the embeddings and their LayerNorm compute in fp32. Padded keys are
masked through B1's per-row lengths on the card.

:func:`state_from_hf` reads an HF ``DistilBertForSequenceClassification``
checkpoint's keys (through ``core/checkpoint.py``, no ``transformers``);
:func:`params_from_jax` carries the JAX package's tree across. The
reference serves DistilBERT only: :meth:`BertConfig.from_hf` refuses a
``config.json`` of another ``model_type``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from .encoder import (
    Dense,
    Embed,
    Encoder,
    LayerNorm,
    hf_block_names,
    state_from_flax,
    state_from_names,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position: int = 512
    dim: int = 768
    n_layers: int = 6
    heads: int = 12
    mlp_dim: int = 3072
    n_labels: int = 2
    ln_eps: float = 1e-12
    act: str = "gelu"

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=128, max_position=64, dim=32, n_layers=2,
                   heads=2, mlp_dim=64, n_labels=2)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "BertConfig":
        """From a DistilBERT ``config.json`` (a dict; ``transformers``'
        ``DistilBertConfig`` defaults for what it omits). Another
        ``model_type`` raises."""
        kind = hf.get("model_type")
        if kind != "distilbert":
            raise ValueError(
                f"config.json model_type {kind!r}: the bert unit serves "
                f"DistilBERT sequence classifiers only (model_type "
                f"'distilbert'), as the reference does")
        id2label = hf.get("id2label") or {}
        return cls(
            vocab_size=hf.get("vocab_size", 30522),
            max_position=hf.get("max_position_embeddings", 512),
            dim=hf.get("dim", 768),
            n_layers=hf.get("n_layers", 6),
            heads=hf.get("n_heads", 12),
            mlp_dim=hf.get("hidden_dim", 3072),
            n_labels=len(id2label) or hf.get("num_labels", 2),
            act=hf.get("activation", "gelu"),
        )


class DistilBertClassifier(nn.Module):
    """``forward(input_ids [B, T], attention_mask [B, T] or None)`` ->
    logits ``[B, n_labels]`` f32. ``device`` defaults to the card;
    ``"cpu"`` for the CPU, ``"meta"`` for no storage (:func:`build`)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        c, pd = cfg, param_dtype
        self.tok_emb = Embed(c.vocab_size, c.dim, pd, device)
        self.pos_emb = Embed(c.max_position, c.dim, pd, device)
        self.emb_ln = LayerNorm(c.dim, c.ln_eps, pd, device)
        self.encoder = Encoder(c.n_layers, c.dim, c.heads, c.mlp_dim,
                               act=c.act, ln_eps=c.ln_eps, dtype=dtype,
                               param_dtype=pd, device=device, pre_ln=False)
        self.pre_classifier = Dense(c.dim, c.dim, True, pd, device)
        self.classifier = Dense(c.dim, c.n_labels, True, pd, device)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        T = input_ids.shape[1]
        x = self.tok_emb(input_ids).float() \
            + self.pos_emb.weight[:T].float()[None]
        x = self.emb_ln(x, self.dtype)
        x = self.encoder(x, attention_mask=attention_mask)
        pooled = torch.relu(self.pre_classifier(x[:, 0]))
        return self.classifier(pooled).float()


def build(cfg: BertConfig, state: Dict[str, torch.Tensor],
          dtype=torch.float32) -> DistilBertClassifier:
    """The classifier around ``state`` (built on the meta device, the
    tensors assigned: no second copy), computing in ``dtype``."""
    m = DistilBertClassifier(cfg, dtype=dtype, device="meta")
    m.load_state_dict(state, assign=True, strict=True)
    return m


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of
    ``DistilBertClassifier`` (numpy leaves) -> this module's state dict."""
    return state_from_flax(tree)


_BLOCK_HF = {"attn.q": "attention.q_lin", "attn.k": "attention.k_lin",
             "attn.v": "attention.v_lin", "attn.o": "attention.out_lin",
             "ln1": "sa_layer_norm", "fc1": "ffn.lin1", "fc2": "ffn.lin2",
             "ln2": "output_layer_norm"}


def hf_names(cfg: BertConfig) -> Dict[str, str]:
    """This module's state name -> the HF
    ``DistilBertForSequenceClassification`` key."""
    emb = "distilbert.embeddings"
    out = {"tok_emb.weight": f"{emb}.word_embeddings.weight",
           "pos_emb.weight": f"{emb}.position_embeddings.weight",
           "emb_ln.weight": f"{emb}.LayerNorm.weight",
           "emb_ln.bias": f"{emb}.LayerNorm.bias"}
    for n in ("pre_classifier", "classifier"):
        for leaf in ("weight", "bias"):
            out[f"{n}.{leaf}"] = f"{n}.{leaf}"
    for i in range(cfg.n_layers):
        out.update(hf_block_names(f"distilbert.transformer.layer.{i}",
                                  f"encoder.layer_{i}", _BLOCK_HF))
    return out


def state_from_hf(get: Callable[[str], torch.Tensor], keys,
                  cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """The classifier's state from an HF DistilBERT checkpoint:
    ``get(name)`` returns a tensor, ``keys`` are the checkpoint's names."""
    return state_from_names(get, keys, hf_names(cfg), "DistilBERT")
