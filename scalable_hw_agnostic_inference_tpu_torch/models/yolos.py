"""YOLOS object detection: the ``yolo`` unit's model.

Port of ``scalable_hw_agnostic_inference_tpu/models/yolos.py``
(``YolosConfig``, ``DetectionMLP``, ``YolosForObjectDetection``,
``postprocess``, ``params_from_torch``): a ViT backbone (``models/vit.py``'s
patch convolution, class token and learned positions) with
``n_det_tokens`` learned detection tokens after the patches, a pre-LN
encoder (attention on B1 on the card, no lengths: 1 + 32 x 54 + 100 =
1,829 tokens at the default 512 x 864), the final LayerNorm and two
3-layer ReLU heads over the detection rows: class logits (the last class
is no-object) and sigmoid boxes, normalized cxcywh. Parameters are held
in fp32 and cast to the compute dtype at use.

The positions are the configured image's, not interpolated: the
reference's contract (an HF checkpoint at another ``image_size`` holds
positions of another length, which :func:`state_from_hf` refuses).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from .encoder import (
    Conv2d,
    Dense,
    Encoder,
    LayerNorm,
    param,
    state_from_flax,
    state_from_names,
)
from .vit import patch_tokens, vit_backbone_names


@dataclasses.dataclass(frozen=True)
class YolosConfig:
    image_size: Tuple[int, int] = (512, 864)   # (H, W), yolos-tiny default
    patch_size: int = 16
    dim: int = 192
    n_layers: int = 12
    heads: int = 3
    mlp_dim: int = 768
    n_det_tokens: int = 100
    n_labels: int = 92           # COCO 91 + no-object
    ln_eps: float = 1e-12
    act: str = "gelu"

    @property
    def n_patches(self) -> int:
        return (self.image_size[0] // self.patch_size) * \
            (self.image_size[1] // self.patch_size)

    @property
    def n_tokens(self) -> int:
        return 1 + self.n_patches + self.n_det_tokens

    @classmethod
    def tiny(cls) -> "YolosConfig":
        return cls(image_size=(32, 32), patch_size=8, dim=32, n_layers=2,
                   heads=2, mlp_dim=64, n_det_tokens=5, n_labels=4)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "YolosConfig":
        """From a YOLOS ``config.json`` (a dict; ``transformers``'
        ``YolosConfig`` defaults for what it omits)."""
        size = hf.get("image_size", [800, 1333])
        if isinstance(size, int):
            size = (size, size)
        id2label = hf.get("id2label") or {}
        return cls(
            image_size=tuple(size),
            patch_size=hf.get("patch_size", 16),
            dim=hf.get("hidden_size", 768),
            n_layers=hf.get("num_hidden_layers", 12),
            heads=hf.get("num_attention_heads", 12),
            mlp_dim=hf.get("intermediate_size", 3072),
            n_det_tokens=hf.get("num_detection_tokens", 100),
            n_labels=len(id2label) + 1 if id2label else 92,
            ln_eps=hf.get("layer_norm_eps", 1e-12),
            act=hf.get("hidden_act", "gelu"),
        )


class DetectionMLP(nn.Module):
    """The 3-layer ReLU head (DETR-style): ``fc0``, ``fc1``, ``fc2``."""

    def __init__(self, dim: int, hidden: int, out_dim: int, dtype, device):
        super().__init__()
        self.fc0 = Dense(dim, hidden, True, dtype, device)
        self.fc1 = Dense(hidden, hidden, True, dtype, device)
        self.fc2 = Dense(hidden, out_dim, True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc0(x))
        return self.fc2(torch.relu(self.fc1(x)))


class YolosForObjectDetection(nn.Module):
    """pixels ``[B, H, W, 3]`` (NHWC, normalized) -> ``(class logits [B,
    D, n_labels], boxes [B, D, 4])`` f32, boxes normalized cxcywh in [0,
    1]. ``device`` defaults to the card; ``"cpu"`` for the CPU, ``"meta"``
    for no storage (:func:`build`)."""

    def __init__(self, cfg: YolosConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        c, pd = cfg, param_dtype
        self.patch = Conv2d(3, c.dim, c.patch_size, dtype, device,
                            param_dtype=pd, stride=c.patch_size, padding=0)
        self.cls = param((1, 1, c.dim), pd, device)
        self.det = param((1, c.n_det_tokens, c.dim), pd, device)
        self.pos = param((1, c.n_tokens, c.dim), pd, device)
        self.encoder = Encoder(c.n_layers, c.dim, c.heads, c.mlp_dim,
                               act=c.act, ln_eps=c.ln_eps, dtype=dtype,
                               param_dtype=pd, device=device)
        self.final_ln = LayerNorm(c.dim, c.ln_eps, pd, device)
        self.class_head = DetectionMLP(c.dim, c.dim, c.n_labels, pd, device)
        self.box_head = DetectionMLP(c.dim, c.dim, 4, pd, device)

    @property
    def device(self) -> torch.device:
        return self.cls.device

    def forward(self, pixels: torch.Tensor):
        c, dt = self.cfg, self.dtype
        B = pixels.shape[0]
        x = patch_tokens(self.patch, pixels)
        x = torch.cat([self.cls.to(dt).expand(B, 1, c.dim), x,
                       self.det.to(dt).expand(B, c.n_det_tokens, c.dim)],
                      dim=1)
        x = self.encoder(x + self.pos.to(dt))
        x = self.final_ln(x, dt)
        dtok = x[:, -c.n_det_tokens:]
        logits = self.class_head(dtok)
        boxes = torch.sigmoid(self.box_head(dtok))
        return logits.float(), boxes.float()


def postprocess(logits: np.ndarray, boxes: np.ndarray, threshold: float,
                width: int, height: int, id2label=None
                ) -> List[Dict[str, Any]]:
    """Softmax-scored detections at or above ``threshold`` (the no-object
    class dropped), boxes to absolute xyxy, highest score first: the
    reference's ``postprocess``, value for value."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    scores = probs[..., :-1]
    out = []
    for d in range(scores.shape[0]):
        label = int(scores[d].argmax())
        score = float(scores[d, label])
        if score < threshold:
            continue
        cx, cy, w, h = boxes[d]
        out.append({
            "label": (id2label.get(label, str(label)) if id2label
                      else str(label)),
            "label_id": label,
            "score": round(score, 4),
            "box": {
                "xmin": round(float(cx - w / 2) * width, 1),
                "ymin": round(float(cy - h / 2) * height, 1),
                "xmax": round(float(cx + w / 2) * width, 1),
                "ymax": round(float(cy + h / 2) * height, 1),
            },
        })
    return sorted(out, key=lambda r: -r["score"])


def build(cfg: YolosConfig, state: Dict[str, torch.Tensor],
          dtype=torch.float32) -> YolosForObjectDetection:
    """The detector around ``state`` (built on the meta device, the
    tensors assigned: no second copy), computing in ``dtype``."""
    m = YolosForObjectDetection(cfg, dtype=dtype, device="meta")
    m.load_state_dict(state, assign=True, strict=True)
    return m


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of
    ``YolosForObjectDetection`` (numpy leaves) -> this module's state
    dict."""
    return state_from_flax(tree)


def hf_names(cfg: YolosConfig) -> Dict[str, str]:
    """This module's state name -> the HF ``YolosForObjectDetection``
    key."""
    out = vit_backbone_names(cfg.n_layers)
    out["det"] = "vit.embeddings.detection_tokens"
    for ours, hf in (("class_head", "class_labels_classifier"),
                     ("box_head", "bbox_predictor")):
        for j in range(3):
            for leaf in ("weight", "bias"):
                out[f"{ours}.fc{j}.{leaf}"] = f"{hf}.layers.{j}.{leaf}"
    return out


def state_from_hf(get: Callable[[str], torch.Tensor], keys,
                  cfg: YolosConfig) -> Dict[str, torch.Tensor]:
    """The detector's state from an HF YOLOS checkpoint: ``get(name)``
    returns a tensor, ``keys`` are the checkpoint's names. Positions of
    another length than the configured image's raise."""
    state = state_from_names(get, keys, hf_names(cfg), "YOLOS")
    want = (1, cfg.n_tokens, cfg.dim)
    if tuple(state["pos"].shape) != want:
        raise ValueError(
            f"YOLOS position embeddings {tuple(state['pos'].shape)}, the "
            f"config's image {cfg.image_size} needs {want}: positions are "
            f"not interpolated")
    return state
