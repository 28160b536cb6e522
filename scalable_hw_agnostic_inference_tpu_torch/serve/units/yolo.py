"""The object-detection unit (``yolo``): ``POST /detectobj``.

Port of ``scalable_hw_agnostic_inference_tpu/serve/units/yolo.py``
(``YolosService``: ``load``, ``infer``): a request's ``image_b64`` (base64
PNG or JPEG, or ``"random"``) is decoded and resized bicubic to the
model's (height, width) without PIL, normalized with ImageNet's
statistics (as HF's ``YolosImageProcessor``), run through YOLOS and
post-processed (``models.yolos.postprocess``) at ``threshold`` (0.9 by
default); the response is ``{"detections", "count"}``. Bytes that are no
image this decoder reads answer 400.

- ``MODEL_ID=tiny`` (or empty): the tiny detector with seeded random
  weights drawn by torch, labels ``class_{i}``. CPU only: its heads of 16
  are outside B1, and ``load()`` refuses them on the card.
- ``MODEL_ID=<directory>``: a local HF ``YolosForObjectDetection``
  checkpoint (``config.json``, ``model*.safetensors``) read through
  ``core/checkpoint.py`` without ``transformers``, computing in bf16,
  its parameters held in fp32; ``id2label`` from ``config.json``.
- ``SUBMESH`` or ``MESH_SPEC`` naming one device places the unit on it;
  naming more is tensor parallelism (ROADMAP A7.3c): ``load()`` refuses it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...models import yolos
from ...models.convert import read_config
from ...models.encoder import seeded_init_
from ...models.imageio import ImageError
from ...models.sd import resolve_checkpoint_dir
from ..app import ModelService
from ..asgi import HTTPError
from .common import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    check_head_size,
    decode_image,
    id2label,
    unit_device,
)
from .encoders import checkpoint_state, on_device


class YolosService(ModelService):
    """Object detection: the reference's ``run-yolo.py`` (whose
    ``/detectobj`` handler calls an undefined function; implemented for
    real, as the JAX package does)."""

    task = "object-detection"
    infer_route = "/detectobj"

    def load(self) -> None:
        cfg = self.cfg
        device = unit_device(cfg)
        if cfg.model_id in ("", "tiny"):
            mcfg = yolos.YolosConfig.tiny()
            check_head_size(mcfg.dim // mcfg.heads, device, "the tiny tier")
            self.model = seeded_init_(yolos.YolosForObjectDetection(
                mcfg, device=device), cfg.seed)
            self.id2label = {i: f"class_{i}"
                             for i in range(mcfg.n_labels - 1)}
        else:
            hf = read_config(resolve_checkpoint_dir(
                cfg.model_id, "config.json, model*.safetensors"))
            mcfg = yolos.YolosConfig.from_hf(hf)
            check_head_size(mcfg.dim // mcfg.heads, device, cfg.model_id)
            self.model = yolos.build(
                mcfg, checkpoint_state(cfg.model_id, device,
                                       yolos.state_from_hf, mcfg),
                dtype=torch.bfloat16)
            self.id2label = id2label(hf)
        self.mcfg, self.device = mcfg, device

    def detect(self, pixels: np.ndarray):
        """``(class logits [B, D, labels], boxes [B, D, 4])`` as numpy
        fp32 for NHWC ``pixels``."""
        with torch.inference_mode():
            logits, boxes = self.model(on_device(self.device, pixels))
        return logits.cpu().numpy(), boxes.cpu().numpy()

    def example_payload(self) -> Dict[str, Any]:
        return {"image_b64": "random", "threshold": 0.5}

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        H, W = self.mcfg.image_size
        try:
            arr = decode_image(payload, H, W, mean=IMAGENET_MEAN,
                               std=IMAGENET_STD)
        except ImageError as e:
            raise HTTPError(400, f"bad image_b64: {e}")
        thr = float(payload.get("threshold", 0.9))
        logits, boxes = self.detect(arr)
        dets = yolos.postprocess(logits[0], boxes[0], thr, W, H,
                                 self.id2label)
        return {"detections": dets, "count": len(dets)}
