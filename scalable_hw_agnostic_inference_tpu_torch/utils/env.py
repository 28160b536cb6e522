"""Environment-variable config contract for serving pods.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/utils/env.py``
(``ServeConfig``, keeping only the fields this port reads, and the lenient
``env_*`` readers of ``obs/util.py``), with one change: ``DEVICE`` accepts
``cuda`` (the default) or ``cpu`` where the reference accepts ``tpu`` or
``cpu``. A malformed knob degrades to its default with a
warning; a value that parses but is out of contract fails loudly.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)

VALID_DEVICES = ("cuda", "cpu")


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    if not v:
        return default
    try:
        return int(float(v))   # "8.5" degrades to 8, not a boot crash
    except ValueError:
        log.warning("malformed env knob %s=%r — using default %r",
                    name, v, default)
        return default


def env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name, "").strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "off", "no"):
        return False
    if v:
        log.warning("malformed env flag %s=%r — using default %r",
                    name, v, default)
    return default


@dataclasses.dataclass
class ServeConfig:
    """Pod configuration, set from a Deployment's ``env:`` block: the
    reference's fields that this port reads. Later slices add the others
    with the code that reads them, so a knob that is set is never ignored
    silently."""

    # identity / control-plane
    app: str = "model"
    nodepool: str = "local"
    pod_name: str = "local-pod"
    # model selection
    device: str = "cuda"
    model_id: str = ""
    # task knobs
    max_new_tokens: int = 128
    max_seq_len: int = 512
    batch_size: int = 1
    quantization: str = ""
    vllm_config: str = "/vllm_config.yaml"  # engine ConfigMap mount path
    # serving
    port: int = 8000
    warmup: bool = True
    seed: int = 0

    @classmethod
    def from_env(cls) -> "ServeConfig":
        cfg = cls(
            app=env_str("APP", "model"),
            nodepool=env_str("NODEPOOL", "local"),
            pod_name=env_str("POD_NAME", os.uname().nodename),
            device=env_str("DEVICE", "cuda"),
            model_id=env_str("MODEL_ID", ""),
            max_new_tokens=env_int("MAX_NEW_TOKENS", 128),
            max_seq_len=env_int("MAX_SEQ_LEN", 512),
            batch_size=env_int("BATCH_SIZE", 1),
            quantization=env_str("QUANTIZATION", ""),
            vllm_config=env_str("VLLM_CONFIG", "/vllm_config.yaml"),
            port=env_int("PORT", 8000),
            warmup=env_bool("WARMUP", True),
            seed=env_int("SEED", 0),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.device not in VALID_DEVICES:
            raise ValueError(
                f"DEVICE={self.device!r} not supported; expected one of "
                f"{VALID_DEVICES}")
        if self.batch_size < 1:
            raise ValueError("BATCH_SIZE must be >= 1")
        if self.quantization not in ("", "int8"):
            raise ValueError(
                f"QUANTIZATION={self.quantization!r} not supported; "
                f"expected '' or 'int8'")

    def describe(self) -> Dict[str, Any]:
        """The config for the self-describing ``GET /`` endpoint."""
        return dataclasses.asdict(self)
