"""Environment-variable config contract for serving pods.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/utils/env.py``
(``ServeConfig``, keeping only the fields this port reads, among them the
pod's resilience contract ``DRAIN_BUDGET_S``, ``ADMIT_MAX_QUEUE``,
``ADMIT_MAX_KV``, ``MAX_INFLIGHT`` and ``METRICS_PORT``, and the diffusion
units' ``NUM_INFERENCE_STEPS``, ``HEIGHT``, ``WIDTH``, ``GUIDANCE_SCALE``,
``SCHEDULER``, ``STEPS_BUCKETS`` and ``SD_BATCH_MAX``; the placement knobs
``SUBMESH`` and ``MESH_SPEC`` (one device, or, at the units that declare
``supports_multihost``, ``MESH_SPEC=tp=N`` ranks: ``serve.multihost``;
more elsewhere is refused at a unit's ``load()``); and the lenient
``env_*`` readers of ``obs/util.py``), with one change: ``DEVICE`` accepts
``cuda`` (the default) or ``cpu`` where the reference accepts ``tpu`` or
``cpu``. A malformed knob degrades to its default with a
warning; a value that parses but is out of contract fails loudly.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)

VALID_DEVICES = ("cuda", "cpu")


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        log.warning("malformed env knob %s=%r — using default %r",
                    name, v, default)
        return default


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
    num_inference_steps: int = 25        # diffusion denoise steps
    num_of_runs_inf: int = 2   # /benchmark's default n_runs
    max_new_tokens: int = 128
    max_seq_len: int = 512
    height: int = 512
    width: int = 512
    guidance_scale: float = 7.5
    batch_size: int = 1
    scheduler: str = "ddim"              # diffusion sampler: ddim | euler
    steps_buckets: str = ""              # extra allowed steps values, csv
    quantization: str = ""
    # diffusion request coalescing: concurrent /genimage requests sharing
    # (steps, guidance) run as one batched denoise, pow2 batch buckets up
    # to this cap (1 = off)
    sd_batch_max: int = 1
    vllm_config: str = "/vllm_config.yaml"  # engine ConfigMap mount path
    # placement: "tp=N"-style axis sizes, or an "a:b" device slice
    # (serve/units/common.py unit_layout: tp ranks at the units that
    # declare supports_multihost, one device elsewhere)
    mesh_spec: str = ""
    submesh: str = ""
    # serving
    port: int = 8000
    warmup: bool = True
    metrics_port: int = 9100   # the stdlib scrape exporter's port
    seed: int = 0
    # resilience (serve-layer request lifecycle)
    deadline_ms: int = 0   # default per-request deadline; 0 = none
    drain_budget_s: float = 30.0   # SIGTERM: max seconds to finish in-flight
    # admission-gate shed thresholds; the defaults are the failover
    # controller's OverloadThresholds, so pod-level 429s and fleet-level
    # failover describe the same saturation line
    admit_max_queue: float = 8.0
    admit_max_kv: float = 0.95
    max_inflight: int = 0          # hard in-flight cap; 0 = off
    # where /profile writes its traces (the TMPDIR's when unset)
    artifact_root: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "shai-artifacts"))

    @classmethod
    def from_env(cls) -> "ServeConfig":
        cfg = cls(
            app=env_str("APP", "model"),
            nodepool=env_str("NODEPOOL", "local"),
            pod_name=env_str("POD_NAME", os.uname().nodename),
            device=env_str("DEVICE", "cuda"),
            model_id=env_str("MODEL_ID", ""),
            num_inference_steps=env_int("NUM_INFERENCE_STEPS", 25),
            num_of_runs_inf=env_int("NUM_OF_RUNS_INF", 2),
            max_new_tokens=env_int("MAX_NEW_TOKENS", 128),
            max_seq_len=env_int("MAX_SEQ_LEN", 512),
            height=env_int("HEIGHT", 512),
            width=env_int("WIDTH", 512),
            guidance_scale=env_float("GUIDANCE_SCALE", 7.5),
            batch_size=env_int("BATCH_SIZE", 1),
            scheduler=env_str("SCHEDULER", "ddim"),
            steps_buckets=env_str("STEPS_BUCKETS", ""),
            quantization=env_str("QUANTIZATION", ""),
            sd_batch_max=env_int("SD_BATCH_MAX", 1),
            vllm_config=env_str("VLLM_CONFIG", "/vllm_config.yaml"),
            mesh_spec=env_str("MESH_SPEC", ""),
            submesh=env_str("SUBMESH", ""),
            port=env_int("PORT", 8000),
            warmup=env_bool("WARMUP", True),
            metrics_port=env_int("METRICS_PORT", 9100),
            seed=env_int("SEED", 0),
            deadline_ms=env_int("DEADLINE_MS", 0),
            drain_budget_s=env_float("DRAIN_BUDGET_S", 30.0),
            admit_max_queue=env_float("ADMIT_MAX_QUEUE", 8.0),
            admit_max_kv=env_float("ADMIT_MAX_KV", 0.95),
            max_inflight=env_int("MAX_INFLIGHT", 0),
            artifact_root=env_str("ARTIFACT_ROOT", os.path.join(
                tempfile.gettempdir(), "shai-artifacts")),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.device not in VALID_DEVICES:
            raise ValueError(
                f"DEVICE={self.device!r} not supported; expected one of "
                f"{VALID_DEVICES}")
        if self.height % 8 or self.width % 8:
            raise ValueError("HEIGHT and WIDTH must be multiples of 8")
        if self.batch_size < 1:
            raise ValueError("BATCH_SIZE must be >= 1")
        if self.deadline_ms < 0:
            raise ValueError("DEADLINE_MS must be >= 0 (0 disables)")
        if self.quantization not in ("", "int8"):
            raise ValueError(
                f"QUANTIZATION={self.quantization!r} not supported; "
                f"expected '' or 'int8'")
        if self.drain_budget_s < 0:
            raise ValueError("DRAIN_BUDGET_S must be >= 0")
        if self.max_inflight < 0:
            raise ValueError("MAX_INFLIGHT must be >= 0 (0 disables)")

    def describe(self) -> Dict[str, Any]:
        """The config for the self-describing ``GET /`` endpoint."""
        return dataclasses.asdict(self)
