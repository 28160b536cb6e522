"""The port stands alone: it imports no JAX, no flax and nothing of the JAX
package, and it runs on the card unless it is asked for the CPU.

- an AST scan of every port source (and ``chip_smoke.py``) fails on an
  import of ``jax``, ``jaxlib``, ``flax``, ``prometheus_client`` or
  ``scalable_hw_agnostic_inference_tpu``;
- a fresh interpreter that imports every port module holds no more
  ``jax*``/``flax*`` modules than a bare interpreter does (an interpreter
  may preload JAX at start-up, so the check is relative);
- without CUDA the entry points raise unless they are given the CPU (the
  engine, the unit, the model, its weight builders and the KV cache), and
  a kernel wrapper refuses a tensor that is neither on the CPU nor on
  CUDA.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import scalable_hw_agnostic_inference_tpu_torch as port

PORT_ROOT = Path(port.__file__).resolve().parent
REPO = PORT_ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "prometheus_client",
             "scalable_hw_agnostic_inference_tpu")


def _modules():
    for path in sorted(PORT_ROOT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _forbidden_imports(paths):
    bad = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    return bad


def test_no_forbidden_import_in_any_port_source():
    bad = _forbidden_imports(path for path, _ in _modules())
    assert not bad, bad
    assert len(list(_modules())) > 20


_PROBE = """
import json, sys
before = {m for m in sys.modules if m.split('.')[0] in %r}
for name in %r:
    __import__(name)
after = {m for m in sys.modules if m.split('.')[0] in %r}
print(json.dumps(sorted(after - before)))
"""


def test_importing_every_port_module_loads_no_jax():
    names = [n for _, n in _modules() if not n.endswith("__main__")]
    heads = ("jax", "jaxlib", "flax")
    code = _PROBE % (heads, names, heads)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_given_the_cpu(no_cuda,
                                                              tmp_path):
    from scalable_hw_agnostic_inference_tpu_torch.core.device import (
        resolve_device,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        random_params,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
        VllmService,
    )
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="not supported"):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")

    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM.from_state_dict(
        cfg, random_params(cfg, seed=0, device="cpu"))
    ecfg = EngineConfig(max_model_len=64, max_num_seqs=2,
                        context_encoding_buckets=(16,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(cfg, model, ecfg)
    LLMEngine(cfg, model, ecfg, device="cpu")

    scfg = ServeConfig(model_id="tiny",
                       vllm_config=str(tmp_path / "absent.yaml"))
    assert scfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VllmService(scfg).load()
    with pytest.raises(ValueError, match="DEVICE"):
        ServeConfig(device="tpu").validate()


def _builders():
    from scalable_hw_agnostic_inference_tpu_torch.engine.cache import (
        PagedKVCache,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    return {
        "LlamaForCausalLM": lambda **kw: llama.LlamaForCausalLM(cfg, **kw),
        "geometry_params": lambda **kw: llama.geometry_params(cfg, **kw),
        "random_params": lambda **kw: llama.random_params(cfg, 0, **kw),
        "PagedKVCache": lambda **kw: PagedKVCache(
            cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, total_blocks=9,
            block_size=4, blocks_per_seq=4, **kw),
    }


def _tensors(built):
    if isinstance(built, dict):
        return list(built.values())
    if isinstance(built, torch.nn.Module):
        return list(built.parameters())
    return [t for lay in built.kv for t in lay.values()]


@pytest.mark.parametrize("name", ["LlamaForCausalLM", "geometry_params",
                                  "random_params", "PagedKVCache"])
def test_model_weights_and_cache_default_to_the_card(no_cuda, name):
    """With no device given, the model, its weight builders and the KV
    cache go to the card, and raise without one, as the engine and the
    unit do; given the CPU they build there."""
    build = _builders()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    tensors = _tensors(build(device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_server_env_defaults_to_cuda(monkeypatch):
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    monkeypatch.delenv("DEVICE", raising=False)
    assert ServeConfig.from_env().device == "cuda"
    monkeypatch.setenv("DEVICE", "cpu")
    assert ServeConfig.from_env().device == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
        paged_attention as pa,
    )

    q = torch.empty(1, 16, 2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q, causal=True)
    pool = torch.empty(4, 16, 2, 64, device="meta", dtype=torch.bfloat16)
    ids = torch.empty(1, 2, device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_decode_attention(q[:, 0], pool, pool, ids, ids[:, 0])
    assert fa.flash_attention.launches == 0
    assert pa.paged_decode_attention.launches == 0


#: the async-decode slice's modules: the scans above cover them by name
SLICE_MODULES = (
    "scalable_hw_agnostic_inference_tpu_torch.obs.steploop",
    "scalable_hw_agnostic_inference_tpu_torch.engine.resident",
    "scalable_hw_agnostic_inference_tpu_torch.engine.graphs",
    "scalable_hw_agnostic_inference_tpu_torch.engine.warm",
)


def test_async_decode_modules_are_scanned_and_load_no_jax():
    scanned = {n for _, n in _modules()}
    assert set(SLICE_MODULES) <= scanned
    heads = ("jax", "jaxlib", "flax")
    code = _PROBE % (heads, list(SLICE_MODULES), heads)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_decode_graph_raises_without_cuda_unless_given_the_cpu(no_cuda):
    from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
        DecodeGraph,
    )

    def build(**kw):
        return DecodeGraph((4, 2), None, None, [], 2, 4, 16, **kw)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(device="cuda")
    g = build(device="cpu")
    assert g.inputs["tables"].device.type == "cpu" and not g.pool.cuda


#: the serving-contract slice's modules (deadlines, QoS, logprobs, the
#: Prometheus page, SSE), and the chip script
SERVING_MODULES = (
    "scalable_hw_agnostic_inference_tpu_torch.resilience.deadline",
    "scalable_hw_agnostic_inference_tpu_torch.resilience.qos",
    "scalable_hw_agnostic_inference_tpu_torch.engine.logprobs",
    "scalable_hw_agnostic_inference_tpu_torch.serve.metrics",
    "scalable_hw_agnostic_inference_tpu_torch.serve.units.common",
    "scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm",
    "scalable_hw_agnostic_inference_tpu_torch.serve.app",
)


def test_serving_modules_are_scanned_and_load_no_jax_or_prometheus():
    """The new modules are in the scan, import none of the forbidden
    packages (``prometheus_client`` included: the port writes its own
    exposition), and nor does ``chip_smoke.py``."""
    scanned = {n for _, n in _modules()}
    assert set(SERVING_MODULES) <= scanned
    assert _forbidden_imports([REPO / "chip_smoke.py"]) == []
    heads = ("jax", "jaxlib", "flax", "prometheus_client")
    code = _PROBE % (heads, list(SERVING_MODULES), heads)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


#: the operating layer's modules (gate, budgets, drain, watchdog,
#: idempotency, faults, tracing, flight recorder, SLO, HBM ledger,
#: sentinel, the shared thresholds, the benchmark runner)
OPERATING_MODULES = (
    "scalable_hw_agnostic_inference_tpu_torch.orchestrate.capacity_checker",
    "scalable_hw_agnostic_inference_tpu_torch.resilience.admission",
    "scalable_hw_agnostic_inference_tpu_torch.resilience.drain",
    "scalable_hw_agnostic_inference_tpu_torch.resilience.faults",
    "scalable_hw_agnostic_inference_tpu_torch.resilience.idempotency",
    "scalable_hw_agnostic_inference_tpu_torch.obs.trace",
    "scalable_hw_agnostic_inference_tpu_torch.obs.flight",
    "scalable_hw_agnostic_inference_tpu_torch.obs.slo",
    "scalable_hw_agnostic_inference_tpu_torch.obs.hbm",
    "scalable_hw_agnostic_inference_tpu_torch.obs.sentinel",
    "scalable_hw_agnostic_inference_tpu_torch.utils.latency",
)


def test_operating_modules_are_scanned_and_load_no_jax_or_prometheus():
    scanned = {n for _, n in _modules()}
    assert set(OPERATING_MODULES) <= scanned
    heads = ("jax", "jaxlib", "flax", "prometheus_client")
    code = _PROBE % (heads, list(OPERATING_MODULES), heads)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_serve_config_fields_pinned_against_the_reference():
    """Every field of the port's ``ServeConfig`` is the reference's, with
    its type and default; the exceptions are ``DEVICE``'s default (the
    card, where the reference's is the TPU) and ``ARTIFACT_ROOT``'s, which
    the port roots in the process's temporary directory."""
    import dataclasses

    from scalable_hw_agnostic_inference_tpu.utils.env import (
        ServeConfig as JServeConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    ref = {f.name: f for f in dataclasses.fields(JServeConfig)}
    port = {f.name: f for f in dataclasses.fields(ServeConfig)}
    assert set(port) <= set(ref), set(port) - set(ref)
    for name in ("drain_budget_s", "admit_max_queue", "admit_max_kv",
                 "max_inflight", "metrics_port", "deadline_ms"):
        assert name in port, name
    jdef, tdef = JServeConfig(), ServeConfig()
    for name, f in port.items():
        assert f.type == ref[name].type, name
        if name not in ("device", "artifact_root"):
            assert getattr(tdef, name) == getattr(jdef, name), name
    assert (jdef.device, tdef.device) == ("tpu", "cuda")
