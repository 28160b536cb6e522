"""The port stands alone: it imports no JAX, no flax and nothing of the JAX
package, and it runs on the card unless it is asked for the CPU.

- an AST scan of every port source fails on an import of ``jax``,
  ``jaxlib``, ``flax`` or ``scalable_hw_agnostic_inference_tpu``;
- a fresh interpreter that imports every port module holds no more
  ``jax*``/``flax*`` modules than a bare interpreter does (an interpreter
  may preload JAX at start-up, so the check is relative);
- without CUDA the entry points raise unless they are given the CPU, and a
  kernel wrapper refuses a tensor that is neither on the CPU nor on CUDA.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "scalable_hw_agnostic_inference_tpu")


def _modules():
    for path in sorted(PORT_ROOT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_import_in_any_port_source():
    bad = []
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
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
