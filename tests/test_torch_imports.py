"""The port stands alone: it imports no JAX, no flax and nothing of the JAX
package, and it runs on the card unless it is asked for the CPU.

- an AST scan of every port source (and ``chip_smoke.py``) fails on an
  import of ``jax``, ``jaxlib``, ``flax``, ``prometheus_client``,
  ``scalable_hw_agnostic_inference_tpu``, or of a package the machine with
  the card lacks (``transformers``, ``safetensors``, ``tokenizers``,
  ``tiktoken``, ``regex``, ``jinja2``, ``sentencepiece``, ``ml_dtypes``,
  ``httpx``, ``PIL``);
- ``engine/speculative.py`` imports numpy and the standard library alone;
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
             "scalable_hw_agnostic_inference_tpu",
             # not on the machine with the card: the checkpoint reader and
             # the tokenizer are the port's own
             "transformers", "safetensors", "tokenizers", "tiktoken",
             "regex", "jinja2", "sentencepiece",
             # nor is ml_dtypes: the kvnet frame codec decodes bfloat16
             # frames into 16-bit words of its own
             "ml_dtypes",
             # nor is httpx: the kvnet pull, the migration ship and the
             # fleet lookup speak HTTP through the standard library
             "httpx",
             # nor is PIL: the mllama unit decodes PNG and resizes with
             # models/imageio.py (and the SD unit encodes its PNGs there)
             "PIL",
             # nor is diffusers: the SD pipeline, its schedulers and its
             # checkpoint loaders are the port's own
             "diffusers")


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


def test_speculative_module_is_numpy_and_the_standard_library():
    """``engine/speculative.py`` is a copy of the JAX package's module that
    takes nothing from it: the drafter, the acceptance walk and the
    counters import numpy and the standard library alone."""
    names = dict((n, p) for p, n in _modules())
    path = names[
        "scalable_hw_agnostic_inference_tpu_torch.engine.speculative"]
    heads = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            heads |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, node.module
            heads.add((node.module or "").split(".")[0])
    assert heads <= {"__future__", "dataclasses", "typing", "numpy"}, heads
    assert not _forbidden_imports([path])


_PROBE = """
import json, sys
before = {m for m in sys.modules if m.split('.')[0] in %r}
for name in %r:
    __import__(name)
after = {m for m in sys.modules if m.split('.')[0] in %r}
print(json.dumps(sorted(after - before)))
"""


def test_importing_every_port_module_loads_no_jax():
    """Nor any other package the AST scan refuses."""
    names = [n for _, n in _modules() if not n.endswith("__main__")]
    heads = tuple(h for h in FORBIDDEN
                  if h != "scalable_hw_agnostic_inference_tpu")
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
    from scalable_hw_agnostic_inference_tpu_torch.models import bert
    from scalable_hw_agnostic_inference_tpu_torch.models import clip
    from scalable_hw_agnostic_inference_tpu_torch.models import flux
    from scalable_hw_agnostic_inference_tpu_torch.models import llama
    from scalable_hw_agnostic_inference_tpu_torch.models import mllama
    from scalable_hw_agnostic_inference_tpu_torch.models import t5
    from scalable_hw_agnostic_inference_tpu_torch.models import unet
    from scalable_hw_agnostic_inference_tpu_torch.models import vae
    from scalable_hw_agnostic_inference_tpu_torch.models import vit
    from scalable_hw_agnostic_inference_tpu_torch.models import yolos

    cfg = llama.LlamaConfig.tiny()
    mcfg = llama.LlamaConfig(**{**llama.LlamaConfig.tiny().__dict__,
                                "cross_attention_layers": (1,)})
    vcfg = mllama.MllamaVisionConfig.tiny()
    return {
        "mllama_text": lambda **kw: llama.random_params(mcfg, 0, **kw),
        "MllamaVisionModel": lambda **kw: mllama.MllamaVisionModel(vcfg,
                                                                   **kw),
        "random_vision_params": lambda **kw: mllama.random_vision_params(
            vcfg, cfg.dim, 0, **kw),
        "LlamaForCausalLM": lambda **kw: llama.LlamaForCausalLM(cfg, **kw),
        "geometry_params": lambda **kw: llama.geometry_params(cfg, **kw),
        "geometry_params_int8": lambda **kw: llama.geometry_params(
            cfg, quant=True, **kw),
        "LlamaForCausalLM_int8": lambda **kw: llama.LlamaForCausalLM(
            cfg, quantized=True, **kw),
        "random_params": lambda **kw: llama.random_params(cfg, 0, **kw),
        "PagedKVCache": lambda **kw: PagedKVCache(
            cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, total_blocks=9,
            block_size=4, blocks_per_seq=4, **kw),
        "UNet2DCondition": lambda **kw: unet.UNet2DCondition(
            unet.UNetConfig.tiny(), **kw),
        "AutoencoderKL": lambda **kw: vae.AutoencoderKL(
            vae.VAEConfig.tiny(), **kw),
        "ClipTextEncoder": lambda **kw: clip.ClipTextEncoder(
            clip.ClipTextConfig.tiny(), **kw),
        "FluxTransformer": lambda **kw: flux.FluxTransformer(
            flux.FluxConfig.tiny(), **kw),
        "flux_seeded": lambda **kw: flux.seeded(flux.FluxConfig.tiny(), 0,
                                                **kw),
        "flux_ids": lambda **kw: {"ids": flux.make_ids(1, 4, 8, 8, **kw)},
        "T5Encoder": lambda **kw: t5.T5Encoder(t5.T5Config.tiny(), **kw),
        "DistilBertClassifier": lambda **kw: bert.DistilBertClassifier(
            bert.BertConfig.tiny(), **kw),
        "ViTClassifier": lambda **kw: vit.ViTClassifier(
            vit.ViTConfig.tiny(), **kw),
        "YolosForObjectDetection": lambda **kw:
            yolos.YolosForObjectDetection(yolos.YolosConfig.tiny(), **kw),
        "dense_cache": lambda **kw: {
            "k": llama.init_cache(cfg, 2, 40, **kw).k[0]},
    }


def _tensors(built):
    if isinstance(built, dict):
        return list(built.values())
    if isinstance(built, torch.nn.Module):
        return list(built.parameters())
    return [t for lay in built.kv for t in lay.values()]


@pytest.mark.parametrize("name", ["LlamaForCausalLM", "geometry_params",
                                  "random_params", "PagedKVCache",
                                  "geometry_params_int8",
                                  "LlamaForCausalLM_int8", "mllama_text",
                                  "MllamaVisionModel",
                                  "random_vision_params", "UNet2DCondition",
                                  "AutoencoderKL", "ClipTextEncoder",
                                  "FluxTransformer", "flux_seeded",
                                  "flux_ids", "T5Encoder",
                                  "DistilBertClassifier", "ViTClassifier",
                                  "YolosForObjectDetection", "dense_cache"])
def test_model_weights_and_cache_default_to_the_card(no_cuda, name):
    """With no device given, the model, its weight builders and the KV
    cache go to the card, and raise without one, as the engine and the
    unit do; given the CPU they build there."""
    build = _builders()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    tensors = _tensors(build(device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("unit", ["flux", "t5", "bert", "vit", "yolo",
                                  "llama", "mistral", "deepseek"])
def test_flux_and_t5_units_raise_without_cuda_unless_given_the_cpu(no_cuda,
                                                                   unit):
    from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNITS[unit](ServeConfig(app=unit, model_id="tiny")).load()
    svc = UNITS[unit](ServeConfig(app=unit, model_id="tiny", device="cpu"))
    svc.load()
    model = svc.pipe.model if unit == "flux" else svc.model
    assert all(p.device.type == "cpu" for p in model.parameters())


#: the modules of the six units this port added for the JAX package's
#: remaining names (the encoder units, the dense-cache LLM units)
UNIT_MODULES = (
    "scalable_hw_agnostic_inference_tpu_torch.models.bert",
    "scalable_hw_agnostic_inference_tpu_torch.models.vit",
    "scalable_hw_agnostic_inference_tpu_torch.models.yolos",
    "scalable_hw_agnostic_inference_tpu_torch.models.generate",
    "scalable_hw_agnostic_inference_tpu_torch.models.tokenizer",
    "scalable_hw_agnostic_inference_tpu_torch.serve.units.encoders",
    "scalable_hw_agnostic_inference_tpu_torch.serve.units.yolo",
    "scalable_hw_agnostic_inference_tpu_torch.serve.units.causal_lm",
    # the units over tp ranks: the port's own copies, no JAX-free helper of
    # the JAX package borrowed
    "scalable_hw_agnostic_inference_tpu_torch.core.mesh",
    "scalable_hw_agnostic_inference_tpu_torch.serve.multihost",
)


def test_unit_modules_are_scanned_and_load_nothing_forbidden():
    """The new modules are in the scan (so the AST scan and the fresh
    interpreter of ``test_importing_every_port_module_loads_no_jax`` hold
    them to no JAX, ``transformers``, ``tokenizers`` or PIL); every name
    the JAX package registers is a port unit."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS

    scanned = {n for _, n in _modules()}
    assert set(UNIT_MODULES) <= scanned
    assert not _forbidden_imports(path for path, n in _modules()
                                  if n in UNIT_MODULES)
    assert set(UNITS) == {"vllm", "sd", "sd2", "flux", "t5", "llama",
                          "mistral", "deepseek", "bert", "vit", "yolo"}


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


#: the async-decode slice's modules, and the units-over-ranks slice's:
#: the scans above cover them by name, and a fresh interpreter imports
#: them without loading JAX or any module of the JAX package
SLICE_MODULES = (
    "scalable_hw_agnostic_inference_tpu_torch.obs.steploop",
    "scalable_hw_agnostic_inference_tpu_torch.engine.resident",
    "scalable_hw_agnostic_inference_tpu_torch.engine.graphs",
    "scalable_hw_agnostic_inference_tpu_torch.engine.warm",
    "scalable_hw_agnostic_inference_tpu_torch.core.mesh",
    "scalable_hw_agnostic_inference_tpu_torch.serve.multihost",
)


def test_async_decode_modules_are_scanned_and_load_no_jax():
    scanned = {n for _, n in _modules()}
    assert set(SLICE_MODULES) <= scanned
    heads = tuple(h for h in FORBIDDEN
                  if h != "scalable_hw_agnostic_inference_tpu")
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


#: the fleet KV fabric and live migration (kvnet/directory.py,
#: kvnet/migrate.py) and the modules that call them
KVNET_MODULES = (
    "scalable_hw_agnostic_inference_tpu_torch.kvnet",
    "scalable_hw_agnostic_inference_tpu_torch.kvnet.client",
    "scalable_hw_agnostic_inference_tpu_torch.kvnet.directory",
    "scalable_hw_agnostic_inference_tpu_torch.kvnet.migrate",
)
#: public names the port's kvnet modules keep beside the reference's: the
#: byte cap on a ship's answer, which the reference leaves to httpx
PORT_ONLY_KVNET_NAMES = {"migrate": {"MAX_ACK_BYTES"}}


def _public_names(path: Path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", ["__init__", "directory", "migrate"])
def test_kvnet_modules_keep_the_reference_names(module):
    """The port's ``kvnet`` modules define the reference's public names
    (classes, functions, constants), and only those beside the listed
    port-only ones."""
    ref = REPO / "scalable_hw_agnostic_inference_tpu" / "kvnet"
    port_names = _public_names(PORT_ROOT / "kvnet" / f"{module}.py")
    ref_names = _public_names(ref / f"{module}.py")
    assert ref_names <= port_names, ref_names - port_names
    assert port_names - ref_names == PORT_ONLY_KVNET_NAMES.get(module, set())


def test_kvnet_modules_are_scanned_and_load_no_jax_or_httpx():
    scanned = {n for _, n in _modules()}
    assert set(KVNET_MODULES) <= scanned
    assert _forbidden_imports(
        [PORT_ROOT / "kvnet" / "directory.py",
         PORT_ROOT / "kvnet" / "migrate.py"]) == []
    heads = ("jax", "jaxlib", "flax", "httpx", "prometheus_client")
    code = _PROBE % (heads, list(KVNET_MODULES), heads)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_soft_prefix_modules_are_scanned_and_default_to_the_card(no_cuda):
    """The soft-prefix slice's modules (the encoder blocks, the tower and
    projector, the JPEG decoder, the request image path) are among those
    scanned, import nothing refused, and the tower's constructors run on the
    card unless they are given the CPU."""
    from scalable_hw_agnostic_inference_tpu_torch.models import vlm

    names = dict((n, p) for p, n in _modules())
    new = [f"scalable_hw_agnostic_inference_tpu_torch.{m}" for m in (
        "models.encoder", "models.vlm", "models.jpeg", "models.imageio",
        "models.tokenizer", "serve.units.common")]
    assert set(new) <= set(names)
    assert not _forbidden_imports([names[n] for n in new])
    cfg = vlm.VisionTowerConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vlm.VisionProjector(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vlm.random_params(cfg, seed=0)
    assert vlm.VisionProjector(cfg, device="cpu").device.type == "cpu"


#: the Flux and T5 slice's modules (the Unigram tokenizer among them)
FLUX_MODULES = tuple(
    f"scalable_hw_agnostic_inference_tpu_torch.{m}" for m in (
        "models.flow_match", "models.flux", "models.t5",
        "models.flux_pipeline", "models.tokenizer", "serve.units.flux",
        "serve.units.t5"))


def test_flux_slice_modules_are_scanned():
    """Scanned by name, so the AST scan above and the fresh-interpreter
    import of every port module cover them."""
    scanned = {n for _, n in _modules()}
    assert set(FLUX_MODULES) <= scanned
    assert not _forbidden_imports(p for p, n in _modules()
                                  if n in FLUX_MODULES)


TP_ENGINE_MODULES = ("scalable_hw_agnostic_inference_tpu_torch."
                     "parallel.distributed",
                     "scalable_hw_agnostic_inference_tpu_torch.engine.ranks")


def test_tp_engine_modules_are_scanned_and_default_to_the_card(no_cuda):
    """The group and the step mirror are scanned by name (no JAX, no JAX
    package); the launcher and a rank's engine default to the card, and an
    NCCL group needs CUDA."""
    from scalable_hw_agnostic_inference_tpu_torch.engine import ranks
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        random_params,
    )
    from scalable_hw_agnostic_inference_tpu_torch.parallel import (
        distributed,
    )

    scanned = {n for _, n in _modules()}
    assert set(TP_ENGINE_MODULES) <= scanned
    assert not _forbidden_imports(p for p, n in _modules()
                                  if n in TP_ENGINE_MODULES)
    cfg = LlamaConfig.tiny()
    state = random_params(cfg, 0, device="cpu")
    ecfg = EngineConfig(max_model_len=64, context_encoding_buckets=(16,),
                        tensor_parallel_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ranks.launch_engine(cfg, state, ecfg, 2, "gloo")
    with pytest.raises(RuntimeError, match="an NCCL group needs CUDA"):
        distributed.init_group(2, 0, "/nonexistent/store", "nccl")
