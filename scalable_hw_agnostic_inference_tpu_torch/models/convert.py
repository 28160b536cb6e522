"""A Hugging Face Llama checkpoint directory -> the port's model.

Port of the JAX package's HF conversion for the Llama family
(``models/llama.py:388`` ``params_from_torch``, ``models/convert.py:72``
``cast_f32_to_bf16``, ``LlamaConfig.from_hf``), reading the directory
itself instead of through ``transformers``: ``config.json`` for the
configuration and the safetensors files through ``core.checkpoint``.

The names map as ``params_from_torch`` maps them: ``model.embed_tokens``
-> ``embed``, ``self_attn.{q,k,v,o}_proj`` -> ``attn.{q,k,v,o}``,
``mlp.{gate,up,down}_proj`` -> ``mlp.{gate,up,down}``,
``input_layernorm`` / ``post_attention_layernorm`` -> ``attn_norm`` /
``mlp_norm`` scales, ``model.norm`` -> ``final_norm``, ``lm_head`` (absent
with tied embeddings). Every float tensor becomes bf16, rounded to nearest
even, as the reference's ``cast_f32_to_bf16`` does to its fp32 leaves (an
F16 or BF16 tensor takes the same path through fp32, exactly); with
``quantize`` each projection is quantized right after it lands, the
reference's order (cast, then ``quantize_params_tree``). Tensors go to
the device one at a time.

An HF LLaVA directory (``config.json`` with ``model_type: "llava"``, a
Llama ``text_config`` and a CLIP ``vision_config``, ``transformers``'
``LlavaConfig`` and ``CLIPVisionConfig`` defaults filled in where a key is
absent, as llava-1.5-7b-hf's sparse ``text_config`` needs):
:func:`load_llava_checkpoint` reads the language model through the Llama
path and the CLIP tower and projector through ``models.vlm``.

An HF mllama directory (``config.json`` with ``model_type: "mllama"``, its
``text_config`` and ``vision_config``; the reference's ``causal_lm.py:
90-200`` reads it through ``transformers``): :func:`load_mllama_checkpoint`
reads the text tower in either key layout (``language_model.model.*`` with
``language_model.lm_head``, or ``model.language_model.*`` with ``lm_head``,
the two the reference strips at ``causal_lm.py:116-123``), the cross
layers' ``cross_attn.*`` and their ``cross_attn_attn_gate`` and
``cross_attn_mlp_gate``, the embedding with its ``vocab_size + 8`` rows as
it is, and the vision tower and projector under ``vision_model`` /
``multi_modal_projector`` or ``model.vision_model`` /
``model.multi_modal_projector`` (``models.mllama.vision_state_from_hf``),
with the aspect ratios of ``vision_config`` and the ``image_mean`` /
``image_std`` of ``preprocessor_config.json`` (CLIP's when it has none, as
in ``causal_lm.py:128-147``).
"""

from __future__ import annotations

import json
import types
from pathlib import Path
from typing import Dict, Iterator, Tuple

import torch

from ..core.checkpoint import Checkpoint, PathLike
from ..core.device import DeviceLike, resolve_device
from ..ops.quant import _is_quant_node, quantize_weight
from . import mllama as mllama_mod
from . import vlm as vlm_mod
from .llama import LlamaConfig, _weight_shapes

#: port name suffix -> HF name suffix, per layer
_LAYER_NAMES = {
    "attn.q.weight": "self_attn.q_proj.weight",
    "attn.k.weight": "self_attn.k_proj.weight",
    "attn.v.weight": "self_attn.v_proj.weight",
    "attn.o.weight": "self_attn.o_proj.weight",
    "mlp.gate.weight": "mlp.gate_proj.weight",
    "mlp.up.weight": "mlp.up_proj.weight",
    "mlp.down.weight": "mlp.down_proj.weight",
    "attn_norm.scale": "input_layernorm.weight",
    "mlp_norm.scale": "post_attention_layernorm.weight",
    # an mllama cross layer's
    "cross_attn.q.weight": "cross_attn.q_proj.weight",
    "cross_attn.k.weight": "cross_attn.k_proj.weight",
    "cross_attn.v.weight": "cross_attn.v_proj.weight",
    "cross_attn.o.weight": "cross_attn.o_proj.weight",
    "cross_attn.q_norm.scale": "cross_attn.q_norm.weight",
    "cross_attn.k_norm.scale": "cross_attn.k_norm.weight",
    "gate_attn": "cross_attn_attn_gate",
    "gate_mlp": "cross_attn_mlp_gate",
}


#: ``transformers.LlamaConfig``'s defaults for the keys ``from_hf`` reads
#: (a ``config.json`` may leave out a key at its default)
HF_LLAMA_DEFAULTS = {
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "rope_scaling": None,
    "tie_word_embeddings": False,
}


#: ``transformers.MllamaTextConfig``'s defaults (Llama-3.2-11B-Vision's
#: text tower)
HF_MLLAMA_TEXT_DEFAULTS = {
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 40, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "rope_scaling": None,
    "tie_word_embeddings": False,
    "cross_attention_layers": [3, 8, 13, 18, 23, 28, 33, 38],
}

#: ``transformers.MllamaVisionConfig``'s defaults
HF_MLLAMA_VISION_DEFAULTS = {
    "hidden_size": 1280, "num_hidden_layers": 32, "num_global_layers": 8,
    "attention_heads": 16, "intermediate_size": 5120, "image_size": 448,
    "patch_size": 14, "norm_eps": 1e-5, "max_num_tiles": 4,
    "intermediate_layers_indices": [3, 7, 15, 23, 30],
    "supported_aspect_ratios": [[1, 1], [1, 2], [1, 3], [1, 4], [2, 1],
                                [2, 2], [3, 1], [4, 1]],
}


#: ``transformers.LlavaConfig``'s defaults (its ``text_config`` defaults to
#: ``LlamaConfig()``'s, its ``vision_config`` to CLIP-L/14-336's)
HF_LLAVA_DEFAULTS = {
    "ignore_index": -100, "image_token_index": 32000,
    "projector_hidden_act": "gelu",
    "vision_feature_select_strategy": "default",
    "vision_feature_layer": -2, "image_seq_length": 576,
    "multimodal_projector_bias": True,
}

#: the ``vision_config`` ``LlavaConfig`` builds when it is given none
HF_LLAVA_VISION_DEFAULT = {
    "intermediate_size": 4096, "hidden_size": 1024, "patch_size": 14,
    "image_size": 336, "num_hidden_layers": 24, "num_attention_heads": 16,
    "vocab_size": 32000, "projection_dim": 768,
}

#: ``transformers.CLIPVisionConfig``'s defaults
HF_CLIP_VISION_DEFAULTS = {
    "hidden_size": 768, "intermediate_size": 3072, "projection_dim": 512,
    "num_hidden_layers": 12, "num_attention_heads": 12, "num_channels": 3,
    "image_size": 224, "patch_size": 32, "hidden_act": "quick_gelu",
    "layer_norm_eps": 1e-5,
}


def config_from_hf(cfg: Dict) -> LlamaConfig:
    """``config.json`` (a dict) -> :class:`LlamaConfig`, through
    ``LlamaConfig.from_hf`` (llama3 ``rope_scaling`` and tied embeddings
    included; ``transformers``' defaults where a key is absent). An mllama
    ``text_config`` (``model_type: "mllama_text_model"``) gives the text
    tower with its cross layers."""
    arch = cfg.get("model_type", "llama")
    if arch not in ("llama", "mllama_text_model"):
        raise ValueError(f"config.json model_type {arch!r}: this port reads "
                         f"Llama checkpoints (model_type 'llama') and "
                         f"mllama ones (model_type 'mllama')")
    defaults = (HF_LLAMA_DEFAULTS if arch == "llama"
                else HF_MLLAMA_TEXT_DEFAULTS)
    full = {**defaults, **cfg}
    if full.get("num_key_value_heads") is None:
        full["num_key_value_heads"] = full["num_attention_heads"]
    unsupported = [k for k in ("attention_bias", "mlp_bias") if full.get(k)]
    if full.get("hidden_act", "silu") != "silu":
        unsupported.append(f"hidden_act={full['hidden_act']!r}")
    hd = full["hidden_size"] // full["num_attention_heads"]
    if full.get("head_dim") not in (None, hd):
        unsupported.append(f"head_dim={full['head_dim']} (not hidden_size / "
                           f"num_attention_heads = {hd})")
    if unsupported:
        raise ValueError(f"config.json: {', '.join(unsupported)} not "
                         f"supported by this port's Llama")
    return LlamaConfig.from_hf(types.SimpleNamespace(**full))


def hf_name(port_name: str, prefix: str = "model.",
            lm_head: str = "lm_head.weight") -> str:
    """The HF checkpoint name of a port state-dict name (an mllama text
    tower's ``prefix`` and ``lm_head`` name come from its layout)."""
    if port_name == "embed.weight":
        return f"{prefix}embed_tokens.weight"
    if port_name == "final_norm.scale":
        return f"{prefix}norm.weight"
    if port_name == "lm_head.weight":
        return lm_head
    _, i, rest = port_name.split(".", 2)
    return f"{prefix}layers.{i}.{_LAYER_NAMES[rest]}"


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """A float tensor as bf16, rounded to nearest even (through fp32)."""
    if t.is_floating_point() and t.dtype != torch.bfloat16:
        t = t.float().to(torch.bfloat16)
    return t


def _text_items(path: Path, ckpt: Checkpoint, cfg: LlamaConfig, prefix: str,
                lm_head: str, device: torch.device, quantize: bool,
                embed_rows=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """The text tower's ``(name, tensor)`` entries, each read onto
    ``device`` only when the caller takes it (bf16, int8 projections with
    ``quantize``)."""
    for name, shape in _weight_shapes(cfg, embed_rows).items():
        src = hf_name(name, prefix, lm_head)
        if src not in ckpt:
            raise ValueError(f"{path}: checkpoint has no {src!r} (for "
                             f"{name})")
        if ckpt.shape(src) != shape:
            raise ValueError(f"{path}: {src!r} is {ckpt.shape(src)}, the "
                             f"config makes it {shape}")
        t = _bf16(ckpt.tensor(src, device))
        if quantize and _is_quant_node(name, t):
            stem = name[: -len(".weight")]
            q, s = quantize_weight(t)
            del t
            yield f"{stem}.weight_q", q
            yield f"{stem}.scale", s
        else:
            yield name, t


def _read_text(path: Path, ckpt: Checkpoint, cfg: LlamaConfig, prefix: str,
               lm_head: str, device: torch.device, quantize: bool,
               embed_rows=None) -> Dict[str, torch.Tensor]:
    """The text tower's state dict, one tensor at a time onto ``device``
    (bf16, int8 projections with ``quantize``)."""
    return dict(_text_items(path, ckpt, cfg, prefix, lm_head, device,
                            quantize, embed_rows))


def load_hf_checkpoint(path: PathLike, device: DeviceLike = None,
                       quantize: bool = False
                       ) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """``(config, state dict)`` of the HF Llama checkpoint directory
    ``path``: bf16 weights on ``device`` (the card unless the caller asks
    for the CPU), int8 projections with ``quantize``."""
    cfg, items = hf_checkpoint_items(path, device, quantize)
    return cfg, dict(items)


def hf_checkpoint_items(path: PathLike, device: DeviceLike = None,
                        quantize: bool = False
                        ) -> Tuple[LlamaConfig,
                                   Iterator[Tuple[str, torch.Tensor]]]:
    """:func:`load_hf_checkpoint` one tensor at a time: ``(config, the
    state dict's (name, tensor) entries)``, each entry read from the
    mapped files onto ``device`` only when the caller takes it, so a
    caller that keeps a slice of each holds no more than one whole
    tensor."""
    path = Path(path)
    cfg = config_from_hf(read_config(path))
    device = resolve_device(device)
    ckpt = Checkpoint(path)
    prefix = "model." if any(k.startswith("model.") for k in ckpt.keys()) \
        else ""
    return cfg, _text_items(path, ckpt, cfg, prefix, "lm_head.weight",
                            device, quantize)


def read_config(path: PathLike) -> Dict:
    """A checkpoint directory's ``config.json`` as a dict."""
    cfg_file = Path(path) / "config.json"
    if not cfg_file.is_file():
        raise ValueError(f"{path}: no config.json")
    return json.loads(cfg_file.read_text())


def _model_type(path: PathLike) -> str:
    cfg_file = Path(path) / "config.json"
    if not cfg_file.is_file():
        return ""
    return json.loads(cfg_file.read_text()).get("model_type", "")


def is_mllama_dir(path: PathLike) -> bool:
    """True for a directory whose ``config.json`` names an mllama model."""
    return _model_type(path) == "mllama"


def is_llava_dir(path: PathLike) -> bool:
    """True for a directory whose ``config.json`` names a LLaVA model."""
    return _model_type(path) == "llava"


def llava_configs(raw: Dict) -> Tuple[LlamaConfig,
                                      "vlm_mod.VisionTowerConfig", Dict]:
    """A LLaVA ``config.json`` (a dict) -> (text config, tower config, the
    outer config with ``transformers``' defaults filled in), as
    ``LlavaConfig`` fills them: its own keys, a ``text_config`` read as a
    Llama one (``model_type`` ``llama`` unless it names another), a
    ``vision_config`` over ``CLIPVisionConfig``'s defaults (CLIP-L/14-336
    when absent). A projector activation other than exact GELU, the only
    one the reference computes, is refused."""
    full = {**HF_LLAVA_DEFAULTS, **raw}
    if full["projector_hidden_act"] != "gelu":
        raise ValueError(f"config.json projector_hidden_act="
                         f"{full['projector_hidden_act']!r} not supported "
                         f"(only 'gelu')")
    text = dict(full.get("text_config") or {})
    text.setdefault("model_type", "llama")
    cfg = config_from_hf(text)
    vision = full.get("vision_config")
    vision = dict(HF_LLAVA_VISION_DEFAULT if vision is None else vision)
    kind = vision.get("model_type", "clip_vision_model")
    if kind != "clip_vision_model":
        raise ValueError(f"config.json vision_config model_type {kind!r}: "
                         f"this port reads a CLIP tower only")
    full["vision_config"] = {**HF_CLIP_VISION_DEFAULTS, **vision}
    return cfg, vlm_mod.VisionTowerConfig.from_hf(full, cfg.dim), full


def load_llava_checkpoint(path: PathLike, device: DeviceLike = None,
                          quantize: bool = False):
    """The HF LLaVA directory ``path`` -> ``(text config, text state,
    tower config, tower state)``, the counterpart of the reference's
    ``_load_vlm`` (``causal_lm.py:26-81``) for a local directory: bf16
    weights on ``device`` (the card unless the caller asks for the CPU),
    the language model's projections int8 with ``quantize``. The language
    model is read through the Llama path in either key layout
    (``language_model.model.*`` with ``language_model.lm_head``, or
    ``model.language_model.*`` with ``lm_head``); the tower and projector
    through ``models.vlm.state_from_hf``."""
    path = Path(path)
    raw = read_config(path)
    if raw.get("model_type") != "llava":
        raise ValueError(f"{path}: config.json model_type "
                         f"{raw.get('model_type')!r} is not 'llava'")
    cfg, vcfg, _ = llava_configs(raw)
    device = resolve_device(device)
    ckpt = Checkpoint(path)
    if any(k.startswith("language_model.") for k in ckpt.keys()):
        prefix, lm_head = ("language_model.model.",
                           "language_model.lm_head.weight")
    else:
        prefix, lm_head = "model.language_model.", "lm_head.weight"
    state = _read_text(path, ckpt, cfg, prefix, lm_head, device, quantize)
    vstate = vlm_mod.state_from_hf(
        lambda n: _bf16(ckpt.tensor(n, device)), ckpt.__contains__, vcfg)
    return cfg, state, vcfg, vstate


def mllama_vision_config(vcfg: Dict) -> Tuple[mllama_mod.MllamaVisionConfig,
                                               list]:
    """An mllama ``vision_config`` dict -> (:class:`MllamaVisionConfig`,
    the supported aspect ratios), ``transformers``' defaults where a key
    is absent."""
    full = {**HF_MLLAMA_VISION_DEFAULTS, **vcfg}
    if "num_attention_heads" in vcfg and "attention_heads" not in vcfg:
        full["attention_heads"] = vcfg["num_attention_heads"]
    supported = [list(map(int, g)) for g in full["supported_aspect_ratios"]]
    cfg = mllama_mod.MllamaVisionConfig.from_hf(types.SimpleNamespace(
        **{**full, "max_aspect_ratio_id": len(supported)}))
    return cfg, supported


def load_mllama_checkpoint(path: PathLike, device: DeviceLike = None,
                           quantize: bool = False):
    """The HF mllama directory ``path`` -> ``(text config, text state,
    vision config, vision state, meta)``: bf16 weights on ``device`` (the
    card unless the caller asks for the CPU), the text tower's projections
    int8 with ``quantize``; the vision state holds the vision model's
    ``vision.*`` and the projector's ``proj.*`` weights; ``meta`` holds
    ``supported_aspect_ratios``, ``image_mean`` and ``image_std``."""
    path = Path(path)
    raw = read_config(path)
    if raw.get("model_type") != "mllama":
        raise ValueError(f"{path}: config.json model_type "
                         f"{raw.get('model_type')!r} is not 'mllama'")
    text = dict(raw.get("text_config") or {})
    text.setdefault("model_type", "mllama_text_model")
    cfg = config_from_hf(text)
    vcfg, supported = mllama_vision_config(raw.get("vision_config") or {})
    device = resolve_device(device)
    ckpt = Checkpoint(path)
    if any(k.startswith("language_model.") for k in ckpt.keys()):
        prefix, lm_head = ("language_model.model.",
                           "language_model.lm_head.weight")
    else:
        prefix, lm_head = "model.language_model.", "lm_head.weight"
    # HF's embedding holds the 8 image-token rows past vocab_size: taken
    # as it is (the logits stay vocab_size wide through the lm_head)
    embed = f"{prefix}embed_tokens.weight"
    rows = ckpt.shape(embed)[0] if embed in ckpt else None
    if rows is not None and rows not in (cfg.vocab_size,
                                         cfg.vocab_size + 8):
        raise ValueError(f"{path}: {embed!r} has {rows} rows, expected "
                         f"{cfg.vocab_size} or {cfg.vocab_size + 8}")
    state = _read_text(path, ckpt, cfg, prefix, lm_head, device, quantize,
                       embed_rows=rows)
    vstate = mllama_mod.vision_state_from_hf(
        lambda n: _bf16(ckpt.tensor(n, device)), ckpt.__contains__, vcfg,
        cfg.dim)
    mean, std = mllama_mod.CLIP_MEAN, mllama_mod.CLIP_STD
    pre = path / "preprocessor_config.json"
    if pre.is_file():
        pc = json.loads(pre.read_text())
        if pc.get("image_mean") and pc.get("image_std"):
            mean, std = tuple(pc["image_mean"]), tuple(pc["image_std"])
    meta = {"supported_aspect_ratios": supported, "image_mean": mean,
            "image_std": std}
    return cfg, state, vcfg, vstate, meta
