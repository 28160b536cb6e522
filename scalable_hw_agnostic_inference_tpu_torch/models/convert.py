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
"""

from __future__ import annotations

import json
import types
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..core.checkpoint import Checkpoint, PathLike
from ..core.device import DeviceLike, resolve_device
from ..ops.quant import _is_quant_node, quantize_weight
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


def config_from_hf(cfg: Dict) -> LlamaConfig:
    """``config.json`` (a dict) -> :class:`LlamaConfig`, through
    ``LlamaConfig.from_hf`` (llama3 ``rope_scaling`` and tied embeddings
    included; ``transformers``' defaults where a key is absent)."""
    arch = cfg.get("model_type", "llama")
    if arch != "llama":
        raise ValueError(f"config.json model_type {arch!r}: this port reads "
                         f"Llama checkpoints (model_type 'llama')")
    full = {**HF_LLAMA_DEFAULTS, **cfg}
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


def hf_name(port_name: str, prefix: str = "model.") -> str:
    """The HF checkpoint name of a port state-dict name."""
    if port_name == "embed.weight":
        return f"{prefix}embed_tokens.weight"
    if port_name == "final_norm.scale":
        return f"{prefix}norm.weight"
    if port_name == "lm_head.weight":
        return "lm_head.weight"
    _, i, rest = port_name.split(".", 2)
    return f"{prefix}layers.{i}.{_LAYER_NAMES[rest]}"


def load_hf_checkpoint(path: PathLike, device: DeviceLike = None,
                       quantize: bool = False
                       ) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """``(config, state dict)`` of the HF Llama checkpoint directory
    ``path``: bf16 weights on ``device`` (the card unless the caller asks
    for the CPU), int8 projections with ``quantize``."""
    path = Path(path)
    cfg_file = path / "config.json"
    if not cfg_file.is_file():
        raise ValueError(f"{path}: no config.json")
    cfg = config_from_hf(json.loads(cfg_file.read_text()))
    device = resolve_device(device)
    ckpt = Checkpoint(path)
    prefix = "model." if any(k.startswith("model.") for k in ckpt.keys()) \
        else ""
    state: Dict[str, torch.Tensor] = {}
    for name, shape in _weight_shapes(cfg).items():
        src = hf_name(name, prefix)
        if src not in ckpt:
            raise ValueError(f"{path}: checkpoint has no {src!r} (for "
                             f"{name})")
        if ckpt.shape(src) != shape:
            raise ValueError(f"{path}: {src!r} is {ckpt.shape(src)}, the "
                             f"config makes it {shape}")
        t = ckpt.tensor(src, device)
        if t.is_floating_point() and t.dtype != torch.bfloat16:
            t = t.float().to(torch.bfloat16)
        if quantize and _is_quant_node(name, t):
            stem = name[: -len(".weight")]
            state[f"{stem}.weight_q"], state[f"{stem}.scale"] = \
                quantize_weight(t)
            del t
        else:
            state[name] = t
    return cfg, state
