"""Model units served by ``python -m scalable_hw_agnostic_inference_tpu_torch.serve``."""

from .causal_lm import LlamaService
from .encoders import BertService, ViTService
from .flux import FluxService
from .sd import SDService
from .t5 import T5EmbedService
from .vllm import VllmService
from .yolo import YolosService

#: unit name -> ModelService class: every name the JAX package registers
#: (its ``models/registry.py``). ``sd`` and ``sd2`` are one unit (the
#: reference's ``run-sd.py`` and ``run-sd2.py`` differ only in a title);
#: so are ``llama``, ``mistral`` and ``deepseek`` (one causal-LM service)
UNITS = {"vllm": VllmService, "sd": SDService, "sd2": SDService,
         "flux": FluxService, "t5": T5EmbedService, "llama": LlamaService,
         "mistral": LlamaService, "deepseek": LlamaService,
         "bert": BertService, "vit": ViTService, "yolo": YolosService}
