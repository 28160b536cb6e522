"""Model units served by ``python -m scalable_hw_agnostic_inference_tpu_torch.serve``."""

from .flux import FluxService
from .sd import SDService
from .t5 import T5EmbedService
from .vllm import VllmService

#: unit name -> ModelService class; ``sd`` and ``sd2`` are one unit (the
#: reference's ``run-sd.py`` and ``run-sd2.py`` differ only in a title)
UNITS = {"vllm": VllmService, "sd": SDService, "sd2": SDService,
         "flux": FluxService, "t5": T5EmbedService}
