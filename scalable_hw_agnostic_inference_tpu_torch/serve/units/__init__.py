"""Model units served by ``python -m scalable_hw_agnostic_inference_tpu_torch.serve``."""

from .vllm import VllmService

#: unit name -> ModelService class
UNITS = {"vllm": VllmService}
