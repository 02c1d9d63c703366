"""Multi-LoRA serving (the port of ``qspec_tpu/lora/``)."""

from qspec_tpu_torch.lora.layers import (LoRAConfig, init_lora_params, load_peft_adapter,
                                         lora_delta)

__all__ = ["LoRAConfig", "init_lora_params", "load_peft_adapter", "lora_delta"]
