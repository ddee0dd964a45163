"""Multi-LoRA serving: device-resident adapter tables (adapters.py) and
adapter sources with a local cache (cache.py). The reference's fleet
routing (dynamo_tpu/lora/routing.py) waits for the port's KV router."""

from .adapters import LoraAdapterTable, PackedAdapterIds, make_lora_fn
from .cache import LoRACache, LocalLoRASource, from_peft_dir, load_adapter

__all__ = [
    "LoraAdapterTable",
    "PackedAdapterIds",
    "make_lora_fn",
    "LoRACache",
    "LocalLoRASource",
    "from_peft_dir",
    "load_adapter",
]
