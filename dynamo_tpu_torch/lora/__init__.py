"""Multi-LoRA serving: device-resident adapter tables (adapters.py),
adapter sources with a local cache (cache.py) and fleet placement by
rendezvous hashing (routing.py)."""

from .adapters import LoraAdapterTable, PackedAdapterIds, make_lora_fn
from .cache import LoRACache, LocalLoRASource, from_peft_dir, load_adapter
from .routing import LoraReplicaConfig, LoraRoutingTable, RendezvousHasher, allocate

__all__ = [
    "LoraAdapterTable",
    "PackedAdapterIds",
    "make_lora_fn",
    "LoRACache",
    "LocalLoRASource",
    "from_peft_dir",
    "load_adapter",
    "LoraReplicaConfig",
    "LoraRoutingTable",
    "RendezvousHasher",
    "allocate",
]
