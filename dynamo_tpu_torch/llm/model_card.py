"""ModelDeploymentCard: the unit of model discovery.

The port's copy of the reference package's llm/model_card.py (stored under
``v1/mdc``): everything a frontend needs to serve a model — name, tokenizer
source, context limits, KV block size, model type, migration limit, runtime
config — written to the discovery store by workers under their lease,
watched by frontends. The fields are the reference's, so either package's
frontend reads either's cards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

MDC_PREFIX = "v1/mdc"

MODEL_TYPE_CHAT = "chat"
MODEL_TYPE_COMPLETIONS = "completions"
MODEL_TYPE_EMBEDDING = "embedding"
MODEL_TYPE_PREFILL = "prefill"  # prefill-only pool member (disaggregation)

# models/vision.IMAGE_TOKEN_ID, held here so the frontend imports no torch
_IMAGE_TOKEN_ID = 0x7F_FF_F0

MODEL_INPUT_TEXT = "text"      # worker wants raw text (does its own tokenize)
MODEL_INPUT_TOKENS = "tokens"  # worker wants token ids (frontend preprocesses)


def mdc_key(namespace: str, model_slug: str, instance_id: int) -> str:
    return f"{MDC_PREFIX}/{namespace}/{model_slug}/{instance_id:016x}"


def model_slug(name: str) -> str:
    return name.replace("/", "--").lower()


@dataclasses.dataclass
class ModelRuntimeConfig:
    """Worker capability advertisement."""

    total_kv_blocks: int = 0
    kv_block_size: int = 16
    max_batch_size: int = 0
    data_parallel_size: int = 1
    tensor_parallel_size: int = 1
    max_context_len: int = 0
    # wire bytes of one KV block in this worker's cache storage format
    # (kvbm/layout.kv_bytes_per_token * block_size; int8 is ~half bf16)
    kv_bytes_per_block: int = 0
    # per-model SLA target overrides keyed by class name (read by the
    # reference's SLO plane; carried, unused, by the port)
    sla_classes: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    def to_obj(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "ModelRuntimeConfig":
        return cls(**{k: v for k, v in obj.items() if k in {f.name for f in dataclasses.fields(cls)}})


@dataclasses.dataclass
class ModelDeploymentCard:
    name: str                                  # served model name ("meta-llama/Llama-3-8B")
    namespace: str = "dynamo"
    component: str = "backend"
    endpoint: str = "generate"
    model_type: List[str] = dataclasses.field(default_factory=lambda: [MODEL_TYPE_CHAT, MODEL_TYPE_COMPLETIONS])
    model_input: str = MODEL_INPUT_TOKENS
    # tokenizer/template source: HF repo id or local path; None -> no preprocessor
    tokenizer: Optional[str] = None
    context_length: int = 8192
    kv_block_size: int = 16
    migration_limit: int = 0
    # streaming output parsers (parsers/ registry names, the reference's);
    # None passes raw text through
    reasoning_parser: Optional[str] = None
    tool_parser: Optional[str] = None
    # multimodal (models/vision.py): placeholder token id, soft tokens per
    # image, and the square input size images are resized to. image_tokens=0
    # means the model is text-only.
    image_token_id: int = _IMAGE_TOKEN_ID
    image_tokens: int = 0
    image_size: int = 0
    # audio capability: False means audio parts / modalities=["audio"]
    # requests get a clear 400
    audio: bool = False
    runtime_config: ModelRuntimeConfig = dataclasses.field(default_factory=ModelRuntimeConfig)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def slug(self) -> str:
        return model_slug(self.name)

    def to_obj(self) -> Dict[str, Any]:
        obj = dataclasses.asdict(self)
        obj["runtime_config"] = self.runtime_config.to_obj()
        return obj

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "ModelDeploymentCard":
        rc = ModelRuntimeConfig.from_obj(obj.get("runtime_config") or {})
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in obj.items() if k in known and k != "runtime_config"}
        return cls(runtime_config=rc, **kwargs)
