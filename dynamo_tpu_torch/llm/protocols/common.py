"""Internal wire types between frontend pipeline and workers.

Analog of the reference's PreprocessedRequest / BackendOutput / LLMEngineOutput
(lib/llm/src/protocols/common/llm_backend.rs). These are msgpack-friendly
dicts-with-codecs: the request plane carries plain objects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_CANCELLED = "cancelled"
FINISH_ERROR = "error"


@dataclasses.dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    stop_strings: List[str] = dataclasses.field(default_factory=list)
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    ignore_eos: bool = False
    min_tokens: int = 0

    def to_obj(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "StopConditions":
        return cls(**obj)


@dataclasses.dataclass
class SamplingOptions:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    min_p: float = 0.0
    seed: Optional[int] = None
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logprobs: int = 0       # number of top-logprob alternatives to return
    # logprobs can be "on" with zero alternatives (chat logprobs:true without
    # top_logprobs; completions logprobs:0) — the chosen token's logprob is
    # still returned, so a separate enable flag is needed
    want_logprobs: bool = False
    # guided decoding (dynamo_tpu/guided; reference GuidedDecodingOptions,
    # lib/llm/src/protocols/common.rs:336): {"kind": "regex"|"json"|
    # "choice"|"json_object", "value": ...} — compiled to on-device token
    # masks by the engine
    guided: Optional[Dict[str, Any]] = None

    def to_obj(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "SamplingOptions":
        return cls(**obj)


@dataclasses.dataclass
class PreprocessedRequest:
    """What actually travels to a worker: token ids + generation config."""

    request_id: str
    model: str
    token_ids: List[int]
    stop: StopConditions = dataclasses.field(default_factory=StopConditions)
    sampling: SamplingOptions = dataclasses.field(default_factory=SamplingOptions)
    # routing annotations: estimated prefix-cache overlap etc.
    annotations: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # disaggregation: transfer metadata injected between prefill and decode
    kv_transfer: Optional[Dict[str, Any]] = None
    # request migration: tokens already generated before a worker died
    prior_token_ids: List[int] = dataclasses.field(default_factory=list)

    def to_obj(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id,
            "model": self.model,
            "token_ids": self.token_ids,
            "stop": self.stop.to_obj(),
            "sampling": self.sampling.to_obj(),
            "annotations": self.annotations,
            "kv_transfer": self.kv_transfer,
            "prior_token_ids": self.prior_token_ids,
        }

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "PreprocessedRequest":
        return cls(
            request_id=obj["request_id"],
            model=obj["model"],
            token_ids=list(obj["token_ids"]),
            stop=StopConditions.from_obj(obj.get("stop", {})),
            sampling=SamplingOptions.from_obj(obj.get("sampling", {})),
            annotations=obj.get("annotations") or {},
            kv_transfer=obj.get("kv_transfer"),
            prior_token_ids=list(obj.get("prior_token_ids") or []),
        )


@dataclasses.dataclass
class BackendOutput:
    """One streamed step from a worker: newly generated token ids (+ text if
    the worker detokenizes), cumulative counts, and finish state."""

    token_ids: List[int] = dataclasses.field(default_factory=list)
    text: Optional[str] = None
    finish_reason: Optional[str] = None
    cumulative_tokens: int = 0
    # logprob of each token in token_ids (parallel list), optional
    logprobs: Optional[List[float]] = None
    top_logprobs: Optional[List[Dict[int, float]]] = None
    # detokenized OpenAI-shaped logprob entries, parallel to token_ids; built
    # by the worker-side Backend (it owns the tokenizer):
    # {token, logprob, bytes, top_logprobs: [{token, logprob, bytes}, ...]}
    logprob_entries: Optional[List[Dict[str, Any]]] = None
    # metrics annotations (first chunk): cached_tokens, input_tokens, and the
    # router-stamped worker_id echoed back for flight-recorder attribution;
    # error-finish frames carry "error" (the reason) and optionally
    # "evacuation" (a kv_transfer plan for the retry). The key namespace is
    # a declared contract (tools/analysis/contracts.py request-annotations).
    annotations: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # disaggregation: prefill worker returns kv transfer params here
    kv_transfer: Optional[Dict[str, Any]] = None

    def to_obj(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"token_ids": self.token_ids, "cum": self.cumulative_tokens}
        if self.text is not None:
            out["text"] = self.text
        if self.finish_reason is not None:
            out["finish"] = self.finish_reason
        if self.logprobs is not None:
            out["logprobs"] = self.logprobs
        if self.top_logprobs is not None:
            out["top_logprobs"] = [
                {str(k): v for k, v in d.items()} for d in self.top_logprobs
            ]
        if self.logprob_entries is not None:
            out["logprob_entries"] = self.logprob_entries
        if self.annotations:
            out["ann"] = self.annotations
        if self.kv_transfer is not None:
            out["kv_transfer"] = self.kv_transfer
        return out

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "BackendOutput":
        return cls(
            token_ids=list(obj.get("token_ids", [])),
            text=obj.get("text"),
            finish_reason=obj.get("finish"),
            cumulative_tokens=obj.get("cum", 0),
            logprobs=obj.get("logprobs"),
            top_logprobs=[
                {int(k): v for k, v in d.items()} for d in obj["top_logprobs"]
            ]
            if obj.get("top_logprobs")
            else None,
            logprob_entries=obj.get("logprob_entries"),
            annotations=obj.get("ann") or {},
            kv_transfer=obj.get("kv_transfer"),
        )
