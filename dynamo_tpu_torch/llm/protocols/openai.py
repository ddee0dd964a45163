"""OpenAI-compatible API types (chat completions, completions, embeddings,
responses).

The port's counterpart of the reference package's llm/protocols/openai.py,
which declares these types as pydantic models (absent on the machine the
port serves on). Here requests are plain classes with an explicit
``from_obj`` validator built from the reference's field list, applying the
same rules as pydantic's lax mode:

- a field set to ``None`` is the same as a missing one where the field is
  Optional; a required or non-Optional field refuses ``None``;
- ints take bools, integral floats and integer strings ("5", " 5 ", "5.0");
  floats take ints, bools and numeric strings; bools take 0/1, 0.0/1.0 and
  the strings true/false/yes/no/on/off/t/f/y/n/1/0 in any case; strings
  and literals take strings only;
- a union tries each member strictly, then each leniently, in order;
- ``ge`` / ``gt`` / ``le`` bounds and the models' own cross-field checks;
- unknown fields are kept (the reference's ``_Lenient``, ``extra="allow"``).

Any violation raises ``RequestValidationError``, a ``ValueError``, which
the HTTP frontend answers with a 400 as it does pydantic's. Response types
are dataclasses whose ``to_obj()`` gives the JSON keys of the reference's
``model_dump(exclude_none=True)``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Union


class RequestValidationError(ValueError):
    """A request body that fails the reference models' validation."""


class _Invalid(Exception):
    pass


_MISSING = object()


# ------------------------------------------------------------- field types
# A field type is a callable (value, strict) -> validated value, raising
# _Invalid; a union asks its members strictly first, then leniently.
def _int(v: Any, strict: bool) -> int:
    if type(v) is int:
        return v
    if strict:
        raise _Invalid("Input should be a valid integer")
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, float):
        if math.isfinite(v) and v.is_integer():
            return int(v)
        raise _Invalid("Input should be a valid integer, got a number with a "
                       "fractional part")
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s)
        except ValueError:
            pass
        try:
            f = float(s)
        except ValueError:
            raise _Invalid("Input should be a valid integer, unable to parse string "
                           "as an integer") from None
        if math.isfinite(f) and f.is_integer():
            return int(f)
        raise _Invalid("Input should be a valid integer, unable to parse string as "
                       "an integer")
    raise _Invalid("Input should be a valid integer")


def _float(v: Any, strict: bool) -> float:
    if type(v) in (float, int):
        return float(v)
    if strict:
        raise _Invalid("Input should be a valid number")
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            raise _Invalid("Input should be a valid number, unable to parse string "
                           "as a number") from None
    raise _Invalid("Input should be a valid number")


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _bool(v: Any, strict: bool) -> bool:
    if isinstance(v, bool):
        return v
    if not strict:
        if type(v) in (int, float) and v in (0, 1):
            return bool(v)
        if isinstance(v, str):
            s = v.strip().lower()
            if s in _TRUE:
                return True
            if s in _FALSE:
                return False
    raise _Invalid("Input should be a valid boolean")


def _str(v: Any, strict: bool) -> str:
    if isinstance(v, str):
        return v
    raise _Invalid("Input should be a valid string")


def _literal(*values: str) -> Callable:
    def check(v: Any, strict: bool) -> str:
        if isinstance(v, str) and v in values:
            return v
        raise _Invalid("Input should be " + ", ".join(repr(x) for x in values))
    return check


def _list(item: Callable) -> Callable:
    def check(v: Any, strict: bool) -> list:
        if not isinstance(v, (list, tuple)) or (strict and not isinstance(v, list)):
            raise _Invalid("Input should be a valid list")
        return [item(x, strict) for x in v]
    return check


def _dict(v: Any, strict: bool) -> dict:
    if isinstance(v, dict) and all(isinstance(k, str) for k in v):
        return dict(v)
    raise _Invalid("Input should be a valid dictionary")


def _union(*members: Callable) -> Callable:
    def check(v: Any, strict: bool) -> Any:
        errors = []
        for mode in ((True,) if strict else (True, False)):
            for m in members:
                try:
                    return m(v, mode)
                except _Invalid as e:
                    errors.append(str(e))
        raise _Invalid("; ".join(dict.fromkeys(errors)))
    return check


def _model(cls) -> Callable:
    def check(v: Any, strict: bool):
        if isinstance(v, cls):
            return v
        if not isinstance(v, dict):
            raise _Invalid(f"Input should be a valid dictionary or instance of "
                           f"{cls.__name__}")
        return cls._validate(v)
    return check


@dataclasses.dataclass(frozen=True)
class _F:
    """One field: its type, default (_MISSING: required), whether None is
    allowed, and numeric bounds."""

    kind: Callable
    default: Any = _MISSING
    optional: bool = False
    ge: Optional[float] = None
    gt: Optional[float] = None
    le: Optional[float] = None


def _opt(kind: Callable, **bounds) -> _F:
    return _F(kind, None, True, **bounds)


def _bounds(name: str, f: _F, v: Any) -> None:
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return
    if isinstance(v, float) and math.isnan(v) and (f.ge, f.gt, f.le) != (None,) * 3:
        raise _Invalid(f"{name}: Input should be a finite number")
    if f.ge is not None and not v >= f.ge:
        raise _Invalid(f"{name}: Input should be greater than or equal to {f.ge}")
    if f.gt is not None and not v > f.gt:
        raise _Invalid(f"{name}: Input should be greater than {f.gt}")
    if f.le is not None and not v <= f.le:
        raise _Invalid(f"{name}: Input should be less than or equal to {f.le}")


class _Lenient:
    """Base of the request types: declared fields, extras kept."""

    FIELDS: Dict[str, _F] = {}

    def __init__(self, **kw: Any):
        obj = type(self)._validate(kw)
        self.__dict__.update(obj.__dict__)

    @classmethod
    def from_obj(cls, obj: Any):
        """Validate a decoded JSON body; RequestValidationError on failure."""
        if isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            raise RequestValidationError(
                f"1 validation error for {cls.__name__}: Input should be a valid "
                "dictionary")
        try:
            return cls._validate(obj)
        except _Invalid as e:
            raise RequestValidationError(
                f"1 validation error for {cls.__name__}: {e}") from None

    @classmethod
    def _validate(cls, obj: Dict[str, Any]):
        self = cls.__new__(cls)
        values: Dict[str, Any] = {}
        for name, f in cls.FIELDS.items():
            v = obj.get(name, _MISSING)
            if v is _MISSING:
                if f.default is _MISSING:
                    raise _Invalid(f"{name}: Field required")
                values[name] = f.default
                continue
            if v is None:
                if not f.optional:
                    raise _Invalid(f"{name}: Input should not be None")
                values[name] = None
                continue
            try:
                v = f.kind(v, False)
            except _Invalid as e:
                raise _Invalid(f"{name}: {e}") from None
            _bounds(name, f, v)
            values[name] = v
        self.__dict__.update(values)
        self._extra = {k: v for k, v in obj.items() if k not in cls.FIELDS}
        self._check()
        return self

    def _check(self) -> None:
        """Cross-field checks (the reference's model validators)."""

    def __getattr__(self, name: str) -> Any:
        extra = self.__dict__.get("_extra") or {}
        if name in extra:
            return extra[name]
        raise AttributeError(name)

    def to_obj(self, exclude_none: bool = True) -> Dict[str, Any]:
        """The reference's ``model_dump(exclude_none=...)``: declared fields
        then extras, nested models dumped."""
        out: Dict[str, Any] = {}
        for name in list(self.FIELDS) + list(self._extra):
            v = getattr(self, name)
            if isinstance(v, _Lenient):
                v = v.to_obj(exclude_none)
            elif isinstance(v, list):
                v = [x.to_obj(exclude_none) if isinstance(x, _Lenient) else x for x in v]
            if v is None and exclude_none:
                continue
            out[name] = v
        return out


# ---------------------------------------------------------------- requests
_ROLES = ("system", "user", "assistant", "tool", "developer")


class ChatMessage(_Lenient):
    FIELDS = {
        "role": _F(_literal(*_ROLES)),
        "content": _opt(_union(_str, _list(_dict))),
        "name": _opt(_str),
        "tool_calls": _opt(_list(_dict)),
        "tool_call_id": _opt(_str),
    }


class StreamOptions(_Lenient):
    FIELDS = {"include_usage": _F(_bool, False)}


class ChatAudioParams(_Lenient):
    FIELDS = {
        "voice": _F(_str, "alloy"),
        "format": _F(_literal("wav", "mp3", "flac", "opus", "pcm16"), "wav"),
    }


_SAMPLING_FIELDS = {
    "max_tokens": _opt(_int, ge=1),
    "max_completion_tokens": _opt(_int, ge=1),
    "temperature": _opt(_float, ge=0.0, le=2.0),
    "top_p": _opt(_float, gt=0.0, le=1.0),
    "top_k": _opt(_int, ge=-1),
    "min_p": _opt(_float, ge=0.0, le=1.0),
    "seed": _opt(_int),
    "stop": _opt(_union(_str, _list(_str))),
    "frequency_penalty": _opt(_float, ge=-2.0, le=2.0),
    "presence_penalty": _opt(_float, ge=-2.0, le=2.0),
    "repetition_penalty": _opt(_float, gt=0.0),
    # n > 1 fans the request into n independent engine streams
    "n": _F(_int, 1, ge=1, le=16),
    "logprobs": _opt(_union(_bool, _int)),
    "top_logprobs": _opt(_int, ge=0, le=20),
    "ignore_eos": _opt(_bool),
    # SLA class (runtime/slo.py): resolved by the frontend, accounted in
    # its SLO ledger and the worker's
    "sla": _opt(_str),
    # guided decoding (at most one); chat requests can also use
    # response_format json_schema / json_object (llm/preprocessor.py)
    "guided_regex": _opt(_str),
    "guided_json": _opt(_union(_dict, _str)),
    "guided_choice": _opt(_list(_str)),
}


class SamplingFields(_Lenient):
    """Fields shared by chat and text completion requests."""

    FIELDS = _SAMPLING_FIELDS

    def _check(self) -> None:
        set_ = [n for n in ("guided_regex", "guided_json", "guided_choice")
                if getattr(self, n) is not None]
        if len(set_) > 1:
            raise _Invalid(f"Value error, only one guided option may be set, got {set_}")
        # completions-style integer logprobs: the same 0..20 window
        if isinstance(self.logprobs, int) and not isinstance(self.logprobs, bool):
            if not 0 <= self.logprobs <= 20:
                raise _Invalid("Value error, logprobs must be between 0 and 20")
        if self.top_logprobs is not None and not self.logprobs:
            raise _Invalid("Value error, top_logprobs requires logprobs to be set")

    def stop_list(self) -> List[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def effective_max_tokens(self) -> Optional[int]:
        return self.max_completion_tokens or self.max_tokens


class ChatCompletionRequest(SamplingFields):
    FIELDS = {
        **_SAMPLING_FIELDS,
        "model": _F(_str),
        "messages": _F(_list(_model(ChatMessage))),
        "stream": _F(_bool, False),
        "stream_options": _opt(_model(StreamOptions)),
        "tools": _opt(_list(_dict)),
        "tool_choice": _opt(_union(_str, _dict)),
        "response_format": _opt(_dict),
        "user": _opt(_str),
        "modalities": _opt(_list(_literal("text", "audio"))),
        "audio": _opt(_model(ChatAudioParams)),
        "routing": _opt(_dict),
        # multi-LoRA: adapter name to apply (lora/adapters.py)
        "lora": _opt(_str),
        # named logits processors to enable (logits_processing/)
        "logits_processors": _opt(_list(_str)),
    }

    def _check(self) -> None:
        super()._check()
        if not self.messages:
            raise _Invalid("Value error, messages must not be empty")


_PROMPT = _union(_str, _list(_str), _list(_int), _list(_list(_int)))


class CompletionRequest(SamplingFields):
    FIELDS = {
        **_SAMPLING_FIELDS,
        "model": _F(_str),
        "prompt": _F(_PROMPT),
        "stream": _F(_bool, False),
        "stream_options": _opt(_model(StreamOptions)),
        "echo": _F(_bool, False),
        "user": _opt(_str),
        "routing": _opt(_dict),
        "lora": _opt(_str),
        "logits_processors": _opt(_list(_str)),
    }


class EmbeddingRequest(_Lenient):
    FIELDS = {
        "model": _F(_str),
        "input": _F(_PROMPT),
        "encoding_format": _F(_literal("float", "base64"), "float"),
        "dimensions": _opt(_int, ge=1),
    }


class ResponsesRequest(_Lenient):
    """/v1/responses: converted to a chat request internally, text inputs
    only. ``input`` is a string, or a list of {role, content} items whose
    content is a string or [{type: "input_text" / "output_text" / "text",
    text}] parts."""

    FIELDS = {
        "model": _F(_str),
        "input": _F(_union(_str, _list(_dict))),
        "instructions": _opt(_str),
        "max_output_tokens": _opt(_int, ge=1),
        "temperature": _opt(_float, ge=0.0, le=2.0),
        "top_p": _opt(_float, gt=0.0, le=1.0),
        "stream": _F(_bool, False),
        "user": _opt(_str),
        # SLA class, as the chat field
        "sla": _opt(_str),
    }

    def to_chat(self) -> ChatCompletionRequest:
        """The chat request this one stands for; RequestValidationError
        where its messages do not validate."""
        messages: List[Dict[str, Any]] = []
        if self.instructions:
            messages.append({"role": "system", "content": self.instructions})
        if isinstance(self.input, str):
            messages.append({"role": "user", "content": self.input})
        else:
            for item in self.input:
                content = item.get("content", "")
                if isinstance(content, list):
                    content = "".join(
                        p.get("text", "") for p in content
                        if p.get("type") in ("input_text", "output_text", "text"))
                role = item.get("role", "user")
                if role not in _ROLES:
                    role = "user"
                messages.append({"role": role, "content": content})
        return ChatCompletionRequest.from_obj(dict(
            model=self.model, messages=messages, max_tokens=self.max_output_tokens,
            temperature=self.temperature, top_p=self.top_p, stream=self.stream,
            user=self.user))


# --------------------------------------------------------------- responses
def _dump(v: Any) -> Any:
    """``model_dump(exclude_none=True)``: None fields of a model dropped,
    plain dicts (logprobs, tool calls) kept as they are."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _dump(getattr(v, f.name)) for f in dataclasses.fields(v)
                if getattr(v, f.name) is not None}
    if isinstance(v, list):
        return [_dump(x) for x in v]
    return v


class _Response:
    def to_obj(self) -> Dict[str, Any]:
        return _dump(self)

    def to_json(self) -> str:
        """``model_dump_json(exclude_none=True)``."""
        return json.dumps(self.to_obj(), separators=(",", ":"), ensure_ascii=False)


@dataclasses.dataclass
class Usage(_Response):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    # extension: prefix-cache hit accounting
    cached_tokens: Optional[int] = None


@dataclasses.dataclass
class ChatResponseMessage(_Response):
    role: str = "assistant"
    content: Optional[str] = None
    reasoning_content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    audio: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatChoice(_Response):
    message: ChatResponseMessage
    index: int = 0
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatCompletionResponse(_Response):
    id: str
    created: int
    model: str
    choices: List[ChatChoice]
    object: str = "chat.completion"
    usage: Optional[Usage] = None


@dataclasses.dataclass
class ChatDelta(_Response):
    role: Optional[str] = None
    content: Optional[str] = None
    reasoning_content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    audio: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatChunkChoice(_Response):
    delta: ChatDelta
    index: int = 0
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatCompletionChunk(_Response):
    id: str
    created: int
    model: str
    choices: List[ChatChunkChoice]
    object: str = "chat.completion.chunk"
    usage: Optional[Usage] = None


@dataclasses.dataclass
class CompletionChoice(_Response):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class CompletionResponse(_Response):
    id: str
    created: int
    model: str
    choices: List[CompletionChoice]
    object: str = "text_completion"
    usage: Optional[Usage] = None


@dataclasses.dataclass
class EmbeddingData(_Response):
    index: int
    # list of floats, or base64 of little-endian float32 for
    # encoding_format="base64"
    embedding: Union[List[float], str]
    object: str = "embedding"


@dataclasses.dataclass
class EmbeddingResponse(_Response):
    data: List[EmbeddingData]
    model: str
    object: str = "list"
    usage: Optional[Usage] = None


@dataclasses.dataclass
class ResponseOutputText(_Response):
    type: str = "output_text"
    text: str = ""
    annotations: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ResponseMessage(_Response):
    id: str
    type: str = "message"
    role: str = "assistant"
    status: str = "completed"
    content: List[ResponseOutputText] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ResponseUsage(_Response):
    input_tokens: int = 0
    output_tokens: int = 0
    total_tokens: int = 0


@dataclasses.dataclass
class ResponseObject(_Response):
    id: str
    object: str = "response"
    created_at: int = 0
    status: str = "completed"
    model: str = ""
    output: List[ResponseMessage] = dataclasses.field(default_factory=list)
    usage: Optional[ResponseUsage] = None

    @property
    def output_text(self) -> str:
        return "".join(part.text for msg in self.output for part in msg.content)


@dataclasses.dataclass
class ModelInfo(_Response):
    id: str
    object: str = "model"
    created: int = 0
    owned_by: str = "dynamo-tpu"


@dataclasses.dataclass
class ModelList(_Response):
    data: List[ModelInfo]
    object: str = "list"


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now_ts() -> int:
    return int(time.time())

