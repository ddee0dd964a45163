"""Frontend preprocessor: OpenAI request -> PreprocessedRequest (tokens).

The port's copy of the reference package's llm/preprocessor.py: applies the
chat template, tokenizes, folds sampling + stop options and the guided,
``lora`` and ``logits_processors`` options into the internal request, and
stamps metric annotations. A forced named ``tool_choice`` becomes a soft
JSON grammar over the tool's parameters (the delta generator's jail reads
the call out of it); ``"required"`` goes to the jail without a grammar.
Image parts are decoded by llm/media.py (the port's own PNG and JPEG
decoders) into the ``images`` annotation the engine's vision path reads.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from typing import Any, Dict, List, Optional, Union

from ..runtime.errors import (
    ContextLengthError,
    GuidedRejectedError,
    InvalidRequestError,
)
from ..runtime.logging import get_logger
from .model_card import ModelDeploymentCard
from .protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from .protocols.openai import ChatCompletionRequest, CompletionRequest, new_request_id
from .tokenizer import Tokenizer, load_tokenizer

log = get_logger("llm.preprocessor")

_IMAGE_EXECUTOR: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _image_executor() -> concurrent.futures.ThreadPoolExecutor:
    global _IMAGE_EXECUTOR
    if _IMAGE_EXECUTOR is None:
        _IMAGE_EXECUTOR = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="image-decode")
    return _IMAGE_EXECUTOR

ANNOTATION_INPUT_TOKENS = "input_tokens"
ANNOTATION_CACHED_TOKENS = "cached_tokens"
ANNOTATION_WORKER_ID = "worker_id"
ANNOTATION_PREFILL_WORKER_ID = "prefill_worker_id"


class OpenAIPreprocessor:
    def __init__(self, card: ModelDeploymentCard, tokenizer: Tokenizer | None = None):
        self.card = card
        self.tokenizer = tokenizer or load_tokenizer(card.tokenizer)

    # -- tokenization --------------------------------------------------------
    def tokenize_chat(self, request: ChatCompletionRequest) -> List[int]:
        messages = [m.to_obj() for m in request.messages]
        encode_chat = getattr(self.tokenizer, "encode_chat", None)
        if encode_chat is not None:
            return encode_chat(messages)
        prompt = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        return self.tokenizer.encode(prompt)

    def _has_images(self, request: ChatCompletionRequest) -> bool:
        has = any(
            isinstance(m.content, list)
            and any(p.get("type") == "image_url" for p in m.content)
            for m in request.messages
        )
        if has and self.card.image_tokens <= 0:
            # silently dropping the image would produce a confident answer
            # about content the model never saw
            raise InvalidRequestError(
                f"model {self.card.name!r} does not accept image input"
            )
        return has

    def _check_audio(self, request: ChatCompletionRequest) -> None:
        """Audio requests against a non-audio model fail loudly."""
        if self.card.audio:
            return
        wants_audio = "audio" in (request.modalities or [])
        has_audio_part = any(
            isinstance(m.content, list)
            and any(p.get("type") in ("input_audio", "audio") for p in m.content)
            for m in request.messages
        )
        if wants_audio or has_audio_part:
            raise InvalidRequestError(
                f"model {self.card.name!r} does not support audio input/output"
            )

    def tokenize_chat_multimodal(self, request: ChatCompletionRequest):
        """Chat messages with image parts -> (token_ids with placeholder
        runs, decoded images). Multimodal prompts use plain role framing
        (templates are text functions; image spans must stay byte-exact),
        as the reference's. Each image becomes ``card.image_tokens``
        placeholder ids; the engine splices the vision tower's patch
        embeddings over them."""
        from .media import decode_image

        tokens: List[int] = []
        images: List[dict] = []
        for m in request.messages:
            tokens.extend(self.tokenizer.encode(f"<|{m.role}|>\n"))
            parts = m.content if isinstance(m.content, list) else [
                {"type": "text", "text": m.content or ""}
            ]
            for part in parts:
                if part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    arr = decode_image(url, self.card.image_size)
                    images.append({
                        "data": arr.tobytes(),
                        "shape": list(arr.shape),
                    })
                    tokens.extend(
                        [self.card.image_token_id] * self.card.image_tokens
                    )
                    # separator: adjacent image parts must stay distinct
                    # placeholder RUNS (the engine maps one run per image)
                    tokens.extend(self.tokenizer.encode("\n"))
                elif part.get("type") == "text":
                    tokens.extend(self.tokenizer.encode(part.get("text", "")))
            tokens.extend(self.tokenizer.encode("\n"))
        tokens.extend(self.tokenizer.encode("<|assistant|>\n"))
        return tokens, images

    def tokenize_prompt(self, prompt: Union[str, List[int]]) -> List[int]:
        if isinstance(prompt, str):
            return self.tokenizer.encode(prompt)
        return list(prompt)

    @staticmethod
    def _guided_spec(request) -> Optional[Dict[str, Any]]:
        """Guided-decoding spec from the request, in the reference's
        precedence: explicit guided_json, then the tool_choice-derived
        schema, then guided_regex/choice, then chat response_format.
        Tool-derived specs are marked soft=True: an engine without guided
        decoding serves them unconstrained (the tool-call jail still reads
        the call) instead of erroring.

        Explicit specs are syntax-validated here so malformed grammars fail
        as 400s at the frontend; the engine still enforces its own
        automaton caps at compile time."""

        def _checked(spec):
            from ..guided import guided_regex_pattern
            from ..guided.regex import validate_pattern

            try:
                validate_pattern(guided_regex_pattern(spec["kind"], spec["value"]))
            except Exception as e:
                raise GuidedRejectedError(f"invalid guided grammar: {e}") from e
            return spec

        if getattr(request, "guided_json", None) is not None:
            return _checked({"kind": "json", "value": request.guided_json})
        tc = getattr(request, "tool_choice", None)
        if isinstance(tc, dict) and (tc.get("function") or {}).get("name"):
            name = tc["function"]["name"]
            for tool in getattr(request, "tools", None) or []:
                fn = tool.get("function") or {}
                if fn.get("name") == name:
                    params = fn.get("parameters") or {"type": "object"}
                    return {
                        "kind": "json",
                        "value": {
                            "type": "object",
                            "properties": {
                                "name": {"const": name},
                                "arguments": params,
                            },
                            "required": ["name", "arguments"],
                        },
                        "soft": True,
                    }
        if getattr(request, "guided_regex", None) is not None:
            return _checked({"kind": "regex", "value": request.guided_regex})
        if getattr(request, "guided_choice", None) is not None:
            return _checked({"kind": "choice", "value": list(request.guided_choice)})
        rf = getattr(request, "response_format", None) or {}
        if rf.get("type") == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema")
            if schema is not None:
                return _checked({"kind": "json", "value": schema})
        if rf.get("type") == "json_object":
            return {"kind": "json_object", "value": None}  # built-in grammar, always valid
        return None

    # -- request conversion --------------------------------------------------
    def _common(
        self,
        request: Union[ChatCompletionRequest, CompletionRequest],
        token_ids: List[int],
        request_id: str,
    ) -> PreprocessedRequest:
        if len(token_ids) >= self.card.context_length:
            raise ContextLengthError(
                f"prompt length {len(token_ids)} exceeds model context "
                f"{self.card.context_length}"
            )
        sampling = SamplingOptions(
            temperature=request.temperature if request.temperature is not None else 1.0,
            top_p=request.top_p if request.top_p is not None else 1.0,
            top_k=request.top_k if request.top_k is not None else -1,
            min_p=request.min_p or 0.0,
            seed=request.seed,
            frequency_penalty=request.frequency_penalty or 0.0,
            presence_penalty=request.presence_penalty or 0.0,
            repetition_penalty=request.repetition_penalty or 1.0,
            # chat style: logprobs=true (+ top_logprobs=N alternatives);
            # completions style: logprobs=N directly (N=0 still returns the
            # chosen token's logprob with no alternatives)
            logprobs=(
                int(request.logprobs)
                if isinstance(request.logprobs, int) and not isinstance(request.logprobs, bool)
                else int(request.top_logprobs or 0)
            ),
            want_logprobs=request.logprobs is not None and request.logprobs is not False,
            guided=self._guided_spec(request),
        )
        max_new = request.effective_max_tokens()
        budget = self.card.context_length - len(token_ids)
        stop = StopConditions(
            max_tokens=min(max_new, budget) if max_new else budget,
            stop_strings=request.stop_list(),
            ignore_eos=bool(request.ignore_eos),
        )
        annotations = {ANNOTATION_INPUT_TOKENS: len(token_ids)}
        if getattr(request, "lora", None):
            annotations["lora"] = request.lora
        if getattr(request, "logits_processors", None):
            annotations["logits_processors"] = list(request.logits_processors)
        return PreprocessedRequest(
            request_id=request_id,
            model=request.model,
            token_ids=token_ids,
            stop=stop,
            sampling=sampling,
            annotations=annotations,
        )

    def preprocess_chat(self, request: ChatCompletionRequest) -> PreprocessedRequest:
        rid = new_request_id("chatcmpl")
        self._check_audio(request)
        if self._has_images(request):
            tokens, images = self.tokenize_chat_multimodal(request)
            preq = self._common(request, tokens, rid)
            preq.annotations["images"] = images
            return preq
        return self._common(request, self.tokenize_chat(request), rid)

    async def apreprocess_chat(self, request: ChatCompletionRequest) -> PreprocessedRequest:
        """``preprocess_chat`` for a server's event loop: a request with
        images is preprocessed on the image thread, since decoding them is
        CPU work of up to seconds (a 12-megapixel JPEG) that would stall
        every other stream the loop serves; one thread, so that decodes
        queue instead of taking the loop's share of the interpreter."""
        if not self._has_images(request):
            return self.preprocess_chat(request)
        return await asyncio.get_running_loop().run_in_executor(
            _image_executor(), self.preprocess_chat, request)

    def preprocess_completion(
        self, request: CompletionRequest, prompt: Union[str, List[int]]
    ) -> PreprocessedRequest:
        rid = new_request_id("cmpl")
        return self._common(request, self.tokenize_prompt(prompt), rid)
