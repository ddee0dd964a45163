"""Delta generators: BackendOutput stream -> OpenAI SSE response objects.

The port's copy of the reference package's llm/protocols/delta.py: one
chunk (or none) per BackendOutput, never one per token, so an output that
carries a whole decode horizon's tokens streams as one SSE chunk, as the
reference emits it. The reasoning and tool-call parsers, and the forced
``tool_choice`` jail built on them, wait for ROADMAP item 4b (no card of
the port names a parser; the preprocessor refuses a forced tool_choice).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional

from .common import BackendOutput
from .openai import (
    ChatChoice,
    ChatChunkChoice,
    ChatCompletionChunk,
    ChatCompletionResponse,
    ChatDelta,
    ChatResponseMessage,
    CompletionChoice,
    CompletionResponse,
    Usage,
    now_ts,
)


class ChatDeltaGenerator:
    def __init__(
        self,
        request_id: str,
        model: str,
        include_usage: bool = False,
        index: int = 0,
    ):
        self.id = request_id
        self.model = model
        self.index = index
        self.created = now_ts()
        self.include_usage = include_usage
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self.cached_tokens: Optional[int] = None
        self._first = True
        # logprob entries not yet attached to an emitted content chunk
        # (stop-string or split UTF-8 holdback delays the text they belong to)
        self._pending_logprobs: list = []

    def _chunk(
        self,
        delta: ChatDelta,
        finish: Optional[str] = None,
        logprobs: Optional[dict] = None,
    ) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id,
            created=self.created,
            model=self.model,
            choices=[
                ChatChunkChoice(
                    index=self.index, delta=delta, finish_reason=finish,
                    logprobs=logprobs,
                )
            ],
        )

    def on_output(self, out: BackendOutput):
        """Yields zero or more chunks for one backend step."""
        if out.annotations:
            self.prompt_tokens = out.annotations.get("input_tokens", self.prompt_tokens)
            if "cached_tokens" in out.annotations:
                self.cached_tokens = out.annotations["cached_tokens"]
        self.completion_tokens = max(self.completion_tokens, out.cumulative_tokens)
        chunks = []
        if self._first:
            self._first = False
            chunks.append(self._chunk(ChatDelta(role="assistant", content="")))
        finished = out.finish_reason is not None
        step_entries = list(out.logprob_entries or [])
        content = out.text or ""
        if content:
            # entries held back earlier belong to text only now released
            lp = None
            entries = self._pending_logprobs + step_entries
            self._pending_logprobs = []
            if entries:
                lp = {"content": entries}
            chunks.append(self._chunk(ChatDelta(content=content), logprobs=lp))
        else:
            self._pending_logprobs.extend(step_entries)
        if finished:
            lp = None
            if self._pending_logprobs:
                lp = {"content": self._pending_logprobs}
                self._pending_logprobs = []
            chunks.append(self._chunk(ChatDelta(), finish=out.finish_reason, logprobs=lp))
            if self.include_usage:
                usage_chunk = ChatCompletionChunk(
                    id=self.id, created=self.created, model=self.model, choices=[],
                    usage=self.usage(),
                )
                chunks.append(usage_chunk)
        return chunks

    def usage(self) -> Usage:
        return Usage(
            prompt_tokens=self.prompt_tokens,
            completion_tokens=self.completion_tokens,
            total_tokens=self.prompt_tokens + self.completion_tokens,
            cached_tokens=self.cached_tokens,
        )


async def aggregate_chat(
    request_id: str,
    model: str,
    stream: AsyncIterator[BackendOutput],
    index: int = 0,
) -> ChatCompletionResponse:
    """Non-streaming mode: fold the whole stream into one response."""
    gen = ChatDeltaGenerator(request_id, model, index=index)
    text_parts = []
    logprob_entries = []
    finish = None
    async for out in stream:
        for chunk in gen.on_output(out):
            for choice in chunk.choices:
                if choice.delta.content:
                    text_parts.append(choice.delta.content)
                if choice.logprobs and choice.logprobs.get("content"):
                    logprob_entries.extend(choice.logprobs["content"])
                if choice.finish_reason is not None:
                    finish = choice.finish_reason
    return ChatCompletionResponse(
        id=request_id,
        created=gen.created,
        model=model,
        choices=[
            ChatChoice(
                index=index,
                message=ChatResponseMessage(content="".join(text_parts)),
                finish_reason=finish or "stop",
                logprobs={"content": logprob_entries} if logprob_entries else None,
            )
        ],
        usage=gen.usage(),
    )


class CompletionDeltaGenerator:
    """Streaming text-completions: each step is a partial CompletionResponse."""

    def __init__(
        self,
        request_id: str,
        model: str,
        include_usage: bool = False,
        text_offset: int = 0,
        index: int = 0,
    ):
        self.id = request_id
        self.model = model
        self.index = index
        self.created = now_ts()
        self.include_usage = include_usage
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self.cached_tokens: Optional[int] = None
        self._text_offset = text_offset  # chars of response text emitted so far
        # entries from steps whose text was held back (stop-string jail /
        # split UTF-8); they ride on the next emitted chunk
        self._pending_entries: list = []

    def _completion_logprobs(self, entries: list, chunk_text: str) -> Optional[dict]:
        """Legacy completions logprobs block: parallel arrays keyed by token
        string. Offsets are anchored to the *actual* emitted text (cumulative
        token-string lengths, clamped to the chunk) so jail-trimmed or
        re-detokenized text never pushes offsets past the response."""
        if not entries:
            return None
        lp = {"tokens": [], "token_logprobs": [], "top_logprobs": [], "text_offset": []}
        base = self._text_offset
        cum = 0
        for e in entries:
            lp["tokens"].append(e["token"])
            lp["token_logprobs"].append(e["logprob"])
            lp["top_logprobs"].append(
                {alt["token"]: alt["logprob"] for alt in e.get("top_logprobs", [])}
            )
            lp["text_offset"].append(base + min(cum, len(chunk_text)))
            cum += len(e["token"])
        return lp

    def on_output(self, out: BackendOutput):
        if out.annotations:
            self.prompt_tokens = out.annotations.get("input_tokens", self.prompt_tokens)
            if "cached_tokens" in out.annotations:
                self.cached_tokens = out.annotations["cached_tokens"]
        self.completion_tokens = max(self.completion_tokens, out.cumulative_tokens)
        chunks = []
        if out.logprob_entries:
            self._pending_entries.extend(out.logprob_entries)
        if out.text or out.finish_reason is not None:
            text = out.text or ""
            entries, self._pending_entries = self._pending_entries, []
            resp = CompletionResponse(
                id=self.id, created=self.created, model=self.model,
                choices=[CompletionChoice(
                    index=self.index, text=text, finish_reason=out.finish_reason,
                    logprobs=self._completion_logprobs(entries, text),
                )],
            )
            self._text_offset += len(text)
            chunks.append(resp)
        if out.finish_reason is not None and self.include_usage:
            chunks.append(
                CompletionResponse(
                    id=self.id, created=self.created, model=self.model, choices=[],
                    usage=self.usage(),
                )
            )
        return chunks

    def usage(self) -> Usage:
        return Usage(
            prompt_tokens=self.prompt_tokens,
            completion_tokens=self.completion_tokens,
            total_tokens=self.prompt_tokens + self.completion_tokens,
            cached_tokens=self.cached_tokens,
        )


async def aggregate_completion(
    request_id: str, model: str, stream: AsyncIterator[BackendOutput],
    echo_text: str = "", index: int = 0,
) -> CompletionResponse:
    gen = CompletionDeltaGenerator(
        request_id, model, text_offset=len(echo_text), index=index
    )
    parts = [echo_text] if echo_text else []
    finish = None
    logprobs: Optional[dict] = None
    async for out in stream:
        for chunk in gen.on_output(out):
            for choice in chunk.choices:
                if choice.logprobs:
                    if logprobs is None:
                        logprobs = {k: [] for k in choice.logprobs}
                    for k, v in choice.logprobs.items():
                        logprobs[k].extend(v)
        if out.text:
            parts.append(out.text)
        if out.finish_reason is not None:
            finish = out.finish_reason
    return CompletionResponse(
        id=request_id,
        created=gen.created,
        model=model,
        choices=[CompletionChoice(
            index=index, text="".join(parts), finish_reason=finish or "stop",
            logprobs=logprobs,
        )],
        usage=gen.usage(),
    )


# -- multi-choice (n > 1) ----------------------------------------------------
# Each choice is an independent engine stream with its own delta state,
# re-indexed into one response: callers fan one request into n streams and
# these helpers fold them back together.


def merge_usage(gens) -> Usage:
    """One Usage covering all choices: the prompt is billed once, completion
    tokens sum across choices (OpenAI semantics for n>1)."""
    prompt = max((g.prompt_tokens for g in gens), default=0)
    cached = next((g.cached_tokens for g in gens if g.cached_tokens is not None), None)
    completion = sum(g.completion_tokens for g in gens)
    return Usage(
        prompt_tokens=prompt,
        completion_tokens=completion,
        total_tokens=prompt + completion,
        cached_tokens=cached,
    )


async def aggregate_chat_multi(
    request_id: str,
    model: str,
    streams,
) -> ChatCompletionResponse:
    """Aggregate n independent streams into one multi-choice response."""
    results = await asyncio.gather(*[
        aggregate_chat(request_id, model, s, index=i)
        for i, s in enumerate(streams)
    ])
    base = results[0]
    prompt = max(r.usage.prompt_tokens for r in results if r.usage)
    completion = sum(r.usage.completion_tokens for r in results if r.usage)
    cached = next(
        (r.usage.cached_tokens for r in results
         if r.usage and r.usage.cached_tokens is not None),
        None,
    )
    return ChatCompletionResponse(
        id=request_id,
        created=base.created,
        model=model,
        choices=[r.choices[0] for r in results],
        usage=Usage(
            prompt_tokens=prompt, completion_tokens=completion,
            total_tokens=prompt + completion, cached_tokens=cached,
        ),
    )


async def aggregate_completion_multi(
    request_id: str, model: str, streams, echo_text: str = ""
) -> CompletionResponse:
    results = await asyncio.gather(*[
        aggregate_completion(request_id, model, s, echo_text, index=i)
        for i, s in enumerate(streams)
    ])
    base = results[0]
    prompt = max(r.usage.prompt_tokens for r in results if r.usage)
    completion = sum(r.usage.completion_tokens for r in results if r.usage)
    cached = next(
        (r.usage.cached_tokens for r in results
         if r.usage and r.usage.cached_tokens is not None),
        None,
    )
    return CompletionResponse(
        id=request_id,
        created=base.created,
        model=model,
        choices=[r.choices[0] for r in results],
        usage=Usage(
            prompt_tokens=prompt, completion_tokens=completion,
            total_tokens=prompt + completion, cached_tokens=cached,
        ),
    )
