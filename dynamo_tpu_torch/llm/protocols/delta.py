"""Delta generators: BackendOutput stream -> OpenAI SSE response objects.

The port's copy of the reference package's llm/protocols/delta.py: one
chunk (or none) per BackendOutput, never one per token, so an output that
carries a whole decode horizon's tokens streams as one SSE chunk, as the
reference emits it. Raw text goes through the card's reasoning parser,
then its tool-call parser (parsers/); a forced ``tool_choice`` is the
jail's Immediate mode: every token is held from the first and the call is
parsed at finish. Logprob entries are held back with the text they belong
to, and each choice of an ``n`` > 1 request has its own parser state.

One difference from the reference, on purpose (ROADMAP Queue 3): a named
``tool_choice`` whose output is the preprocessor's soft grammar,
``{"name": <the function>, "arguments": {...}}``, gives a call whose
arguments are that object's ``arguments``; the reference passes the whole
envelope on as the arguments. A bare argument object is read as the
reference reads it.
"""

from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, Optional

from ...parsers.tool_calls import _mk_call
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
        reasoning_parser=None,
        tool_parser=None,
        tool_choice=None,
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
        self.reasoning_parser = reasoning_parser
        self.tool_parser = tool_parser
        self._tool_call_count = 0
        # forced tool_choice = the reference jail's Immediate mode
        # (jail.rs JailMode::Immediate): the WHOLE output is a tool call, so
        # every token is jailed from the first and parsed at finish —
        # "required" expects a JSON array of calls, a named choice expects
        # that function's bare argument object
        self._forced: Optional[tuple] = None
        self._forced_buf = ""
        if tool_choice == "required":
            self._forced = ("required", None)
        elif tool_choice == "none":
            # explicit opt-out beats the model card: no tool parsing at all
            self.tool_parser = None
        elif isinstance(tool_choice, dict):
            name = (tool_choice.get("function") or {}).get("name")
            if name:
                self._forced = ("named", name)
        # logprob entries not yet attached to an emitted content chunk (jail
        # holdback / parser diversion can delay the text they belong to)
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

    def _split_reasoning(self, text: str, flush: bool):
        """(content, reasoning) via the model card's reasoning parser."""
        if self.reasoning_parser is None:
            return text, ""
        ev = self.reasoning_parser.feed(text)
        if flush:
            fin = self.reasoning_parser.flush()
            ev.content += fin.content
            ev.reasoning += fin.reasoning
        return ev.content, ev.reasoning

    def _parse(self, text: str, flush: bool = False):
        """Pipe raw text through the reasoning then tool parsers; returns
        (content, reasoning, tool_calls). Tool markers never appear inside
        reasoning spans, so reasoning splits first."""
        text, reasoning = self._split_reasoning(text, flush)
        tool_calls = []
        if self.tool_parser is not None:
            tev = self.tool_parser.feed(text)
            if flush:
                fin = self.tool_parser.flush()
                tev.content += fin.content
                tev.tool_calls.extend(fin.tool_calls)
            text, tool_calls = tev.content, tev.tool_calls
        for tc in tool_calls:
            tc["index"] = self._tool_call_count
            self._tool_call_count += 1
        return text, reasoning, tool_calls

    def _parse_forced(self):
        """End-of-stream parse of the jailed buffer (reference
        ToolChoiceFormat::{ArrayOfTools, SingleObject}). Malformed output
        degrades to plain content rather than a dropped response."""
        mode, name = self._forced
        text = self._forced_buf.strip()
        self._forced_buf = ""
        try:
            obj = json.loads(text)
        except Exception:
            return [], text
        if mode == "named":
            # the soft grammar's envelope carries the arguments under its
            # own key (module docstring)
            if (isinstance(obj, dict) and set(obj) == {"name", "arguments"}
                    and obj["name"] == name):
                obj = obj["arguments"]
            return [_mk_call(name, obj)], ""
        calls = obj if isinstance(obj, list) else [obj]
        try:
            return [
                _mk_call(
                    c["name"], c.get("arguments", c.get("parameters", {}))
                )
                for c in calls
            ], ""
        except (KeyError, TypeError):
            return [], text

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
        if self._forced is not None:
            # immediate jail: reasoning still streams (it is never part of
            # the call JSON — reasoning models wrap the payload in think/
            # channel markup that would break the end-of-stream parse), the
            # rest accumulates silently for the finish-time parse. logprob
            # entries ride along so the malformed-output content fallback
            # still carries every token's logprob
            text, reasoning = self._split_reasoning(out.text or "", finished)
            self._forced_buf += text
            self._pending_logprobs.extend(step_entries)
            step_entries = []
            if reasoning:
                chunks.append(self._chunk(ChatDelta(reasoning_content=reasoning)))
            if not finished:
                return chunks
            tool_calls, content = self._parse_forced()
            for tc in tool_calls:
                tc["index"] = self._tool_call_count
                self._tool_call_count += 1
            if tool_calls:
                # OpenAI logprobs.content covers content tokens only
                self._pending_logprobs = []
            reasoning = ""
        else:
            content, reasoning, tool_calls = self._parse(
                out.text or "", flush=finished
            )
        if reasoning:
            chunks.append(self._chunk(ChatDelta(reasoning_content=reasoning)))
        if content:
            # entries held back earlier (jail/UTF-8 holdback) belong to text
            # that is only now being released as content
            lp = None
            entries = self._pending_logprobs + step_entries
            self._pending_logprobs = []
            if entries:
                lp = {"content": entries}
            chunks.append(self._chunk(ChatDelta(content=content), logprobs=lp))
        elif not (reasoning or tool_calls):
            self._pending_logprobs.extend(step_entries)
        # else: this step's tokens were diverted into reasoning/tool-call
        # fields; OpenAI logprobs.content must only cover content tokens, so
        # their entries are dropped (the engine emits one token per step, so
        # step granularity == token granularity)
        if tool_calls:
            chunks.append(self._chunk(ChatDelta(tool_calls=tool_calls)))
        if finished:
            finish = out.finish_reason
            if self._tool_call_count and finish == "stop":
                finish = "tool_calls"
            lp = None
            if self._pending_logprobs:
                lp = {"content": self._pending_logprobs}
                self._pending_logprobs = []
            chunks.append(self._chunk(ChatDelta(), finish=finish, logprobs=lp))
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
    reasoning_parser=None,
    tool_parser=None,
    tool_choice=None,
    index: int = 0,
) -> ChatCompletionResponse:
    """Non-streaming mode: fold the whole stream into one response."""
    gen = ChatDeltaGenerator(
        request_id, model,
        reasoning_parser=reasoning_parser, tool_parser=tool_parser,
        tool_choice=tool_choice, index=index,
    )
    text_parts = []
    reasoning_parts = []
    tool_calls = []
    logprob_entries = []
    finish = None
    async for out in stream:
        for chunk in gen.on_output(out):
            for choice in chunk.choices:
                if choice.delta.content:
                    text_parts.append(choice.delta.content)
                if choice.delta.reasoning_content:
                    reasoning_parts.append(choice.delta.reasoning_content)
                if choice.delta.tool_calls:
                    tool_calls.extend(choice.delta.tool_calls)
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
                message=ChatResponseMessage(
                    content="".join(text_parts),
                    reasoning_content="".join(reasoning_parts) or None,
                    tool_calls=[
                        {k: v for k, v in tc.items() if k != "index"}
                        for tc in tool_calls
                    ] or None,
                ),
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
# Each choice is an independent engine stream with its own delta and parser
# state, re-indexed into one response: callers fan one request into n
# streams and these helpers fold them back together.


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
    reasoning_parser_factory=None,
    tool_parser_factory=None,
    tool_choice=None,
) -> ChatCompletionResponse:
    """Aggregate n independent streams into one multi-choice response.

    Parser *factories* (not instances): streaming parsers are stateful, so
    every choice needs its own."""
    results = await asyncio.gather(*[
        aggregate_chat(
            request_id, model, s,
            reasoning_parser=reasoning_parser_factory() if reasoning_parser_factory else None,
            tool_parser=tool_parser_factory() if tool_parser_factory else None,
            tool_choice=tool_choice,
            index=i,
        )
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
