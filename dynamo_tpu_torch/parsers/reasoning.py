"""Streaming reasoning parsers: split model output into reasoning_content vs
content, incrementally.

The port's copy of the reference package's parsers/reasoning.py, the
counterpart of Dynamo's reasoning parsers (lib/parsers/src/reasoning/:
base_parser for <think>-style tags, gpt_oss channel parser, granite
response-tag parser). Tag-based models are covered by ``ReasoningParser``
with per-model tag config; ``force_reasoning`` handles models (deepseek-r1
style) that open in reasoning mode without emitting the open tag.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .jail import DropMarkers, split_safe


@dataclasses.dataclass
class ReasoningEvent:
    content: str = ""
    reasoning: str = ""


class ReasoningParser:
    """Incremental <open>...</close> splitter with partial-tag hold-back."""

    def __init__(
        self,
        open_tag: str = "<think>",
        close_tag: str = "</think>",
        force_reasoning: bool = False,
        content_filters: Tuple[str, ...] = (),
    ):
        self.open_tag = open_tag
        self.close_tag = close_tag
        self._state = "reasoning" if force_reasoning else "content"
        self._buf = ""
        self._dropper = DropMarkers(content_filters) if content_filters else None

    def feed(self, text: str) -> ReasoningEvent:
        ev = self._feed(text)
        if self._dropper is not None:
            ev.content = self._dropper.feed(ev.content)
        return ev

    def _feed(self, text: str) -> ReasoningEvent:
        self._buf += text
        ev = ReasoningEvent()
        while True:
            if self._state == "content":
                idx = self._buf.find(self.open_tag)
                if idx >= 0:
                    ev.content += self._buf[:idx]
                    self._buf = self._buf[idx + len(self.open_tag):]
                    self._state = "reasoning"
                    continue
                safe, held = split_safe(self._buf, [self.open_tag])
                ev.content += safe
                self._buf = held
                return ev
            else:
                idx = self._buf.find(self.close_tag)
                if idx >= 0:
                    ev.reasoning += self._buf[:idx]
                    self._buf = self._buf[idx + len(self.close_tag):]
                    # models usually emit "\n\n" right after </think>
                    self._state = "content"
                    continue
                safe, held = split_safe(self._buf, [self.close_tag])
                ev.reasoning += safe
                self._buf = held
                return ev

    def flush(self) -> ReasoningEvent:
        held, self._buf = self._buf, ""
        if self._state != "content":
            return ReasoningEvent(reasoning=held)
        if self._dropper is not None:
            held = self._dropper.feed(held) + self._dropper.flush()
        return ReasoningEvent(content=held)


_REGISTRY = {
    # name -> constructor kwargs (reference: parser selection by model family)
    "deepseek_r1": dict(open_tag="<think>", close_tag="</think>", force_reasoning=True),
    "qwen3": dict(open_tag="<think>", close_tag="</think>"),
    "think": dict(open_tag="<think>", close_tag="</think>"),
    "granite": dict(
        open_tag="Here is my thought process:", close_tag="Here is my response:"
    ),
    "gpt_oss": dict(
        open_tag="<|channel|>analysis<|message|>", close_tag="<|end|>",
        # final-channel headers/terminators are plumbing, not content
        content_filters=(
            "<|start|>assistant<|channel|>final<|message|>",
            "<|channel|>final<|message|>",
            "<|start|>assistant",
            "<|return|>",
            "<|end|>",
        ),
    ),
}


def get_reasoning_parser(name: Optional[str]) -> Optional[ReasoningParser]:
    if not name or name == "none":
        return None
    try:
        return ReasoningParser(**_REGISTRY[name])
    except KeyError:
        raise ValueError(
            f"unknown reasoning parser {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
