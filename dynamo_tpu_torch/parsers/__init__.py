"""Streaming reasoning + tool-call parsers.

The port's copy of the reference package's parsers, the counterpart of
Dynamo's dynamo-parsers crate
(lib/parsers/src: reasoning/{base,gpt_oss,granite}, tool_calling/
{json,pythonic,harmony,dsml,xml}) and the chat-completions "jail" that holds
back partial matches (lib/llm/src/protocols/openai/chat_completions/jail.rs).

Everything is incremental: parsers consume text deltas as they stream off the
detokenizer and emit (content, reasoning_content, tool_calls) events, holding
back only the minimal suffix that might still become a marker.
"""

from .jail import HoldBack, split_safe
from .reasoning import ReasoningParser, get_reasoning_parser
from .tool_calls import (
    JsonToolParser,
    PythonicToolParser,
    XmlToolParser,
    get_tool_parser,
)

__all__ = [
    "HoldBack",
    "split_safe",
    "ReasoningParser",
    "get_reasoning_parser",
    "JsonToolParser",
    "PythonicToolParser",
    "XmlToolParser",
    "get_tool_parser",
]
