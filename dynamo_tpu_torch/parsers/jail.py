"""Marker hold-back ("jail"): never stream text that might still turn out to
be the start of a marker (stop sequence, tool-call tag, reasoning tag).

The port's copy of the reference package's parsers/jail.py, the
counterpart of Dynamo's chat-completions jail
(lib/llm/src/protocols/openai/chat_completions/jail.rs), which buffers SSE
deltas while a partial tool-call or stop-sequence match is possible.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def split_safe(buf: str, markers: Sequence[str]) -> Tuple[str, str]:
    """Split ``buf`` into (safe, held): ``held`` is the longest suffix of
    ``buf`` that is a proper prefix of any marker (and so must be withheld
    until more text arrives)."""
    max_hold = 0
    for m in markers:
        # longest suffix of buf that is a prefix of m
        limit = min(len(buf), len(m) - 1)
        for k in range(limit, max_hold, -1):
            if buf.endswith(m[:k]):
                max_hold = k
                break
    if max_hold == 0:
        return buf, ""
    return buf[:-max_hold], buf[-max_hold:]


class DropMarkers:
    """Incrementally delete exact marker strings from a stream (e.g. gpt-oss
    channel headers that must not reach the client), holding back partial
    matches at chunk boundaries."""

    def __init__(self, markers: Sequence[str]):
        self.markers = sorted((m for m in markers if m), key=len, reverse=True)
        self._buf = ""

    def feed(self, text: str) -> str:
        self._buf += text
        for m in self.markers:
            self._buf = self._buf.replace(m, "")
        safe, self._buf = split_safe(self._buf, self.markers)
        return safe

    def flush(self) -> str:
        held, self._buf = self._buf, ""
        return held


class HoldBack:
    """Incremental wrapper over split_safe: feed deltas, get safe text out;
    flush() releases whatever is still held at end-of-stream."""

    def __init__(self, markers: Sequence[str]):
        self.markers: List[str] = [m for m in markers if m]
        self._held = ""

    def feed(self, text: str) -> str:
        buf = self._held + text
        safe, self._held = split_safe(buf, self.markers)
        return safe

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held
