"""Streaming tool-call parsers.

The port's copy of the reference package's parsers/tool_calls.py, the
counterpart of Dynamo's tool_calling parsers (lib/parsers/src/tool_calling/:
json, pythonic, xml/dsml, harmony). Each parser consumes text deltas, passes
non-tool content through (with minimal hold-back while a marker prefix is
possible), and emits complete OpenAI-shape tool calls:

    {"id": "call_<n>", "type": "function",
     "function": {"name": str, "arguments": json-string}}

Completed calls are emitted as soon as their closing marker parses (streamed
per-call, like the reference jail releasing a held tool call).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import uuid
from typing import Any, Dict, List, Optional

from .jail import split_safe


@dataclasses.dataclass
class ToolEvent:
    content: str = ""
    tool_calls: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


def _mk_call(name: str, arguments: Any) -> Dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


class _TagToolParser:
    """Shared machinery for parsers whose tool calls sit between an open and
    a close tag; subclasses parse the captured body."""

    open_tag = ""
    close_tag = ""

    def __init__(self) -> None:
        self._buf = ""
        self._in_call = False

    def _parse_body(self, body: str) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def feed(self, text: str) -> ToolEvent:
        self._buf += text
        ev = ToolEvent()
        while True:
            if not self._in_call:
                idx = self._buf.find(self.open_tag)
                if idx >= 0:
                    ev.content += self._buf[:idx]
                    self._buf = self._buf[idx + len(self.open_tag):]
                    self._in_call = True
                    continue
                safe, held = split_safe(self._buf, [self.open_tag])
                ev.content += safe
                self._buf = held
                return ev
            idx = self._buf.find(self.close_tag)
            if idx < 0:
                return ev  # wait for the close tag
            body = self._buf[:idx]
            self._buf = self._buf[idx + len(self.close_tag):]
            self._in_call = False
            try:
                ev.tool_calls.extend(self._parse_body(body))
            except Exception:
                # malformed call: surface the raw text instead of dropping it
                ev.content += self.open_tag + body + self.close_tag
            # swallow a single newline separating consecutive tool calls
            if self._buf.startswith("\n"):
                self._buf = self._buf[1:]

    def flush(self) -> ToolEvent:
        held, self._buf = self._buf, ""
        if self._in_call:
            self._in_call = False
            return ToolEvent(content=self.open_tag + held)
        return ToolEvent(content=held)


class JsonToolParser(_TagToolParser):
    """Hermes/Qwen style: <tool_call>{"name": ..., "arguments": {...}}</tool_call>."""

    open_tag = "<tool_call>"
    close_tag = "</tool_call>"

    def _parse_body(self, body: str) -> List[Dict[str, Any]]:
        obj = json.loads(body)
        calls = obj if isinstance(obj, list) else [obj]
        out = []
        for c in calls:
            out.append(
                _mk_call(c["name"], c.get("arguments", c.get("parameters", {})))
            )
        return out


class XmlToolParser(_TagToolParser):
    """<function=name><parameter=key>value</parameter>...</function> style
    (reference: tool_calling/dsml + xml parsers)."""

    open_tag = "<function="
    close_tag = "</function>"
    _param_re = re.compile(
        r"<parameter=([^>]+)>(.*?)</parameter>", re.DOTALL
    )

    def _parse_body(self, body: str) -> List[Dict[str, Any]]:
        name, sep, rest = body.partition(">")
        if not sep:
            raise ValueError("unterminated function tag")
        args = {}
        for key, value in self._param_re.findall(rest):
            value = value.strip()
            try:
                args[key] = json.loads(value)
            except Exception:
                args[key] = value
        return [_mk_call(name.strip(), args)]


class PythonicToolParser:
    """Llama-3.x pythonic style: the whole message is a list of calls, e.g.
    ``[get_weather(city="SF"), search(q="tpu", k=3)]``. Nothing can stream
    until the closing bracket; a message that does not look like a call list
    streams through untouched."""

    _head_re = re.compile(r"^\s*\[\s*[A-Za-z_][\w.]*\s*\(")

    def __init__(self) -> None:
        self._buf = ""
        self._decided: Optional[bool] = None  # None = still sniffing

    def feed(self, text: str) -> ToolEvent:
        self._buf += text
        if self._decided is None:
            if self._head_re.match(self._buf):
                self._decided = True
            elif len(self._buf) > 64 or (
                self._buf.strip() and not "[".startswith(self._buf.strip()[:1])
            ):
                self._decided = False
        if self._decided is False:
            out, self._buf = self._buf, ""
            return ToolEvent(content=out)
        if self._decided is True:
            calls = self._try_parse(self._buf)
            if calls is not None:
                self._buf = ""
                self._decided = None
                return ToolEvent(tool_calls=calls)
        return ToolEvent()

    def _try_parse(self, text: str) -> Optional[List[Dict[str, Any]]]:
        try:
            tree = ast.parse(text.strip(), mode="eval")
        except SyntaxError:
            return None
        if not isinstance(tree.body, ast.List):
            return None
        calls = []
        for node in tree.body.elts:
            if not isinstance(node, ast.Call):
                return None
            if node.args:
                # positional args can't be mapped to names without the tool
                # schema — fall back to raw text rather than dropping them
                return None
            name = ast.unparse(node.func)
            args: Dict[str, Any] = {}
            for kw in node.keywords:
                if kw.arg is None:
                    return None
                try:
                    args[kw.arg] = ast.literal_eval(kw.value)
                except Exception:
                    args[kw.arg] = ast.unparse(kw.value)
            calls.append(_mk_call(name, args))
        return calls

    def flush(self) -> ToolEvent:
        held, self._buf = self._buf, ""
        self._decided = None
        return ToolEvent(content=held)


class HarmonyToolParser:
    """gpt-oss harmony dialect (reference tool_calling/harmony/
    harmony_parser.rs): commentary-channel messages addressed to a
    ``functions.*`` recipient are tool calls —

        <|channel|>commentary to=functions.get_weather <|constrain|>json
        <|message|>{"location": "SF"}<|call|>

    analysis/final channels are the reasoning parser's business (gpt_oss
    entry in parsers/reasoning.py); this parser extracts only the
    tool-call messages and passes everything else through, holding back
    partial headers at chunk boundaries like every streaming parser here.
    """

    HEADER = "<|channel|>commentary to="
    MSG = "<|message|>"
    ENDS = ("<|call|>", "<|end|>", "<|return|>")

    def __init__(self) -> None:
        self._buf = ""

    def _try_parse_call(self) -> Optional[Dict[str, Any]]:
        """Parse one complete call at the head of ``_buf`` (which starts
        right after HEADER); returns the call and consumes it, or None if
        more text is needed (ValueError on malformed header)."""
        midx = self._buf.find(self.MSG)
        if midx < 0:
            return None
        header = self._buf[:midx]
        recipient = header.split()[0] if header.split() else ""
        if not recipient.startswith("functions."):
            # NOT consumed: the caller re-emits the header and the message
            # flows through as ordinary content
            raise ValueError(f"commentary recipient {recipient!r} is not a function")
        end_idx, end_len = -1, 0
        for e in self.ENDS:
            i = self._buf.find(e, midx + len(self.MSG))
            if i >= 0 and (end_idx < 0 or i < end_idx):
                end_idx, end_len = i, len(e)
        if end_idx < 0:
            return None
        args = self._buf[midx + len(self.MSG):end_idx]
        self._buf = self._buf[end_idx + end_len:]
        return _mk_call(recipient[len("functions."):], args.strip())

    def feed(self, text: str) -> ToolEvent:
        self._buf += text
        ev = ToolEvent()
        while True:
            idx = self._buf.find(self.HEADER)
            if idx < 0:
                safe, self._buf = split_safe(self._buf, [self.HEADER])
                ev.content += safe
                return ev
            head, self._buf = self._buf[:idx], self._buf[idx + len(self.HEADER):]
            try:
                call = self._try_parse_call()
            except ValueError:
                # commentary to a non-function recipient: emit it verbatim
                ev.content += head + self.HEADER
                continue
            if call is None:  # incomplete: restore and wait for more text
                self._buf = self.HEADER + self._buf
                ev.content += head
                return ev
            ev.content += head
            ev.tool_calls.append(call)

    def flush(self) -> ToolEvent:
        held, self._buf = self._buf, ""
        # end-of-stream may cut the terminator off a final call: accept a
        # message that parses as JSON even without <|call|>
        if held.startswith(self.HEADER):
            body = held[len(self.HEADER):]
            midx = body.find(self.MSG)
            if midx >= 0:
                recipient = body[:midx].split()[0] if body[:midx].split() else ""
                args = body[midx + len(self.MSG):].strip()
                if recipient.startswith("functions."):
                    try:
                        json.loads(args)
                        return ToolEvent(tool_calls=[
                            _mk_call(recipient[len("functions."):], args)
                        ])
                    except Exception:
                        pass
        return ToolEvent(content=held)


_REGISTRY = {
    "json": JsonToolParser,
    "hermes": JsonToolParser,
    "qwen": JsonToolParser,
    "pythonic": PythonicToolParser,
    "xml": XmlToolParser,
    "dsml": XmlToolParser,
    "harmony": HarmonyToolParser,
    "gpt_oss": HarmonyToolParser,
}


def get_tool_parser(name: Optional[str]):
    if not name or name == "none":
        return None
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown tool parser {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
