"""Guided-decoding grammars -> regex patterns.

JSON Schema is compiled to a regex (outlines-style: bounded constructs so
the result stays regular), then to a DFA by guided/regex.py. The
reference derives the same thing for guided_json and for forced
tool_choice (lib/llm/src/protocols/openai/common_ext.rs:180 "Tool-call
guided decoding ... derive guided_json from tool_choice").

Supported schema subset: type string (enum/const, minLength/maxLength),
integer, number, boolean, null, object (properties in declaration order;
non-required properties are emitted optionally), array (items,
minItems/maxItems, default 0..8), anyOf/oneOf, $ref -> $defs/definitions
(bounded expansion depth). Unknown/absent type falls back to a bounded
generic JSON value.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .regex import escape_literal

WS = r"[ \n\t]{0,8}"  # bounded optional whitespace keeps the DFA small

STRING_RE = r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"'
INTEGER_RE = r"-?(0|[1-9][0-9]*)"
NUMBER_RE = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"
BOOLEAN_RE = r"(true|false)"
NULL_RE = r"null"

DEFAULT_MAX_ITEMS = 8
DEFAULT_DEPTH = 3


def json_value_regex(depth: int = DEFAULT_DEPTH) -> str:
    """A generic JSON value with bounded NESTING — the grammar behind
    response_format {"type": "json_object"}. Repetition (array items,
    object members) is a `*` loop, not a bounded count: star re-enters the
    same sub-automaton, so the DFA stays small, while bounded depth is
    what keeps nested JSON regular at all."""
    scalar = f"({STRING_RE}|{NUMBER_RE}|{BOOLEAN_RE}|{NULL_RE})"
    value = scalar
    for _ in range(depth):
        arr = rf"\[{WS}({value}({WS},{WS}{value})*)?{WS}\]"
        obj = (
            rf"\{{{WS}({STRING_RE}{WS}:{WS}{value}"
            rf"({WS},{WS}{STRING_RE}{WS}:{WS}{value})*)?{WS}\}}"
        )
        value = f"({scalar}|{arr}|{obj})"
    return value


class SchemaError(ValueError):
    pass


def _string_regex(schema: Dict[str, Any]) -> str:
    if "pattern" in schema:
        # inner pattern constrains the CONTENT between the quotes; it must
        # itself avoid unescaped quotes to stay valid JSON. Parenthesized so
        # a top-level alternation cannot escape the quoting
        return f'"({schema["pattern"]})"'
    lo = schema.get("minLength")
    hi = schema.get("maxLength")
    if lo is not None or hi is not None:
        lo = int(lo or 0)
        ch = r'([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
        if hi is None:
            return f'"{ch}{{{lo},}}"'
        return f'"{ch}{{{lo},{int(hi)}}}"'
    return STRING_RE


def schema_to_regex(schema: Dict[str, Any], depth: int = 6) -> str:
    """Compile a JSON Schema (subset) to an anchored regex."""
    return _compile(schema, schema, depth)


def _compile(schema: Any, root: Any, depth: int) -> str:
    if depth < 0:
        raise SchemaError("schema nesting/$ref expansion too deep")
    if schema is True or schema == {}:
        return json_value_regex(2)
    if not isinstance(schema, dict):
        raise SchemaError(f"unsupported schema node: {schema!r}")

    if "$ref" in schema:
        ref = schema["$ref"]
        for prefix in ("#/$defs/", "#/definitions/"):
            if ref.startswith(prefix):
                name = ref[len(prefix):]
                defs = root.get(prefix.split("/")[1], {})
                if name not in defs:
                    raise SchemaError(f"unresolved $ref {ref}")
                return _compile(defs[name], root, depth - 1)
        raise SchemaError(f"unsupported $ref {ref} (only #/$defs, #/definitions)")

    if "const" in schema:
        return escape_literal(json.dumps(schema["const"]))
    if "enum" in schema:
        opts = "|".join(escape_literal(json.dumps(v)) for v in schema["enum"])
        return f"({opts})"
    if "anyOf" in schema or "oneOf" in schema:
        subs = schema.get("anyOf") or schema.get("oneOf")
        return "(" + "|".join(_compile(s, root, depth - 1) for s in subs) + ")"

    t = schema.get("type")
    if isinstance(t, list):
        return "(" + "|".join(
            _compile({**schema, "type": tt}, root, depth - 1) for tt in t
        ) + ")"
    if t == "string":
        return _string_regex(schema)
    if t == "integer":
        return INTEGER_RE
    if t == "number":
        return NUMBER_RE
    if t == "boolean":
        return BOOLEAN_RE
    if t == "null":
        return NULL_RE
    if t == "array":
        item = _compile(schema.get("items", {}), root, depth - 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is None:
            # unbounded: star keeps the automaton size linear in the item
            body = f"{item}({WS},{WS}{item})*"
            if lo > 1:
                body = f"{item}({WS},{WS}{item}){{{lo - 1},}}"
        else:
            hi = int(hi)
            if hi < lo:
                raise SchemaError("maxItems < minItems")
            if hi == 0:
                return rf"\[{WS}\]"
            body = f"{item}({WS},{WS}{item}){{{max(lo - 1, 0)},{hi - 1}}}"
        if lo == 0:
            return rf"\[{WS}({body})?{WS}\]"
        return rf"\[{WS}{body}{WS}\]"
    if t == "object":
        props: Dict[str, Any] = schema.get("properties", {})
        if not props:
            return json_value_regex(2)
        required = set(schema.get("required", list(props)))
        parts: List[tuple] = []
        for name, sub in props.items():
            val = _compile(sub, root, depth - 1)
            pair = f'{escape_literal(json.dumps(name))}{WS}:{WS}{val}'
            parts.append((pair, name in required))
        # Emission order = declaration order. Required props are joined by
        # commas; each optional prop rides with the comma that its position
        # needs. To keep the regex REGULAR and simple we emit optionals as
        # (pair ,)? BEFORE the next required, and (, pair)? after the last
        # required — standard outlines-style approximation.
        req = [p for p, r in parts if r]
        opt = [p for p, r in parts if not r]
        if req:
            body = f"{WS},{WS}".join(req)
            for p in opt:
                body = body + f"({WS},{WS}{p})?"
        else:
            # all optional: any non-empty subset in declaration order, comma-
            # separated. One alternative per possible FIRST property (which
            # carries no leading comma), each followed by the later ones as
            # optional comma-led tails — O(n^2) pattern, not 2^n.
            alts = [
                opt[i] + "".join(f"({WS},{WS}{p})?" for p in opt[i + 1:])
                for i in range(len(opt))
            ]
            body = "(" + "|".join(alts) + ")?" if alts else ""
        return rf"\{{{WS}{body}{WS}\}}"
    # no/unknown type
    return json_value_regex(2)


def choice_regex(choices: List[str]) -> str:
    """guided_choice: exactly one of the given strings."""
    if not choices:
        raise SchemaError("guided_choice requires a non-empty list")
    return "(" + "|".join(escape_literal(c) for c in choices) + ")"


def guided_regex_pattern(kind: str, value: Any) -> str:
    """Normalize a guided spec {kind, value} to one anchored pattern.

    kinds: regex (value = pattern), choice (list of strings), json
    (schema dict or JSON string), json_object (None)."""
    if kind == "regex":
        if not isinstance(value, str):
            raise SchemaError("guided_regex takes a pattern string")
        return value
    if kind == "choice":
        return choice_regex(list(value))
    if kind == "json":
        schema = json.loads(value) if isinstance(value, str) else value
        if not isinstance(schema, (dict, bool)):
            raise SchemaError("guided_json takes a schema object")
        return schema_to_regex(schema)
    if kind == "json_object":
        return json_value_regex()
    raise SchemaError(f"unknown guided kind {kind!r}")
