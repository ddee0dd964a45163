"""The port's reasoning and tool-call parsers (dynamo_tpu_torch/parsers) and
the parser path of its chat delta generator, against the reference
package's, on the CPU.

- Parity: one case for each of the 30 tests of the reference's
  ``tests/test_parsers.py``. The case's text is cut at seeded random points
  (numpy, one seed per case and cut) and the same deltas go through
  ``dynamo_tpu.parsers`` and ``dynamo_tpu_torch.parsers`` (or both
  packages' ``ChatDeltaGenerator`` with their parsers and ``tool_choice``):
  the event sequences must be equal, tool-call ids aside (random in both;
  each must look like ``call_`` and 24 hex digits).
- The port's one difference, on purpose: a named ``tool_choice`` whose
  output is the soft grammar's ``{"name", "arguments"}`` envelope gives
  the envelope's ``arguments`` as the call's arguments (the reference
  passes the envelope on whole).
- ``n`` > 1: each choice's parsers are its own.
"""

import json
import re

import numpy as np
import pytest

from dynamo_tpu import parsers as J
from dynamo_tpu.llm.http import service as jservice
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.llm.protocols import delta as jdelta
from dynamo_tpu_torch import parsers as T
from dynamo_tpu_torch.llm.http import service as tservice
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.llm.protocols import delta as tdelta

CALL_ID = re.compile(r"^call_[0-9a-f]{24}$")
CUTS = 4   # seeded cuttings of each case's text


def cut(text, seed):
    """``text`` cut at 0-7 seeded random points."""
    rng = np.random.default_rng(seed)
    n = len(text)
    if n < 2:
        return [text]
    pts = sorted(set(rng.integers(1, n, size=int(rng.integers(0, 8))).tolist()))
    return [text[a:b] for a, b in zip([0] + pts, pts + [n])]


def norm_calls(calls):
    out = []
    for c in calls:
        assert CALL_ID.match(c["id"]), c
        out.append({k: v for k, v in c.items() if k != "id"})
    return out


def norm(obj):
    """A chunk or event as plain data: per-response ids, timestamps and
    call ids dropped (each call id checked for its form)."""
    if isinstance(obj, dict):
        if "function" in obj and "id" in obj:
            assert CALL_ID.match(obj["id"]), obj
        return {k: norm(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


def dump(chunk):
    return chunk.model_dump(exclude_none=True) if hasattr(chunk, "model_dump") else \
        chunk.to_obj()


# ------------------------------------------------------------------ runners
def run_holdback(pkg, markers, pieces):
    hb = pkg.HoldBack(markers)
    return [hb.feed(p) for p in pieces] + [hb.flush()]


def run_reasoning(pkg, make, pieces):
    p = make(pkg)
    evs = [p.feed(x) for x in pieces] + [p.flush()]
    return [(e.content, e.reasoning) for e in evs]


def run_tools(pkg, make, pieces):
    p = make(pkg)
    evs = [p.feed(x) for x in pieces] + [p.flush()]
    return [(e.content, norm_calls(e.tool_calls)) for e in evs]


def run_delta(pkg, kw, pieces, finish="stop"):
    delta, common = (jdelta, jcommon) if pkg is J else (tdelta, tcommon)
    gen = delta.ChatDeltaGenerator(
        "r", "m",
        reasoning_parser=pkg.get_reasoning_parser(kw.get("reasoning")),
        tool_parser=pkg.get_tool_parser(kw.get("tool")),
        tool_choice=kw.get("tool_choice"))
    chunks = []
    for i, p in enumerate(pieces):
        last = i == len(pieces) - 1 and kw.get("finish_with_text")
        chunks += gen.on_output(common.BackendOutput(
            text=p, token_ids=[1], cumulative_tokens=i + 1,
            finish_reason=finish if last else None))
    if not kw.get("finish_with_text"):
        chunks += gen.on_output(common.BackendOutput(finish_reason=finish,
                                                     cumulative_tokens=len(pieces)))
    return [norm(dump(c)) for c in chunks]


def registry_outcomes(pkg, kind, names):
    get = pkg.get_reasoning_parser if kind == "reasoning" else pkg.get_tool_parser
    out = []
    for n in names:
        try:
            p = get(n)
        except ValueError as e:
            out.append(("ValueError", str(e)))
            continue
        if p is None or kind == "tools":
            out.append(p if p is None else type(p).__name__)
        else:
            out.append((p.open_tag, p.close_tag, p._state, p._dropper is not None))
    return out


def safe_parser_outcomes(pkg, names):
    svc = jservice if pkg is J else tservice
    out = []
    for n in names:
        p = svc._safe_parser(pkg.get_reasoning_parser, n)
        out.append(None if p is None else type(p).__name__)
    return out


def think(pkg):
    return pkg.ReasoningParser()


def forced_think(pkg):
    return pkg.ReasoningParser(force_reasoning=True)


def tool(name):
    return lambda pkg: pkg.get_tool_parser(name)


def reasoning(name):
    return lambda pkg: pkg.get_reasoning_parser(name)


ANALYSIS = ("<|channel|>analysis<|message|>plan here<|end|>"
            "<|start|>assistant<|channel|>final<|message|>Hello!<|return|>")
OSS_TOOLS = ("<|channel|>analysis<|message|>think hard<|end|>"
             '<|channel|>commentary to=functions.calc <|message|>{"x": 2}<|call|>'
             "<|channel|>final<|message|>done<|return|>")
NAMED = {"type": "function", "function": {"name": "lookup"}}

# one case per test of the reference's tests/test_parsers.py:
# (reference test, kind, argument, text)
CASES = [
    ("TestHoldBack::test_split_safe", "split_safe",
     [("hello <th", ["<think>"]), ("hello", ["<think>"]), ("<", ["<think>"]),
      ("a <tool_c", ["<tool_call>", "<think>"]), ("x</thi", ["</think>"])], None),
    ("TestHoldBack::test_feed_flush", "holdback", ["STOP"], "abc STx STO"),
    ("TestHoldBack::test_marker_never_leaks_early", "holdback", ["<|eot|>"],
     "hi <|eo and more <|eot"),
    ("TestReasoning::test_think_tags", "reasoning", think,
     "<think>step by step</think>The answer is 4."),
    ("TestReasoning::test_forced_reasoning_no_open_tag", "reasoning", forced_think,
     "thinking hard</think>done"),
    ("TestReasoning::test_unclosed_reasoning_flushes_as_reasoning", "reasoning",
     forced_think, "still thinking when stream ends"),
    ("TestReasoning::test_no_tags_passthrough", "reasoning", think, "plain response"),
    ("TestReasoning::test_registry", "registry", "reasoning",
     [None, "none", "deepseek_r1", "qwen3", "think", "granite", "nope"]),
    ("TestJsonTools::test_single_call", "tools", tool("hermes"),
     'Sure. <tool_call>{"name": "get_weather", "arguments": {"city": "SF"}}</tool_call>'),
    ("TestJsonTools::test_multiple_calls", "tools", tool("json"),
     '<tool_call>{"name": "a", "arguments": {}}</tool_call>\n'
     '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>'),
    ("TestJsonTools::test_malformed_json_surfaces_raw", "tools", tool("qwen"),
     "<tool_call>{broken</tool_call>after"),
    ("TestJsonTools::test_unclosed_call_flushes_raw", "tools", tool("hermes"),
     '<tool_call>{"name": "a"'),
    ("TestPythonicTools::test_call_list", "tools", tool("pythonic"),
     '[get_weather(city="SF"), search(q="tpu", k=3)]'),
    ("TestPythonicTools::test_plain_text_streams_through", "tools", tool("pythonic"),
     "The weather in SF is sunny today, around 18C."),
    ("TestPythonicTools::test_bracket_but_not_calls", "tools", tool("pythonic"),
     "[1, 2, 3] is a list"),
    ("TestXmlTools::test_function_params", "tools", tool("xml"),
     "<function=lookup><parameter=key>alpha</parameter>"
     "<parameter=n>5</parameter></function>"),
    ("TestXmlTools::test_registry", "registry", "tools",
     [None, "none", "hermes", "json", "qwen", "pythonic", "xml", "dsml", "harmony",
      "gpt_oss", "nope"]),
    ("TestDeltaIntegration::test_chat_delta_reasoning_and_tools", "delta",
     {"reasoning": "think", "tool": "hermes"},
     '<think>plan</think>ok <tool_call>{"name": "f", "arguments": {}}</tool_call>'),
    ("TestReviewFixes::test_pythonic_positional_args_fall_back_to_raw", "tools",
     tool("pythonic"), '[get_weather("SF")]'),
    ("TestReviewFixes::test_gpt_oss_final_channel_markers_stripped", "reasoning",
     reasoning("gpt_oss"), ANALYSIS),
    ("TestReviewFixes::test_bad_parser_name_degrades_to_passthrough", "safe_parser",
     [None, "definitely-not-a-parser", "qwen3", "none"], None),
    ("TestHarmonyToolParser::test_single_call", "tools", tool("harmony"),
     '<|channel|>commentary to=functions.get_weather '
     '<|constrain|>json<|message|>{"location": "SF"}<|call|>'),
    ("TestHarmonyToolParser::test_chunked_across_boundaries", "tools", tool("harmony"),
     'preamble <|channel|>commentary to=functions.search '
     '<|message|>{"q": "tpu"}<|call|> after'),
    ("TestHarmonyToolParser::test_non_function_commentary_passes_through", "tools",
     tool("gpt_oss"), "<|channel|>commentary to=user <|message|>hello<|end|>"),
    ("TestHarmonyToolParser::test_flush_accepts_missing_terminator", "tools",
     tool("harmony"), '<|channel|>commentary to=functions.f <|message|>{"a": 1}'),
    ("TestHarmonyToolParser::test_with_gpt_oss_reasoning", "delta",
     {"reasoning": "gpt_oss", "tool": "harmony"}, OSS_TOOLS),
    ("TestForcedToolChoice::test_required_array", "delta",
     {"tool_choice": "required", "finish_with_text": True},
     '[{"name": "a", "arguments": {"x": 1}}, {"name": "b", "parameters": {}}]'),
    ("TestForcedToolChoice::test_named_single_object", "delta",
     {"tool_choice": NAMED, "finish_with_text": True}, '{"city": "Paris"}'),
    ("TestForcedToolChoice::test_malformed_falls_back_to_content", "delta",
     {"tool_choice": "required", "finish_with_text": True}, "not json at all"),
    ("TestForcedToolChoice::test_forced_with_reasoning_model", "delta",
     {"tool_choice": "required", "reasoning": "think", "finish_with_text": True},
     '<think>let me plan</think>[{"name": "go", "arguments": {"n": 1}}]'),
]


def run_case(pkg, kind, arg, text, seed):
    if kind == "split_safe":
        return [pkg.split_safe(buf, markers) for buf, markers in arg]
    if kind == "registry":
        return registry_outcomes(pkg, arg, text)
    if kind == "safe_parser":
        return safe_parser_outcomes(pkg, arg)
    pieces = cut(text, seed)
    if kind == "holdback":
        return run_holdback(pkg, arg, pieces)
    if kind == "reasoning":
        return run_reasoning(pkg, arg, pieces)
    if kind == "tools":
        return run_tools(pkg, arg, pieces)
    return run_delta(pkg, arg, pieces)


def test_the_cases_are_the_references_tests():
    with open(jdelta.__file__.split("dynamo_tpu")[0] + "tests/test_parsers.py") as f:
        src = f.read()
    tests = []
    cls = None
    for line in src.splitlines():
        if line.startswith("class "):
            cls = line.split()[1].split("(")[0].rstrip(":")
        elif line.lstrip().startswith("def test_"):
            tests.append(f"{cls}::{line.split('def ')[1].split('(')[0]}")
    assert len(tests) == 30
    assert sorted(c[0] for c in CASES) == sorted(tests)


@pytest.mark.parametrize("case", CASES, ids=[c[0].split("::")[1] for c in CASES])
def test_parsers_equal_the_reference(case):
    name, kind, arg, text = case
    for k in range(CUTS):
        seed = 1000 * CASES.index(case) + k
        ref = run_case(J, kind, arg, text, seed)
        port = run_case(T, kind, arg, text, seed)
        assert port == ref, (name, seed, cut(text, seed) if isinstance(text, str) else None)


def test_the_delta_cases_reach_every_outcome():
    """The delta cases end in tool calls, in content only, and with
    reasoning beside a call."""
    seen = set()
    for name, kind, arg, text in CASES:
        if kind != "delta":
            continue
        chunks = run_delta(T, arg, cut(text, 5))
        deltas = [c["choices"][0]["delta"] for c in chunks if c["choices"]]
        finish = [c["choices"][0].get("finish_reason") for c in chunks
                  if c["choices"] and c["choices"][0].get("finish_reason")]
        seen.add((finish[-1], any("reasoning_content" in d for d in deltas),
                  any("tool_calls" in d for d in deltas)))
    assert ("tool_calls", True, True) in seen
    assert ("tool_calls", False, True) in seen
    assert ("stop", False, False) in seen


# ------------------------------------------- the named jail's envelope (port)
@pytest.mark.parametrize("text,arguments", [
    ('{"name": "lookup", "arguments": {"city": "Paris"}}', {"city": "Paris"}),
    ('{"city": "Paris"}', {"city": "Paris"}),
    ('{"name": "other", "arguments": {"city": "Paris"}}',
     {"name": "other", "arguments": {"city": "Paris"}}),
    ('{"name": "lookup", "arguments": {}, "x": 1}',
     {"name": "lookup", "arguments": {}, "x": 1}),
])
def test_named_tool_choice_reads_the_soft_grammars_envelope(text, arguments):
    """The preprocessor's soft grammar for a named tool_choice makes the
    model write ``{"name": <it>, "arguments": {...}}``: the port's call
    carries that object's arguments (the tool's schema holds them), the
    reference's the whole envelope. Anything else is read as the
    reference reads it."""
    kw = {"tool_choice": NAMED, "finish_with_text": True}
    port = run_delta(T, kw, cut(text, 3))
    ref = run_delta(J, kw, cut(text, 3))
    calls = [tc for c in port if c["choices"] for tc in
             c["choices"][0]["delta"].get("tool_calls", [])]
    assert [(c["function"]["name"], json.loads(c["function"]["arguments"]))
            for c in calls] == [("lookup", arguments)]
    ref_calls = [tc for c in ref if c["choices"] for tc in
                 c["choices"][0]["delta"].get("tool_calls", [])]
    assert json.loads(ref_calls[0]["function"]["arguments"]) == json.loads(text)
    if json.loads(text) == arguments:
        assert port == ref


# ------------------------------------------------ logprobs held with the text
@pytest.mark.parametrize("kw,text", [
    ({"reasoning": "think", "tool": "hermes"},
     '<think>ab</think>cd <tool_call>{"name": "f", "arguments": {}}</tool_call>ef'),
    ({"tool_choice": "required"}, "not a call"),
    ({"tool_choice": NAMED, "reasoning": "qwen3"}, '<think>x</think>{"k": 1}'),
    ({"tool": "hermes"}, "a <tool_ca b <tool_call>{\"name\": \"g\"}</tool_call>"),
])
def test_logprob_entries_ride_with_their_text_as_the_reference(kw, text):
    """One logprob entry a character: entries of text held back (a partial
    marker, the forced jail) ride on the chunk that releases the text;
    entries of text diverted into reasoning or a call are dropped."""

    def run(pkg):
        delta, common = (jdelta, jcommon) if pkg is J else (tdelta, tcommon)
        gen = delta.ChatDeltaGenerator(
            "r", "m", reasoning_parser=pkg.get_reasoning_parser(kw.get("reasoning")),
            tool_parser=pkg.get_tool_parser(kw.get("tool")),
            tool_choice=kw.get("tool_choice"))
        chunks = []
        for i, ch in enumerate(text):
            entry = {"token": ch, "logprob": -0.5 - i, "bytes": list(ch.encode()),
                     "top_logprobs": []}
            chunks += gen.on_output(common.BackendOutput(
                text=ch, token_ids=[ord(ch)], cumulative_tokens=i + 1,
                logprob_entries=[entry],
                finish_reason="stop" if i == len(text) - 1 else None))
        return [norm(dump(c)) for c in chunks]

    assert run(T) == run(J)


# ------------------------------------------------------- n > 1: own parsers
async def _stream(outputs):
    for o in outputs:
        yield o


@pytest.mark.parametrize("tool_choice", [None, "required"])
async def test_each_choice_parses_with_its_own_parsers(tool_choice):
    """aggregate_chat_multi (n = 2) builds each choice's parsers from the
    factories: a marker split across one choice's outputs never meets the
    other's text."""
    texts = ['<think>one</think><tool_call>{"name": "a", "arguments": {}}</tool_call>',
             '<think>two</think>[{"name": "b", "arguments": {"y": 2}}]']

    async def run(pkg):
        delta, common = (jdelta, jcommon) if pkg is J else (tdelta, tcommon)
        streams = [_stream([common.BackendOutput(text=p, token_ids=[1], cumulative_tokens=i)
                            for i, p in enumerate(cut(t, 7 + j))]
                           + [common.BackendOutput(finish_reason="stop")])
                   for j, t in enumerate(texts)]
        resp = await delta.aggregate_chat_multi(
            "r", "m", streams,
            reasoning_parser_factory=lambda: pkg.get_reasoning_parser("qwen3"),
            tool_parser_factory=lambda: pkg.get_tool_parser("hermes"),
            tool_choice=tool_choice)
        return norm(dump(resp))

    port = await run(T)
    assert port == await run(J)
    assert [c["message"]["reasoning_content"] for c in port["choices"]] == ["one", "two"]
