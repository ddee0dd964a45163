"""Tool calls and reasoning through the port's OpenAI frontend, against the
reference's, on the CPU.

Both packages' serving planes (runtime, ``register_llm`` with the Backend,
ModelWatcher, HTTP service, as tests/test_torch_frontend.py wires them)
serve the same scripted engine: it streams the UTF-8 bytes of a reply
chosen by the prompt, one token an output, then EOS, with a logprob for
each token. Three model cards: ``m`` names the ``hermes`` tool parser and
the ``qwen3`` reasoning parser, ``oss`` the ``harmony`` / ``gpt_oss`` pair,
``bad`` names parsers neither package knows (text passes through, with a
warning). The same corpus goes to both frontends over HTTP, and the
bodies and SSE chunks must be equal, ignoring ids and timestamps: a forced
named function, ``"required"``, ``auto`` with a hermes call, ``none``, a
``<think>`` answer with logprobs, gpt-oss channels, ``n = 2`` with a seed
(each choice's chunks in order) and the unknown parser names; streamed and
whole. The forced named function's soft grammar (its preprocessed
request) is the reference's too.
"""

import asyncio
import json

import aiohttp
import pytest

from dynamo_tpu import llm as jllm
from dynamo_tpu import runtime as jrt
from dynamo_tpu.llm.http.service import HttpService as JHttpService
from dynamo_tpu.llm.protocols import openai as jopenai
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import openai as topenai
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    FnEngine,
    InProcEventPlane,
    MemKVStore,
    RuntimeConfig,
)
from test_torch_frontend import _by_choice, _norm, _same, _send
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

EOS = ByteTokenizer.EOS
WEATHER = {"type": "function", "function": {
    "name": "get_weather", "description": "the weather in a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"},
                                  "days": {"type": "integer"}},
                   "required": ["city"]}}}
NAMED = {"type": "function", "function": {"name": "get_weather"}}
HERMES = '<tool_call>{"name": "get_weather", "arguments": {"city": "SF"}}</tool_call>'
# the prompt's key -> the reply (a list: one per choice, by the choice's seed)
REPLIES = {
    "Q-named": '{"city": "Paris", "days": 2}',
    "Q-required": '[{"name": "get_weather", "arguments": {"city": "Oslo"}}, '
                  '{"name": "get_weather", "parameters": {"city": "Rome"}}]',
    "Q-auto": "Let me check. " + HERMES + "\n",
    "Q-none": "Raw: " + HERMES,
    "Q-think": "<think>step by step</think>The answer is 4.",
    "Q-oss": ("<|channel|>analysis<|message|>think hard<|end|>"
              '<|channel|>commentary to=functions.get_weather <|message|>{"city": "Lima"}'
              "<|call|><|channel|>final<|message|>done<|return|>"),
    "Q-n2": ["<think>first</think>" + HERMES, "<think>second</think>plain text <tool_"],
    "Q-bad": "<think>x</think>" + HERMES,
    "Q-malformed": "not a call at all",
}


def _chat(model, key, **kw):
    return {"model": model, "messages": [{"role": "user", "content": f"{key}: go"}],
            "max_tokens": 200, **kw}


STREAM = dict(stream=True, stream_options={"include_usage": True})
CORPUS = [
    ("named", _chat("m", "Q-named", tools=[WEATHER], tool_choice=NAMED)),
    ("named_stream", _chat("m", "Q-named", tools=[WEATHER], tool_choice=NAMED, **STREAM)),
    ("required", _chat("m", "Q-required", tools=[WEATHER], tool_choice="required")),
    ("required_stream", _chat("m", "Q-required", tools=[WEATHER], tool_choice="required",
                              stream=True)),
    ("required_malformed", _chat("m", "Q-malformed", tools=[WEATHER],
                                 tool_choice="required", logprobs=True)),
    ("auto_hermes", _chat("m", "Q-auto", tools=[WEATHER], tool_choice="auto")),
    ("auto_hermes_stream", _chat("m", "Q-auto", tools=[WEATHER], **STREAM)),
    ("none", _chat("m", "Q-none", tools=[WEATHER], tool_choice="none")),
    ("think_logprobs", _chat("m", "Q-think", logprobs=True, top_logprobs=0)),
    ("think_logprobs_stream", _chat("m", "Q-think", logprobs=True, **STREAM)),
    ("oss", _chat("oss", "Q-oss", tools=[WEATHER])),
    ("oss_stream", _chat("oss", "Q-oss", tools=[WEATHER], stream=True)),
    ("n2", _chat("m", "Q-n2", n=2, seed=4, tools=[WEATHER])),
    ("n2_stream", _chat("m", "Q-n2", n=2, seed=4, tools=[WEATHER], **STREAM)),
    ("unknown_parser", _chat("bad", "Q-bad")),
    ("unknown_parser_stream", _chat("bad", "Q-bad", stream=True)),
]
NAMES = [c[0] for c in CORPUS]
CARDS = {"m": ("hermes", "qwen3"), "oss": ("harmony", "gpt_oss"),
         "bad": ("no-such-tool-parser", "no-such-reasoning-parser")}


async def scripted(request, context):
    """The reply of the prompt's key, a token an output, then EOS; each
    token with a logprob."""
    prompt = bytes(t for t in request.token_ids if t < 256).decode()
    key = next(k for k in REPLIES if k + ":" in prompt)
    reply = REPLIES[key]
    if isinstance(reply, list):
        reply = reply[(request.sampling.seed or 0) % len(reply)]
    for i, t in enumerate(list(reply.encode()) + [EOS]):
        await asyncio.sleep(0)
        yield {"token_ids": [t], "cum": i + 1, "logprobs": [-0.25 - 0.001 * i]}


async def _run_stack(port: bool):
    if port:
        mk_card, reg, mgr, watcher_cls, svc_cls = (
            ModelDeploymentCard, register_llm, ModelManager, ModelWatcher, HttpService)
        make_rt = lambda store: DistributedRuntime(  # noqa: E731
            RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0),
            store=store, event_plane=InProcEventPlane())
        store, engine = MemKVStore(), FnEngine(scripted)
    else:
        mk_card, reg, mgr, watcher_cls, svc_cls = (
            jllm.ModelDeploymentCard, jllm.register_llm, jllm.ModelManager,
            jllm.ModelWatcher, JHttpService)
        make_rt = lambda store: jrt.DistributedRuntime(  # noqa: E731
            jrt.RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0),
            store=store, event_plane=jrt.InProcEventPlane())
        store, engine = jrt.MemKVStore(), jrt.FnEngine(scripted)
    worker_rt = await make_rt(store).start()
    frontend_rt = await make_rt(store).start()
    served = [await reg(worker_rt, engine, mk_card(
        name=name, component=f"backend-{name}", tokenizer="byte", context_length=4096,
        tool_parser=tool, reasoning_parser=reasoning))
        for name, (tool, reasoning) in CARDS.items()]
    manager = mgr()
    watcher = await watcher_cls(frontend_rt, manager).start()
    service = svc_cls(manager, host="127.0.0.1", port=0)
    await service.start()
    base = f"http://127.0.0.1:{service.port}"
    results = {}
    try:
        for _ in range(300):
            if all(manager.get(n) and manager.get(n).client.instances for n in CARDS):
                break
            await asyncio.sleep(0.02)
        async with aiohttp.ClientSession() as s:
            for name, body in CORPUS:
                results[name] = await _send(s, base, "POST", "/v1/chat/completions", body)
        req = (topenai.ChatCompletionRequest.from_obj(CORPUS[0][1]) if port
               else jopenai.ChatCompletionRequest.model_validate(CORPUS[0][1]))
        results["named_preprocessed"] = manager.get("m").preprocessor.preprocess_chat(
            req).to_obj()
    finally:
        await service.stop()
        await watcher.stop()
        for s in served:
            await s.stop()
        await worker_rt.shutdown()
        await frontend_rt.shutdown()
    return results


@pytest.fixture(scope="module")
def bodies():
    return asyncio.run(_run_stack(False)), asyncio.run(_run_stack(True))


@pytest.mark.parametrize("name", NAMES)
def test_tool_and_reasoning_bodies_equal_the_reference(bodies, name):
    ref, port = bodies
    (rs, rb), (ps, pb) = ref[name], port[name]
    assert ps == rs == 200, (name, rb, pb)
    if "stream" in pb:
        assert pb["done"] and rb["done"]
        if name.startswith("n2"):
            _same(_norm(_by_choice(pb["stream"])), _norm(_by_choice(rb["stream"])), name)
        else:
            _same(_norm(pb["stream"]), _norm(rb["stream"]), name)
    else:
        _same(_norm(pb), _norm(rb), name)


def test_the_corpus_reaches_every_outcome(bodies):
    _, port = bodies

    def message(name):
        return port[name][1]["choices"][0]

    named = message("named")
    assert named["finish_reason"] == "tool_calls"
    (call,) = named["message"]["tool_calls"]
    assert call["function"]["name"] == "get_weather"
    assert json.loads(call["function"]["arguments"]) == {"city": "Paris", "days": 2}
    assert [c["function"]["name"] for c in message("required")["message"]["tool_calls"]] \
        == ["get_weather", "get_weather"]
    assert message("required_malformed")["finish_reason"] == "stop"
    assert message("required_malformed")["logprobs"]["content"]
    assert message("auto_hermes")["message"]["content"] == "Let me check. \n"
    assert "<tool_call>" in message("none")["message"]["content"]
    think = message("think_logprobs")
    assert think["message"]["reasoning_content"] == "step by step"
    assert think["message"]["content"] == "The answer is 4."
    # the entries of text held back as a possible tag ride on the next
    # content chunk, as in the reference
    assert "".join(e["token"] for e in think["logprobs"]["content"]).endswith(
        "The answer is 4.")
    oss = message("oss")
    assert (oss["message"]["reasoning_content"], oss["message"]["content"]) == \
        ("think hard", "done")
    assert oss["finish_reason"] == "tool_calls"
    n2 = port["n2"][1]["choices"]
    assert [c["finish_reason"] for c in n2] == ["tool_calls", "stop"]
    assert [c["message"]["reasoning_content"] for c in n2] == ["first", "second"]
    assert n2[1]["message"]["content"] == "plain text <tool_"
    bad = message("unknown_parser")
    assert bad["message"]["content"] == REPLIES["Q-bad"] and bad["finish_reason"] == "stop"
    # streamed tool calls join up to the whole reply's
    streamed = [tc for c in port["named_stream"][1]["stream"] if c["choices"]
                for tc in c["choices"][0]["delta"].get("tool_calls", [])]
    assert [(c["function"], c["index"]) for c in streamed] == [(call["function"], 0)]


def test_a_named_tool_choice_carries_the_references_soft_grammar(bodies):
    ref, port = bodies
    r, p = ref["named_preprocessed"], port["named_preprocessed"]
    assert p["sampling"]["guided"] == r["sampling"]["guided"]
    assert p["sampling"]["guided"]["soft"] is True
    assert p["sampling"]["guided"]["value"]["properties"]["arguments"] == \
        WEATHER["function"]["parameters"]
