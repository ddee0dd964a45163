"""Guided decoding in the port's engine (TorchEngine
``guided_max_states``) against TpuEngine's, on the CPU, on the reference
tests' model over the byte vocabulary.

- regex, choice and JSON-schema rows with a plain batchmate, a sampled
  row chained across horizons (``decode_steps=6``, ``decode_pipeline=2``),
  a row resumed past ``prior_token_ids``, a JSON-schema row alone, on a
  float and on an int8 cache:
  streams and finishes equal TpuEngine's (one step a tick), every guided
  output in its grammar and ending at EOS; the unguided rows equal a
  guided-disabled engine's;
- the rejections and the soft degrade, with the reference's messages;
- a spec engine whose guided row runs no spec round.
"""

import asyncio
import json
import logging
import re as pyre

import pytest
import torch

from dynamo_tpu_torch.models import llama as tllama
from test_torch_guided import BYTE_VOCAB, EOS, SMALL_SCHEMA
from torch_feature_engines import Weights, collect, request, serve
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

# ------------------------------------------------------------ the engine
MODEL = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=128, block_size=4, max_batch_size=4, max_context=512,
              prefill_buckets=(16, 32, 64))
GUIDED = dict(guided_max_states=256, guided_max_classes=128,
              guided_vocab=(BYTE_VOCAB[:260], EOS))
HORIZON = dict(decode_steps=6, decode_pipeline=2)
HI = [104, 105, 32]   # "hi "
LONG = list(b"Answer in JSON, please, with the fields that the schema names: ")


def _g(kind, value):
    return {"guided": {"kind": kind, "value": value}}


# (rid, prompt, max_tokens, request kwargs, grammar) in batches queued at once
BATCHES = [
    [("regex", HI, 48, _g("regex", r"(cat|car)s?"), r"(cat|car)s?"),
     ("choice", LONG, 48, _g("choice", ["alpha", "beta", "gamma"]), "alpha|beta|gamma"),
     ("json", HI, 96, _g("json", SMALL_SCHEMA), None),
     ("plain", LONG[:20], 12, {}, None)],
    [("long", HI, 64, dict(_g("regex", r"[ab]{40}"), temperature=1.0, seed=3), r"[ab]{40}"),
     ("resume", HI, 48, dict(_g("choice", ["left", "right"]),
                             prior=[ord("l"), ord("e")]), "ft"),
     ("sampled", LONG, 24, dict(temperature=0.9, seed=5), None)],
    [("alone", LONG[:30], 64, _g("json", SMALL_SCHEMA), None)],
]


def _batches(drop_grammar=False):
    out = []
    for batch in BATCHES:
        out.append([(rid, toks, n, dict({k: v for k, v in kw.items()
                                         if not (drop_grammar and k == "guided")},
                                        stop=[EOS]))
                    for rid, toks, n, kw, _ in batch])
    return out


RIDS = [r[0] for b in BATCHES for r in b]


def _text(toks):
    return bytes(t for t in toks if t < 256).decode("utf-8", "replace")


@pytest.fixture(scope="module")
def weights():
    return Weights(MODEL)


@pytest.fixture(scope="module")
def streams(weights):
    out = {}
    for kv in ("auto", "int8"):
        out[("ref", kv)] = dict(zip(RIDS, serve(
            weights.jax_engine(ENGINE, kv_dtype=kv, **GUIDED), _batches())))
        e = weights.torch_engine(ENGINE, kv_dtype=kv, **HORIZON, **GUIDED)
        out[("port", kv)] = dict(zip(RIDS, serve(e, _batches())))
        out[("engine", kv)] = e
    out["disabled"] = dict(zip(RIDS, serve(weights.torch_engine(ENGINE, **HORIZON),
                                           _batches(drop_grammar=True))))
    return out


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_streams_equal_tpu_engine(streams, kv):
    ref, port = streams[("ref", kv)], streams[("port", kv)]
    for rid in RIDS:
        assert port[rid]["tokens"] == ref[rid]["tokens"], rid
        assert port[rid]["finish"] == ref[rid]["finish"], rid
    e = streams[("engine", kv)]
    assert e.step_counts["horizon"] > 0 and e.step_counts["mixed"] > 0


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_guided_outputs_are_in_their_grammars(streams, kv):
    port = streams[("port", kv)]
    for batch in BATCHES:
        for rid, _, _, _, pattern in batch:
            if pattern is None:
                continue
            assert pyre.fullmatch(pattern, _text(port[rid]["tokens"])), (rid, port[rid])
            assert port[rid]["finish"] == "stop", rid
    for rid in ("json", "alone"):
        obj = json.loads(_text(port[rid]["tokens"]))
        assert isinstance(obj["ok"], bool) and obj["mood"] in {"happy", "sad"}, rid
        assert port[rid]["finish"] == "stop", rid


def test_unguided_rows_equal_a_guided_disabled_engine(streams):
    port, off = streams[("port", "auto")], streams["disabled"]
    for rid in ("plain", "sampled"):
        assert port[rid]["tokens"] == off[rid]["tokens"], rid
    assert len(port["plain"]["tokens"]) == 12


def test_rejections_and_the_soft_degrade(weights, caplog):
    e = weights.torch_engine(ENGINE, **HORIZON, **dict(GUIDED, guided_max_states=16))
    off = weights.torch_engine(ENGINE, **HORIZON)

    async def main():
        try:
            with pytest.raises(ValueError, match="guided grammar rejected"):
                await collect(e, request(False, "bad", HI, 8, **_g("regex", "([")))
            with pytest.raises(ValueError, match="needs 41 states > engine cap 16"):
                await collect(e, request(False, "big", HI, 8, **_g("regex", "a{40}")))
            with pytest.raises(ValueError, match="prior tokens violate"):
                await collect(e, request(False, "x", HI, 8, prior=[ord("x")],
                                         **_g("choice", ["left", "right"])))
            with caplog.at_level(logging.WARNING):
                soft = await collect(e, request(False, "soft", HI, 8, ignore_eos=True, guided={
                    "kind": "regex", "value": "a{40}", "soft": True}))
            with pytest.raises(ValueError, match="without guided"):
                await collect(off, request(False, "off", HI, 8,
                                           **_g("json_object", None)))
            soft_off = await collect(off, request(False, "soft", HI, 8, ignore_eos=True, guided={
                "kind": "json", "value": {"type": "object"}, "soft": True}))
            return soft, soft_off
        finally:
            e.stop()
            off.stop()

    soft, soft_off = asyncio.run(main())
    assert len(soft["tokens"]) == 8 and len(soft_off["tokens"]) == 8
    assert "soft guided grammar rejected; serving unconstrained" in caplog.text
    with pytest.raises(ValueError, match="guided_vocab"):
        weights.torch_engine(ENGINE, guided_max_states=16)


def test_a_guided_row_runs_no_spec_round(weights):
    draft = tllama.LlamaConfig(vocab_size=260, hidden_size=32, num_layers=1, num_heads=2,
                               num_kv_heads=1, head_dim=16, intermediate_size=64,
                               dtype=torch.float32)
    e = weights.torch_engine(ENGINE, **HORIZON, **GUIDED, spec_draft=draft, spec_k=3)
    (out,) = serve(e, [[("gs", HI, 48, dict(_g("choice", ["left", "right"]), stop=[EOS]))]])
    assert _text(out["tokens"]) in {"left", "right"} and out["finish"] == "stop"
    assert e.spec_stats["rounds"] == 0 and e.step_counts["spec"] == 0
    assert e.step_counts["horizon"] > 0
