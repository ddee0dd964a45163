"""Guided decoding in the port (dynamo_tpu_torch/guided, the engine's
``guided_max_states``) against the reference's (dynamo_tpu/guided,
TpuEngine), on the CPU.

- the compiler: ``compile_regex``, ``schema_to_regex``,
  ``guided_regex_pattern`` and ``build_token_tables`` array-equal to the
  reference's on the reference tests' patterns and schemas, over the byte
  vocabulary and over a ``tokenizers`` byte-level BPE built here (as the
  reference's ``test_hf_bytelevel_bpe_vocab_and_guided_generation``);
  ``vocab_bytes_from_tokenizer`` equal on both packages' byte and HF
  tokenizers;
- the device ops ``guided_mask`` / ``guided_step`` against the
  reference's ``gmask`` / ``gstep`` semantics on random tables;

The engine's streams: tests/test_torch_guided_engine.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from dynamo_tpu import guided as jg
from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu_torch import guided as tg
from dynamo_tpu_torch.engine.sampling import guided_mask, guided_step
from dynamo_tpu_torch.llm import tokenizer as ttok

# ------------------------------------------------------------ the compiler
PATTERNS = [r"abc", r"a+b?", r"(foo|bar)+", r"[a-z]{2,4}", r"-?(0|[1-9][0-9]*)(\.[0-9]+)?",
            r"[^x]+", r"\d{3}-\d{4}", r'"([^"\\]|\\.)*"', r"(?:ab)*c", r"(cat|car)s?",
            r"[ab]{40}"]
SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}},
        "mood": {"enum": ["happy", "sad"]},
    },
    "required": ["name", "age", "mood"],
}
SMALL_SCHEMA = {"type": "object",
                "properties": {"ok": {"type": "boolean"}, "mood": {"enum": ["happy", "sad"]}},
                "required": ["ok", "mood"]}
SPECS = [("regex", r"(cat|car)s?"), ("choice", ["alpha", "beta", "gamma"]),
         ("json", SCHEMA), ("json", SMALL_SCHEMA), ("json_object", None)]
BYTE_VOCAB = [bytes([i]) for i in range(256)] + [None, None]  # 257 = eos
EOS = 257


def _same_dfa(a, b):
    np.testing.assert_array_equal(a.trans, b.trans)
    np.testing.assert_array_equal(a.accept, b.accept)


def _same_tables(a, b):
    for f in ("class_of", "trans", "accept"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.eos_id == b.eos_id


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_dfa_and_tables_equal_the_reference(pattern):
    want, got = jg.compile_regex(pattern), tg.compile_regex(pattern)
    _same_dfa(got, want)
    _same_tables(tg.build_token_tables(got, BYTE_VOCAB, EOS),
                 jg.build_token_tables(want, BYTE_VOCAB, EOS))


@pytest.mark.parametrize("kind,value", SPECS, ids=lambda x: str(x)[:16])
def test_grammar_patterns_equal_the_reference(kind, value):
    pattern = tg.guided_regex_pattern(kind, value)
    assert pattern == jg.guided_regex_pattern(kind, value)
    if kind == "json":
        assert tg.schema_to_regex(value) == jg.schema_to_regex(value)
    _same_dfa(tg.compile_regex(pattern, max_states=8192),
              jg.compile_regex(pattern, max_states=8192))


def test_compile_errors_equal_the_reference():
    for pkg in (jg, tg):
        with pytest.raises(pkg.RegexError, match="matches nothing"):
            pkg.compile_regex(r"a[^\x00-\xff]b")
        with pytest.raises(pkg.RegexError):
            pkg.compile_regex("([")


def test_byte_tokenizer_vocab_equals_the_reference():
    assert (tg.vocab_bytes_from_tokenizer(ttok.ByteTokenizer())
            == jg.vocab_bytes_from_tokenizer(jtok.ByteTokenizer()))


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A byte-level BPE trained here (the reference test's)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=["<eos>", "<pad>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(['{"name": "bob", "age": 3}', "hello world", "cat car cats",
                             "0123456789 true false null"], trainer)
    d = str(tmp_path_factory.mktemp("bpe"))
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<eos>",
                   "pad_token": "<pad>"}, f)
    return d


def test_bpe_vocab_and_tables_equal_the_reference(bpe_dir):
    hft = ttok.HFTokenizer(bpe_dir)
    vocab, eos = tg.vocab_bytes_from_tokenizer(hft)
    assert (vocab, eos) == jg.vocab_bytes_from_tokenizer(jtok.HFTokenizer(bpe_dir))
    assert vocab[eos] is None
    for text in ['{"a": 12}', "cat cars", "true,false"]:
        assert b"".join(vocab[i] for i in hft.encode(text)) == text.encode()
    for kind, value in SPECS[:4]:
        pattern = tg.guided_regex_pattern(kind, value)
        _same_tables(tg.build_token_tables(tg.compile_regex(pattern), vocab, eos),
                     jg.build_token_tables(jg.compile_regex(pattern), vocab, eos))


# ------------------------------------------------------------ the device ops
def test_guided_mask_and_step_follow_the_tables():
    rng = np.random.default_rng(0)
    B, V, S, C = 4, 40, 6, 5
    trans = rng.integers(-1, S, size=(B, S, C)).astype(np.int32)
    cls = rng.integers(0, C, size=(B, V)).astype(np.int32)
    state = rng.integers(0, S, size=B).astype(np.int32)
    active = np.array([True, False, True, True])
    logits = rng.standard_normal((B, V)).astype(np.float32)
    got = guided_mask(*map(torch.from_numpy, (logits, active, state, cls, trans))).numpy()
    for b in range(B):
        ok = trans[b, state[b]][cls[b]] >= 0
        want = np.where(ok | ~active[b], logits[b], np.float32(-1e30))
        np.testing.assert_array_equal(got[b], want)
    toks = rng.integers(0, V, size=B)
    nxt = guided_step(*map(torch.from_numpy, (state, toks, active, cls, trans))).numpy()
    for b in range(B):
        want = max(trans[b, state[b], cls[b, toks[b]]], 0) if active[b] else state[b]
        assert nxt[b] == want
