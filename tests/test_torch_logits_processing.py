"""Logits processors in the port (dynamo_tpu_torch/logits_processing, the
engine's ``logits_processors``) against the reference's
(dynamo_tpu/logits_processing, TpuEngine), on the CPU.

- ``apply_processors`` and the three example processors on the same
  logits, output counts and per-row masks, within 1e-6, and the same
  errors;
- TorchEngine against TpuEngine on the reference tests' tiny model, one
  batch queued at once (prompts chunked and carried by mixed steps):
  a plain row, a ``ban`` row, a count-reading ``norepeat`` row with no
  penalties anywhere in the batch (the reference's
  ``test_count_reading_processor_works_without_penalties``) and a seeded
  sampled row with both, at ``decode_steps`` 1 and 4 (horizons): streams
  equal, logprobs within 1e-5 (those of the raw logits); the plain row
  equals a processor-less engine's; the banned ids never appear;
- the horizon replays its feature body only for a dispatch with a
  processor row; that body (processors, the grammar mask, LoRA deltas)
  makes no host round trip; the unknown-name refusal.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import logits_processing as jlp
from dynamo_tpu_torch import logits_processing as tlp
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tllama
from test_torch_horizon_graphs import MODEL as HZ_MODEL
from test_torch_horizon_graphs import _fill_state, _raise, _restore, _snapshot
from torch_feature_engines import Weights, collect, request, serve, tokens

MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=96)
ENGINE = dict(num_blocks=128, block_size=16, max_batch_size=4, max_context=128,
              prefill_buckets=(16, 32, 64))
N = 16
LOGPROB_TOL = 1e-5


def _procs(pkg, banned):
    return (("ban", pkg.ban_tokens_processor(banned)),
            ("norepeat", pkg.repetition_window_processor(1e9)))


# --------------------------------------------------------------- the functions
@pytest.mark.parametrize("name", ["temperature", "ban", "repetition_window", "all"])
def test_processors_equal_the_reference(name):
    rng = np.random.default_rng(0)
    B, V = 5, 64
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    masks = np.array([[True, False, True], [False, False, False], [True, True, True],
                      [False, True, False], [True, True, False]])
    makers = {"temperature": lambda p: p.temperature_processor(2.5),
              "ban": lambda p: p.ban_tokens_processor([3, 17, 63]),
              "repetition_window": lambda p: p.repetition_window_processor(5.0)}
    names = list(makers) if name == "all" else [name]
    steps, lens = np.arange(B), np.arange(B) + 10
    want = jlp.apply_processors(
        tuple((n, makers[n](jlp)) for n in names), jnp.asarray(masks[:, :len(names)]),
        jnp.asarray(logits), {"output_counts": jnp.asarray(counts),
                              "steps": jnp.asarray(steps), "seq_lens": jnp.asarray(lens)})
    got = tlp.apply_processors(
        tuple((n, makers[n](tlp)) for n in names), torch.from_numpy(masks[:, :len(names)]),
        torch.from_numpy(logits), {"output_counts": torch.from_numpy(counts),
                                   "steps": torch.from_numpy(steps),
                                   "seq_lens": torch.from_numpy(lens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # rows that opted into nothing pass unchanged
    np.testing.assert_array_equal(got.numpy()[1], logits[1])


def test_processor_errors_and_protocol():
    for pkg in (jlp, tlp):
        with pytest.raises(ValueError, match="temperature must be positive"):
            pkg.temperature_processor(0.0)
    assert isinstance(tlp.repetition_window_processor(1.0), tlp.BaseLogitsProcessor)


# ----------------------------------------------------------------- the engine
PROMPTS = {"plain": tokens(1, 12, 128), "ban": tokens(2, 40, 128),
           "norepeat": tokens(3, 20, 128), "sampled": tokens(4, 70, 128)}
OPT_IN = {"plain": [], "ban": ["ban"], "norepeat": ["norepeat"],
          "sampled": ["ban", "norepeat"]}
SAMPLING = {"sampled": dict(temperature=0.8, seed=7)}


def _batch(opt_in=True):
    return [[(rid, PROMPTS[rid], N,
              dict(ann={"logits_processors": OPT_IN[rid]} if opt_in and OPT_IN[rid] else {},
                   ignore_eos=True, logprobs=1, **SAMPLING.get(rid, {})))
             for rid in PROMPTS]]


@pytest.fixture(scope="module")
def streams():
    w = Weights(MODEL)
    # the processor-less engine's streams; the ban list is two ids the
    # plain "ban" prompt streams, so the processor provably changes it
    plain = dict(zip(PROMPTS, serve(w.torch_engine(ENGINE, decode_steps=1,
                                                   decode_pipeline=1), _batch(False))))
    banned = list(dict.fromkeys(plain["ban"]["tokens"]))[:2]
    ref = dict(zip(PROMPTS, serve(w.jax_engine(ENGINE, logits_processors=_procs(jlp, banned)),
                                  _batch())))
    port = {}
    for steps in (1, 4):
        e = w.torch_engine(ENGINE, decode_steps=steps, decode_pipeline=1,
                           logits_processors=_procs(tlp, banned))
        port[steps] = dict(zip(PROMPTS, serve(e, _batch())))
        port[steps]["_engine"] = e
    return plain, banned, ref, port


@pytest.mark.parametrize("steps", [1, 4])
def test_streams_equal_tpu_engine(streams, steps):
    _, _, ref, port = streams
    for rid in PROMPTS:
        got, want = port[steps][rid], ref[rid]
        assert got["tokens"] == want["tokens"], rid
        assert got["finish"] == want["finish"] == "length", rid
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=LOGPROB_TOL)
    e = port[steps]["_engine"]
    assert e.step_counts["mixed"] > 0
    assert (e.step_counts["horizon"] > 0) == (steps > 1)


def test_processors_act_on_their_rows_only(streams):
    plain, banned, ref, port = streams
    assert port[1]["plain"]["tokens"] == plain["plain"]["tokens"]
    for rid in ("ban", "sampled"):
        assert not set(ref[rid]["tokens"]) & set(banned), rid
    assert ref["ban"]["tokens"] != plain["ban"]["tokens"]
    # the count-reading processor works with no penalties in the batch:
    # nothing repeats (greedy on the tiny model would)
    for rid in ("norepeat", "sampled"):
        toks = ref[rid]["tokens"]
        assert len(set(toks)) == len(toks), rid
    assert len(set(plain["norepeat"]["tokens"])) < N


def test_horizon_feature_body_only_for_processor_rows():
    """A batch without processor rows replays the plain horizon body
    (feat False); one with such a row, the feature body."""
    w = Weights(MODEL)
    e = w.torch_engine(ENGINE, decode_steps=4, decode_pipeline=1,
                       logits_processors=_procs(tlp, [5]))
    feats = []
    body = e._horizon.body

    def spy(hs, max_seq_len, sampled, feat=False):
        feats.append(feat)
        return body(hs, max_seq_len, sampled, feat)

    e._horizon.body = spy

    async def main():
        try:
            await collect(e, request(False, "a", PROMPTS["plain"], 9))
            plain = list(feats)
            feats.clear()
            await collect(e, request(False, "b", PROMPTS["plain"], 9,
                                     ann={"logits_processors": ["ban"]}))
            return plain, list(feats)
        finally:
            e.stop()

    plain, with_row = asyncio.run(main())
    assert plain and not any(plain)
    assert with_row and all(with_row)


def test_unknown_processor_is_refused():
    w = Weights(MODEL)
    e = w.torch_engine(ENGINE, decode_steps=1, decode_pipeline=1,
                       logits_processors=(("ban", tlp.ban_tokens_processor([1])),))

    async def main():
        try:
            with pytest.raises(ValueError, match="unknown logits processors"):
                await collect(e, request(False, "r", [1, 2, 3], 4,
                                         ann={"logits_processors": ["ghost"]}))
        finally:
            e.stop()

    asyncio.run(main())


def test_feature_body_is_capture_safe(monkeypatch):
    """The horizon's feature body (processors, the grammar mask and FSM
    step, LoRA deltas) makes no host round trip and no host-to-device copy,
    as tests/test_torch_horizon_graphs.py holds the plain body: it runs
    with those patched to raise and equals its unpatched run bit for bit,
    the FSM states in the carry included."""
    cfg = tllama.LlamaConfig(dtype=torch.float32, **HZ_MODEL)
    V = cfg.vocab_size
    e = TorchEngine(TorchEngineConfig(
        model=cfg, num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
        prefill_buckets=(16, 32, 64), device="cpu", decode_steps=4, decode_pipeline=1,
        logits_processors=_procs(tlp, [5, 77]), lora_max_adapters=2, lora_rank=4,
        guided_max_states=16, guided_max_classes=8),
        guided_vocab=([bytes([i % 256]) for i in range(V)], V - 1))
    rng = np.random.default_rng(1)
    for name in ("a", "b"):
        e.lora.load(name, {f"{t}.{ab}": rng.standard_normal(
            (2, *((64, 4) if ab == "A" else (4, 64 if t in ("wq", "wo") else 32))),
        ).astype(np.float32) for t in ("wq", "wk", "wv", "wo") for ab in "AB"})
    try:
        _fill_state(e)
        hs = e._horizon.state
        hs.lora_ids.copy_(torch.tensor([1, 0, 2, 0]))
        hs.proc_masks.copy_(torch.tensor([[True, False], [False, False], [True, True],
                                          [False, True]]))
        hs.g_active.copy_(torch.tensor([True, False, True, False]))
        hs.g_state.copy_(torch.tensor([3, 0, 7, 0], dtype=torch.int32))
        e.g_class.copy_(torch.from_numpy(rng.integers(0, 8, size=(4, V))))
        e.g_trans.copy_(torch.from_numpy(rng.integers(0, 16, size=(4, 16, 8))))
        before = _snapshot(e)
        e._decode_multi(hs, 64, True, True)
        want = _snapshot(e)
        _restore(e, before)
        with monkeypatch.context() as m:
            for name in ("tolist", "item", "__bool__", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, _raise)
            m.setattr(torch, "as_tensor", _raise)
            m.setattr(torch, "tensor", _raise)
            e._decode_multi(hs, 64, True, True)
        got = _snapshot(e)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # the guided rows' states moved; the others kept theirs
        assert hs.g_state[1] == 0 and hs.g_state[3] == 0
        toks = hs.packed[:, :, 0].long()
        assert not (toks[:, 0] == 5).any() and not (toks[:, 0] == 77).any()
    finally:
        e.stop()
