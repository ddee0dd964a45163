"""What the decode horizon's CUDA graphs rely on, checked on the CPU.

- The horizon body (``TorchEngine._decode_multi``) makes no host round
  trip and no host-to-device copy: it runs through, and equals its
  unpatched run bit for bit, with ``Tensor.tolist / item / __bool__ / cpu /
  numpy`` and ``torch.as_tensor / torch.tensor`` patched to raise (llama on
  a float and an int8 cache; the CPU's plain unified attention reads its
  row arrays on the host, so the Gemma body is held to this on the card).
- A bucketed ``max_seq_len`` changes no split: ``att.split_plan`` gives
  the same plan for every split bound at or above what a row needs, and
  the plain split decode gives the same output.
- ``autotune_decode_schedule``: the rule's form, None resolving to a
  schedule and explicit values winning (tests/test_engine.py:440-485).
- Launch counting through replays (``_build.recording_launches``).
- The faults repaired with the horizon: the decode scratch keyed by
  (device, stream) with its capture guard, the dtype in the page-copy
  layer table's key, and the prefix cache serving a decode-sealed block
  before its last row is written.
"""

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import engine as eng
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig, _Seq
from dynamo_tpu_torch.engine.graphs import seq_len_buckets
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import block_copy as bc
from dynamo_tpu_torch.ops import cuda_attention
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.tokens import TokenBlockSequence

MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=128)


def _engine(**kw):
    cfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    base = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
                prefill_buckets=(16, 32, 64), device="cpu", decode_steps=4,
                decode_pipeline=1)
    return TorchEngine(TorchEngineConfig(model=cfg, **{**base, **kw}))


# ------------------------------------------------------- capture safety
def _fill_state(engine):
    """Random caches and a horizon state with three of four rows active:
    one greedy, one sampled with top-p, one with penalties."""
    gen = torch.Generator().manual_seed(0)
    for c in engine.k_caches + engine.v_caches:
        if hasattr(c, "scale"):
            c.data.copy_(torch.randint(-127, 128, c.data.shape, generator=gen))
            c.scale.copy_(torch.rand(c.scale.shape, generator=gen) * 0.05)
        else:
            c.copy_(torch.randn(c.shape, generator=gen))
    hs = engine._horizon.state
    lens = torch.tensor([21, 0, 40, 9], dtype=torch.int32)
    hs.seq_lens.copy_(lens)
    hs.tokens.copy_(torch.tensor([5, 0, 77, 300]))
    hs.steps.copy_(torch.tensor([3, 0, 11, 1]))
    hs.tables.zero_()
    for r, first in enumerate((1, 0, 20, 40)):
        n = -(-(int(lens[r]) + 8) // 4)
        if lens[r]:
            hs.tables[r, :n] = torch.arange(first, first + n, dtype=torch.int32)
    active = lens > 0
    hs.active.copy_(active)
    hs.count_rows.copy_(active)
    hs.sample_rows.copy_(torch.tensor([False, False, True, False]))
    hs.seeds.copy_(torch.tensor([1, 2, 4294967295, 4]))
    hs.temps.copy_(torch.tensor([0.0, 0.0, 0.8, 0.0]))
    hs.top_ps.copy_(torch.tensor([1.0, 1.0, 0.9, 1.0]))
    hs.pres.copy_(torch.tensor([0.0, 0.0, 0.0, 0.5]))
    hs.reps.copy_(torch.tensor([1.0, 1.0, 1.0, 1.3]))
    engine.output_counts.copy_(torch.randint(0, 3, engine.output_counts.shape, generator=gen))
    engine.prompt_masks.copy_(torch.randint(0, 2, engine.prompt_masks.shape, generator=gen))


def _snapshot(engine):
    hs = engine._horizon.state
    caches = [t for c in engine.k_caches + engine.v_caches
              for t in ((c.data, c.scale) if hasattr(c, "scale") else (c,))]
    return [t.clone() for t in caches + [engine.output_counts, hs.carry.dev, hs.packed]]


def _restore(engine, snap):
    hs = engine._horizon.state
    caches = [t for c in engine.k_caches + engine.v_caches
              for t in ((c.data, c.scale) if hasattr(c, "scale") else (c,))]
    for t, s in zip(caches + [engine.output_counts, hs.carry.dev, hs.packed], snap):
        t.copy_(s)


def _raise(*a, **k):
    raise AssertionError("host round trip or host-to-device copy in the horizon body")


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_horizon_body_is_capture_safe(kv_dtype, monkeypatch):
    engine = _engine(kv_dtype=kv_dtype)
    try:
        _fill_state(engine)
        before = _snapshot(engine)
        hs = engine._horizon.state
        engine._decode_multi(hs, 64, True)
        want = _snapshot(engine)
        _restore(engine, before)
        with monkeypatch.context() as m:
            for name in ("tolist", "item", "__bool__", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, _raise)
            m.setattr(torch, "as_tensor", _raise)
            m.setattr(torch, "tensor", _raise)
            engine._decode_multi(hs, 64, True)
        got = _snapshot(engine)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # the carry moved on by the horizon: active rows by 4, others not
        assert hs.seq_lens.tolist() == [25, 0, 44, 13]
        assert hs.steps.tolist() == [7, 0, 15, 5]
        assert torch.equal(hs.tokens, hs.packed[-1, :, 0].long())
    finally:
        engine.stop()


# ------------------------------------------------------------- buckets
@pytest.mark.parametrize("split_keys,align", [(256, 16), (512, 16)])
def test_split_plan_is_the_same_at_every_bucket_above_the_need(split_keys, align):
    for seq_len in (1, 255, 256, 257, 1000, 4095):
        for q_len, window in ((1, 0), (1, 300), (7, 1024)):
            need = max(1, -(-seq_len // split_keys))
            want = att.split_plan(q_len, seq_len, window, split_keys, align, max_splits=need)
            for bucket in seq_len_buckets(8192, 256):
                if bucket >= seq_len:
                    S = max(1, -(-bucket // split_keys))
                    assert att.split_plan(q_len, seq_len, window, split_keys, align,
                                          max_splits=S) == want


def test_bucketed_max_seq_len_gives_the_same_split_decode():
    gen = torch.Generator().manual_seed(1)
    B, h, kvh, d, bs, nb = 3, 4, 2, 16, 16, 64
    kc, vc = torch.randn(nb, bs, kvh, d, generator=gen), torch.randn(nb, bs, kvh, d, generator=gen)
    q = torch.randn(B, h, d, generator=gen)
    lens = torch.tensor([700, 1, 300], dtype=torch.int32)
    tables = torch.randperm(nb - 1, generator=gen)[: B * 20].reshape(B, 20).int() + 1
    exact = att.split_paged_decode_attention(q, kc, vc, tables, lens, split_keys=256,
                                             max_splits=cuda_attention.split_extent(700))
    for bucket in (1024, 2048, 4096):
        got = att.split_paged_decode_attention(
            q, kc, vc, tables, lens, split_keys=256,
            max_splits=cuda_attention.split_extent(bucket))
        assert torch.equal(got, exact)


def test_seq_len_buckets():
    assert seq_len_buckets(4096, 256) == [256, 512, 1024, 2048, 4096]
    assert seq_len_buckets(3000, 256) == [256, 512, 1024, 2048, 3000]
    assert seq_len_buckets(256, 256) == [256]


# ----------------------------------------------------------- auto-tune
@pytest.mark.parametrize("rtt,steps,pipeline", [
    (50e-6, 8, 1),     # a local card: RTT far below a step
    (3e-3, 8, 2),      # 6 steps
    (10e-3, 32, 2),    # 20 steps
    (0.1, 64, 2),      # capped
])
def test_autotune_rule(monkeypatch, rtt, steps, pipeline):
    """t_step = weight bytes / copy rate = 1e9 / 2e12 = 0.5 ms."""
    monkeypatch.setattr(eng, "measure_device_rtt", lambda d, tries=3: rtt)
    monkeypatch.setattr(eng, "measure_copy_rate", lambda d: 2e12)
    monkeypatch.setattr(eng, "param_bytes", lambda p: 1e9)
    got, measured = eng.autotune_decode_schedule({}, torch.device("cpu"))
    assert got == (steps, pipeline)
    assert measured["rtt_s"] == rtt and measured["t_step_s"] == pytest.approx(5e-4)


def test_none_resolves_and_explicit_wins(monkeypatch):
    monkeypatch.setattr(eng, "measure_device_rtt", lambda d, tries=3: 0.05)
    e = _engine(decode_steps=None, decode_pipeline=None)
    try:
        assert e.cfg.decode_steps in (8, 16, 32, 64)
        assert e.cfg.decode_pipeline in (1, 2)
        assert e.schedule["rtt_s"] == 0.05 and e.schedule["copy_bytes_s"] > 0
    finally:
        e.stop()
    e2 = _engine(decode_steps=4, decode_pipeline=1)
    try:
        assert (e2.cfg.decode_steps, e2.cfg.decode_pipeline) == (4, 1)
        assert e2.schedule == {}
    finally:
        e2.stop()


def test_param_bytes_counts_every_tensor():
    params = {"a": torch.zeros(3, dtype=torch.float32),
              "layers": [{"w": torch.zeros(2, 2, dtype=torch.bfloat16)}] * 2}
    assert eng.param_bytes(params) == 12 + 2 * 8


# ----------------------------------------------------- launch counting
def test_replays_count_the_launches_their_capture_recorded():
    a, b = _build.LaunchCounter(), _build.LaunchCounter()
    a.launches = 5
    with _build.recording_launches() as rec:
        a.launches += 2
        b.launches += 3
    assert (a.launches, b.launches) == (5, 0)   # a capture launches nothing
    assert rec == {a: 2, b: 3}
    _build.add_replayed(rec, replays=4)
    assert (a.launches, a.replayed, b.launches, b.replayed) == (13, 8, 12, 12)


# --------------------------------------------------- Queue 3 repairs
def test_decode_scratch_is_keyed_by_stream_and_guarded_under_capture(monkeypatch):
    monkeypatch.setattr(cuda_attention, "_scratch", {})
    cpu = torch.device("cpu")
    counters, words = cuda_attention.scratch_words(8, 32, 8, 4096)
    assert counters == 64 and words == 8 + 8 * 32 * 16 * 130
    with pytest.raises(RuntimeError, match="reserve"):
        cuda_attention._scratch_for(cpu, 1, counters, words, capturing=True)
    a = cuda_attention._scratch_for(cpu, 1, counters, words)
    b = cuda_attention._scratch_for(cpu, 2, counters, words)
    assert a != b and set(cuda_attention._scratch) == {(cpu, 1), (cpu, 2)}
    # within the reserved size a capture reuses the buffer; past it, raises
    small = cuda_attention.scratch_words(4, 32, 8, 1024)
    assert cuda_attention._scratch_for(cpu, 1, *small, capturing=True) == a
    big = cuda_attention.scratch_words(8, 32, 8, 8192)
    with pytest.raises(RuntimeError, match="capture"):
        cuda_attention._scratch_for(cpu, 1, *big, capturing=True)
    assert cuda_attention._scratch_for(cpu, 1, *big) != a   # grown outside a capture


def test_layer_table_key_holds_the_dtype():
    """Caches at the same addresses and shapes but of another element size
    must not share a page-copy table (its page byte counts differ)."""
    shape = (4, 16, 2, 8)
    n = int(np.prod(shape))
    raw = torch.zeros(2 * n, dtype=torch.uint8)
    as_bf16 = raw.view(torch.bfloat16).reshape(shape)
    as_int8 = raw[:n].view(torch.int8).reshape(shape)
    assert as_bf16.data_ptr() == as_int8.data_ptr()
    k1 = bc.layer_table_key([[as_bf16, as_bf16]], gather=True)
    k2 = bc.layer_table_key([[as_int8, as_int8]], gather=True)
    assert k1 != k2
    assert k1 == bc.layer_table_key([[as_bf16, as_bf16]], gather=True)


@pytest.mark.parametrize("steps", [1, 4])
async def test_prefix_cache_does_not_serve_a_block_before_its_last_row(steps, monkeypatch):
    """A's token at length 28 (at 4 steps: the last of A's first horizon)
    seals block 6, whose last row the next step writes. B (A's first 28
    tokens and 5 of its own) arrives right then, and with the mixed step's
    page booking forced to fail its prefill runs before that step. B must
    stream what it streams where its prompt cannot hit the cache: its
    prefix match stops at the written blocks."""
    prompt_a = list(range(100, 123))   # its first output token: length 24
    extra = [7, 8, 9, 10, 11]

    async def free_run(tokens, max_tokens):
        e = _engine(decode_steps=steps)
        try:
            return await _collect(e, tokens, max_tokens)
        finally:
            e.stop()

    a_free = await free_run(prompt_a, 16)
    prompt_b = (prompt_a + a_free["tokens"])[:28] + extra
    want = await free_run(prompt_b, 6)

    e = _engine(decode_steps=steps)
    book = e._book_decode_blocks
    inject = {}

    def book_failing_while_b_prefills(seqs, extra_tokens):
        b = inject.get("seq")
        if b is not None and not b.prefilled:
            return False
        return book(seqs, extra_tokens)

    def reap():
        reap_orig()
        a = next((s for s in e._slots if s is not None and s.req.request_id == "a"), None)
        if "seq" not in inject and a is not None and len(a.seq) >= 28:
            assert len(a.seq) == 28
            req = PreprocessedRequest(request_id="b", model="m", token_ids=prompt_b,
                                      stop=StopConditions(max_tokens=6),
                                      sampling=SamplingOptions(temperature=0.0, logprobs=1))
            st = _Seq(req=req, context=Context(), out_queue=asyncio.Queue(),
                      seq=TokenBlockSequence(prompt_b, 4), last_token=prompt_b[-1])
            inject["seq"] = st
            e._waiting.append(st)

    reap_orig = e._reap_finished
    monkeypatch.setattr(e, "_book_decode_blocks", book_failing_while_b_prefills)
    monkeypatch.setattr(e, "_reap_finished", reap)
    try:
        a = await _collect(e, prompt_a, 16)
        got = {"tokens": [], "logprobs": [], "cached": None}
        st = inject["seq"]
        while True:
            out = await st.out_queue.get()
            got["tokens"].extend(out.token_ids)
            got["logprobs"].extend(out.logprobs or [])
            got["cached"] = (out.annotations or {}).get("cached_tokens", got["cached"])
            if out.finish_reason is not None:
                break
    finally:
        e.stop()
    assert a["tokens"] == a_free["tokens"]
    assert 0 < got["cached"] < 28       # the unwritten block 6 was not served
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], rtol=0, atol=1e-4)


async def _collect(engine, tokens, max_tokens):
    req = PreprocessedRequest(request_id="a", model="m", token_ids=list(tokens),
                              stop=StopConditions(max_tokens=max_tokens),
                              sampling=SamplingOptions(temperature=0.0, logprobs=1))
    out = {"tokens": [], "logprobs": []}
    async for item in engine.generate(req, Context()):
        out["tokens"].extend(item.token_ids)
        out["logprobs"].extend(item.logprobs or [])
    return out
