"""Speculative decoding in the port (TorchEngine ``spec_draft``), on the
CPU: the draft's steps and the verify run the plain versions of the
decode kernel and of the unified kernel's verify rows.

The invariant is the reference's (tests/test_spec_decode.py): a spec
engine streams exactly the plain engine's greedy tokens; the draft only
moves the acceptance rate. A JAX spec engine takes minutes to compile
here, so the port is held to the plain TpuEngine's greedy streams on the
same float32 weights. Also: the perfect draft (the main weights) accepts
everything; chunked prefill with a prefix-cache hit; a late arrival
through the fused mixed step; a sampled row sending the dispatch to the
normal horizon; an int8 main cache; the construction gates; the spec body
with no host round trip; spec horizons chained on normal ones; and the
split bounds the body hands its kernels.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.gemma import GemmaConfig
from dynamo_tpu_torch.models.gptoss import GptOssConfig
from dynamo_tpu_torch.models.vision import VisionConfig
from dynamo_tpu_torch.ops import cuda_attention, cuda_unified
from dynamo_tpu_torch.ops.quant import QuantizedKV
from dynamo_tpu_torch.runtime import Context

MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=128)
# an unrelated draft: smaller, its own random weights (seed + 2)
DRAFT = tllama.LlamaConfig(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2,
                           num_kv_heads=1, head_dim=16, intermediate_size=64,
                           dtype=torch.float32)
MAIN = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
ENGINE = dict(num_blocks=256, block_size=4, max_batch_size=4, max_context=512,
              prefill_buckets=(16, 32, 64), decode_steps=6, decode_pipeline=2, spec_k=3)
PROMPTS = [
    [(i * 37 + 11) % 500 for i in range(9)],
    [(i * 13 + 5) % 500 for i in range(21)],
    [(i * 7 + 3) % 500 for i in range(14)],
]
LONG = [(i * 37 + 11) % 500 for i in range(150)]     # chunked at buckets (16, 32)
LATE = [(i * 53 + 7) % 500 for i in range(90)]
N = 24


def _req(cls_req, cls_samp, cls_stop, rid, tokens, n=N, **samp):
    return cls_req(request_id=rid, model="m", token_ids=list(tokens),
                   stop=cls_stop(max_tokens=n, ignore_eos=True),
                   sampling=cls_samp(temperature=samp.pop("temperature", 0.0), **samp))


async def _collect(engine, req, ctx):
    toks, cached = [], None
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if "cached_tokens" in (out.annotations or {}):
            cached = out.annotations["cached_tokens"]
    return toks, cached


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, the port's params): the port's tensors are
    shared by every engine of the module (no engine writes its weights)."""
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **MODEL)
    jparams = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), MAIN,
                                            device="cpu")


@pytest.fixture(scope="module")
def reference(weights):
    """The plain TpuEngine's greedy streams of every prompt here."""
    jcfg, jparams, _ = weights

    async def main():
        e = TpuEngine(TpuEngineConfig(model=jcfg, use_pallas=False, decode_steps=1,
                                      decode_pipeline=1, num_blocks=256, block_size=4,
                                      max_batch_size=4, max_context=512,
                                      prefill_buckets=(16, 32, 64)),
                      params=jparams, mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        try:
            out = {}
            for name, p, n in [(f"p{i}", p, N) for i, p in enumerate(PROMPTS)] + [
                    ("long", LONG, 12), ("late", LATE, 8)]:
                out[name], _ = await _collect(
                    e, _req(JRequest, JSampling, JStop, name, p, n), JContext())
            return out
        finally:
            e.stop()

    return asyncio.run(main())


def _engine(weights, spec=DRAFT, draft_params=None, **kw):
    _, _, params = weights
    cfg = TorchEngineConfig(model=MAIN, device="cpu", spec_draft=spec, **{**ENGINE, **kw})
    return TorchEngine(cfg, params=params, draft_params=draft_params)


def _preq(rid, tokens, n=N, **samp):
    return _req(PreprocessedRequest, SamplingOptions, StopConditions, rid, tokens, n, **samp)


def test_unrelated_draft_streams_the_plain_greedy_tokens(weights, reference):
    async def main():
        e = _engine(weights)
        try:
            got = await asyncio.gather(*(_collect(e, _preq(f"s{i}", p), Context())
                                         for i, p in enumerate(PROMPTS)))
            return [t for t, _ in got], e
        finally:
            e.stop()

    got, e = asyncio.run(main())
    assert got == [reference[f"p{i}"] for i in range(3)]
    assert e.spec_stats["rounds"] > 0 and e.step_counts["spec"] > 0
    assert 0.0 < e.spec_acceptance() <= 1.0


def test_perfect_draft_accepts_everything(weights, reference):
    """draft = main (same config, same weights, its own shadow cache):
    every round advances the full k, and the tokens are still the plain
    ones. The prompts arrive together, so decode rows also ride mixed
    steps, which write the draft's KV of their tokens too."""
    async def main():
        e = _engine(weights, spec=MAIN)
        e.draft_params = e.params
        try:
            got = await asyncio.gather(*(_collect(e, _preq(f"p{i}", p), Context())
                                         for i, p in enumerate(PROMPTS)))
            assert e.step_counts["mixed"] > 0
            return [t for t, _ in got], e
        finally:
            e.stop()

    got, e = asyncio.run(main())
    assert got == [reference[f"p{i}"] for i in range(3)]
    assert e.spec_stats["rounds"] > 0
    assert e.spec_acceptance() == 1.0


def test_chunked_prefill_and_a_prefix_cache_hit(weights, reference):
    """150 prompt tokens over buckets of at most 32: five chunks, the
    draft cache following each; the repeat hits the prefix cache and the
    draft prefills the cached region from the token ids."""
    async def main():
        e = _engine(weights, prefill_buckets=(16, 32))
        try:
            first = await _collect(e, _preq("a", LONG, 12), Context())
            again = await _collect(e, _preq("b", LONG, 12), Context())
            return first, again, e
        finally:
            e.stop()

    (first, c0), (again, c1), e = asyncio.run(main())
    assert first == again == reference["long"]
    assert c0 == 0 and c1 > 0
    assert e.spec_stats["rounds"] > 0


def test_late_arrival_rides_the_mixed_step(weights, reference):
    """A prompt arriving while a request decodes is prefilled by fused
    mixed steps (draft prefill catch-up included); the streams equal a run
    with the mixed step off, and the plain engine's."""
    async def run(mixed):
        e = _engine(weights, prefill_buckets=(16, 32))
        e.mixed_enabled = mixed
        first = asyncio.Event()

        async def one(rid, tokens, n):
            toks = []
            async for out in e.generate(_preq(rid, tokens, n), Context()):
                toks.extend(out.token_ids)
                if toks:
                    first.set()
            return toks

        try:
            lead = asyncio.ensure_future(one("a", PROMPTS[0], N))
            await first.wait()
            late = await one("b", LATE, 8)
            return [await lead, late], e
        finally:
            e.stop()

    got_m, e_m = asyncio.run(run(True))
    got_s, e_s = asyncio.run(run(False))
    assert e_m.step_counts["mixed"] > 0 and e_s.step_counts["mixed"] == 0
    assert got_m == got_s == [reference["p0"], reference["late"]]
    assert e_m.spec_stats["rounds"] > 0


def test_a_sampled_row_sends_the_dispatch_to_the_normal_horizon(weights, reference):
    async def main():
        e = _engine(weights)
        seen = []
        dispatch = e._dispatch_horizon

        def spy(chain, seqs):
            out = dispatch(chain, seqs)
            seen.append((out.spec, any(s is not None and s.req.sampling.temperature > 0
                                       for s in seqs)))
            return out

        e._dispatch_horizon = spy
        try:
            greedy, _ = await asyncio.gather(
                _collect(e, _preq("g", PROMPTS[0]), Context()),
                _collect(e, _preq("t", PROMPTS[2], N + 12, temperature=0.8, seed=3),
                         Context()))
            return greedy[0], e, seen
        finally:
            e.stop()

    greedy, e, seen = asyncio.run(main())
    assert greedy == reference["p0"]
    assert e.step_counts["horizon"] > 0
    assert (False, True) in seen and (True, True) not in seen


def test_int8_main_cache(weights):
    """An int8 main cache with a model-dtype shadow cache. The verify
    writes the k + 1 candidates of a round before it attends, and each int8
    write grows its block's scale and requantizes the block, so the pages
    a candidate attends over are those of a plain step only up to that
    rescaling: the spec stream is held to the plain int8 engine's on this
    model (float32, logit margins far above the rescale's rounding). The
    main weights as the draft are no longer perfect: the draft reads its
    float cache, the verify the int8 one, so a near-tie may part them."""
    async def main():
        plain = _engine(weights, spec=None, kv_dtype="int8")
        spec = _engine(weights, spec=MAIN, kv_dtype="int8")
        spec.draft_params = spec.params
        async def one_by_one(engine, rid):
            return [(await _collect(engine, _preq(f"{rid}{i}", p), Context()))[0]
                    for i, p in enumerate(PROMPTS)]

        try:
            # the two engines side by side, each serving one request at a time
            want, got = await asyncio.gather(one_by_one(plain, "r"), one_by_one(spec, "s"))
            return want, got, spec
        finally:
            plain.stop()
            spec.stop()

    want, got, spec = asyncio.run(main())
    assert isinstance(spec.k_caches[0], QuantizedKV)
    assert spec.draft_k_caches[0].dtype == torch.float32
    assert got == want
    assert 0.9 <= spec.spec_acceptance() <= 1.0


def _refused(match, **kw):
    with pytest.raises(ValueError, match=match):
        TorchEngine(TorchEngineConfig(**{"model": MAIN, "device": "cpu", **ENGINE, **kw}))


def test_construction_gates():
    gemma = GemmaConfig.tiny_gemma3(vocab_size=512)
    # a Gemma main and a Gemma draft are served (the reference runs both);
    # gpt-oss and MLA drafts are not
    engine_mod._check_features(TorchEngineConfig(model=gemma, spec_draft=DRAFT, device="cpu"))
    engine_mod._check_features(TorchEngineConfig(model=MAIN, spec_draft=gemma, device="cpu"))
    _refused("gptoss draft model is not served.*ROADMAP",
             spec_draft=GptOssConfig.tiny_gptoss(vocab_size=512))
    _refused("share a vocabulary.*ROADMAP",
             spec_draft=dataclasses.replace(DRAFT, vocab_size=256))
    _refused("vision with a spec_draft.*ROADMAP", spec_draft=DRAFT,
             vision=VisionConfig.tiny(out_hidden_size=64, dtype=torch.float32))
    # the decode kernel takes head_dim 64 and 128: a d-64 draft of an 8B
    # main is served on the card, a d-16 one refused before any device is
    # touched (device None = cuda)
    main = dataclasses.replace(MAIN, num_heads=32, num_kv_heads=8, head_dim=128)
    engine_mod._check_features(TorchEngineConfig(
        model=main, spec_draft=dataclasses.replace(DRAFT, head_dim=64)))
    _refused("draft model's 2 heads over 1 kv heads at head_dim 16.*ROADMAP", model=main,
             spec_draft=DRAFT, device=None)
    e = TorchEngine(TorchEngineConfig(model=MAIN, device="cpu", spec_draft=DRAFT,
                                      **{**ENGINE, "decode_steps": 2, "spec_k": 5}))
    try:
        assert e.cfg.spec_k == 2 and e._spec_rounds == 1
    finally:
        e.stop()


# ------------------------------------------------ the body, on the device
def _fill(engine):
    """Random main and draft caches and a spec state with three of four
    rows active on distinct pages."""
    gen = torch.Generator().manual_seed(0)
    for c in engine.k_caches + engine.v_caches + engine.draft_k_caches + engine.draft_v_caches:
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
    hs.active.copy_(lens > 0)


def _raise(*a, **k):
    raise AssertionError("host round trip or host-to-device copy in the spec body")


def test_spec_body_is_capture_safe(weights, monkeypatch):
    """The spec body makes no host read and no host-to-device copy (what a
    CUDA-graph capture needs), and equals its unpatched run bit for bit;
    its carry moves by each row's advance and its packed rows hold it."""
    e = _engine(weights)
    try:
        _fill(e)
        hs = e._horizon.state
        arrays = lambda: [t.clone() for t in e.k_caches + e.v_caches + e.draft_k_caches
                          + e.draft_v_caches + [hs.carry.dev, hs.spec_packed]]
        before = arrays()
        e._spec_multi(hs, 64)
        want = arrays()
        for t, s in zip(e.k_caches + e.v_caches + e.draft_k_caches + e.draft_v_caches
                        + [hs.carry.dev, hs.spec_packed], before):
            t.copy_(s)
        with monkeypatch.context() as m:
            for name in ("tolist", "item", "__bool__", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, _raise)
            m.setattr(torch, "as_tensor", _raise)
            m.setattr(torch, "tensor", _raise)
            e._spec_multi(hs, 64)
        for g, w in zip(arrays(), want):
            assert torch.equal(g, w)
        adv = hs.spec_packed[:, :, 0].sum(dim=0).to(torch.int32)     # [B]
        assert adv.tolist()[1] == 0 and all(1 <= a <= 6 for a in adv.tolist()[::2])
        assert hs.seq_lens.tolist() == [21 + adv[0], 0, 40 + adv[2], 9 + adv[3]]
        assert hs.steps.tolist() == [3 + adv[0], 0, 11 + adv[2], 1 + adv[3]]
        last = hs.spec_packed[-1]
        k = e.cfg.spec_k
        for r in (0, 2, 3):   # the carry is the last round's m[adv - 1]
            a = int(last[r, 0])
            assert int(hs.tokens[r]) == int(last[r, a])
    finally:
        e.stop()


def test_spec_horizons_chain_on_normal_ones(weights):
    """Two horizons in flight: when a sampled request finishes, the next
    dispatch turns spec-eligible and chains on the normal horizon's device
    carry. Every stream equals the port's one-step stream."""
    prompts = [PROMPTS[0], PROMPTS[1], PROMPTS[2]]
    lens = (40, 40, 7)

    async def run(e):
        chains = []
        dispatch = e._dispatch_horizon

        def spy(chain, seqs):
            out = dispatch(chain, seqs)
            chains.append((None if chain is None else chain.spec, out.spec))
            return out

        e._dispatch_horizon = spy
        try:
            got = await asyncio.gather(*(
                _collect(e, _preq(f"c{i}", p, n, **({"temperature": 0.7, "seed": 1}
                                                     if i == 2 else {})), Context())
                for i, (p, n) in enumerate(zip(prompts, lens))))
            return [t for t, _ in got], chains
        finally:
            e.stop()

    one_step, _ = asyncio.run(run(_engine(weights, spec=None, decode_steps=1,
                                          decode_pipeline=1)))
    got, chains = asyncio.run(run(_engine(weights)))
    assert got == one_step
    assert (False, True) in chains, chains


def test_the_body_bounds_its_kernels_splits(weights, monkeypatch):
    """The host bound the spec body hands the decode kernel (draft steps)
    and the verify rows covers every row's length, in chained dispatches
    too (``lens_after`` = lens + rounds * k)."""
    seen = []

    def dec_spy(q, kc, vc, tables, lens, max_seq_len=None):
        seen.append(("draft", int(lens.max()), max_seq_len))
        return dec(q, kc, vc, tables, lens, max_seq_len=max_seq_len)

    def ver_spy(q, kc, vc, tables, total, active, max_seq_len=None):
        seen.append(("verify", int(total[active].max()), max_seq_len))
        return ver(q, kc, vc, tables, total, active, max_seq_len=max_seq_len)

    dec, ver = cuda_attention.paged_decode_attention, cuda_unified.verify_attention
    monkeypatch.setattr(cuda_attention, "paged_decode_attention", dec_spy)
    monkeypatch.setattr(cuda_unified, "verify_attention", ver_spy)

    async def main():
        e = _engine(weights, spec=MAIN)
        e.draft_params = e.params
        try:
            await asyncio.gather(*(_collect(e, _preq(f"b{i}", p, 40), Context())
                                   for i, p in enumerate(PROMPTS)))
            return e
        finally:
            e.stop()

    e = asyncio.run(main())
    assert e.step_counts["spec"] > 1
    assert {kind for kind, _, _ in seen} == {"draft", "verify"}
    assert all(bound is not None and need <= bound for _, need, bound in seen), seen
