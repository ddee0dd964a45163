"""Speculative decoding beyond the dense llama family, on the CPU, float32.

The reference runs spec decoding with a main of any family
(tests/test_spec_decode.py::_spec_matches_family_main: MLA and Gemma) and
builds its draft with the draft config's own family
(``registry.forward_fn(dcfg)``). The port's verify takes each layer's
attention attributes (Gemma's windows and softcap, gpt-oss's windows and
sinks) on the unified kernel's ``q_len = k + 1`` rows, or the latent
kernel's for MLA; a Gemma draft's steps take its attributes on the
unified kernel's ``q_len = 1`` rows. Held here:

- spec streams with tiny Gemma 3, gpt-oss, Qwen3-MoE and MLA mains (a dense
  llama draft), and with Gemma and Qwen3-MoE drafts on a llama main, equal
  the same main's plain greedy streams (the port's one-step engine, which
  each family's test file holds to ``TpuEngine``);
- Gemma and MLA mains against the reference's spec engine on
  ``_spec_matches_family_main``'s configuration (float32 weights from the
  JAX package's ``init_params`` through numpy, the draft's weights carried
  across): the same greedy stream;
- a perfect Gemma draft (the main's own weights) accepts 1.0;
- the spec body with a Gemma and with an MLA main makes no host round
  trip and equals its unpatched run bit for bit.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gemma as tg
import test_torch_gptoss as tgo
import test_torch_mla as tm
import test_torch_moe as tmo
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import gemma as tgemma
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.runtime import Context

# the reference's spec test configuration (tests/test_spec_decode.py)
ENGINE = dict(num_blocks=256, block_size=4, max_batch_size=2, max_context=512,
              prefill_buckets=(16, 32, 64), decode_steps=6, decode_pipeline=2)
SPEC_K = 3
LLAMA = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
DRAFT = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=1,
             head_dim=16, intermediate_size=64)
PROMPTS = [[(i * 37 + 11) % 500 for i in range(9)], [(i * 13 + 5) % 500 for i in range(21)]]
N = 12


@functools.lru_cache(maxsize=None)
def _main(name):
    """(JAX config, port config, numpy weights) of a tiny main model."""
    if name == "gemma3":
        jcfg, tcfg = tg._configs("tiny_gemma3")
        return jcfg, tcfg, tg._numpy_params(jcfg, seed=31)
    if name == "gptoss":
        jcfg, tcfg = tgo._configs()
        return jcfg, tcfg, tgo._numpy_params(jcfg, seed=32)
    if name == "moe":
        jcfg, tcfg = tmo._configs(qk_norm=True)
        return jcfg, tcfg, tmo._numpy_params(jcfg, seed=33)
    if name == "mla":
        jcfg, tcfg = tm._configs("tiny_mla")
        return jcfg, tcfg, tm._numpy_params(jcfg, seed=34)
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **LLAMA)
    return (jcfg, tllama.LlamaConfig(dtype=torch.float32, **LLAMA),
            jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(35), jcfg)))


def _draft(name):
    if name == "gemma3":
        return tgemma.GemmaConfig.tiny_gemma3(num_layers=2)
    if name == "moe":
        return tmoe.MoeConfig.tiny_moe(num_layers=1)
    return tllama.LlamaConfig(dtype=torch.float32, **DRAFT)


def _req(cls, rid, tokens, n=N):
    return cls[0](request_id=rid, model="m", token_ids=list(tokens),
                  stop=cls[2](max_tokens=n, ignore_eos=True),
                  sampling=cls[1](temperature=0.0))


TORCH_REQ = (PreprocessedRequest, SamplingOptions, StopConditions)
JAX_REQ = (JRequest, JSampling, JStop)


async def _collect(engine, req, ctx):
    return [t async for out in engine.generate(req, ctx) for t in out.token_ids]


@functools.lru_cache(maxsize=None)
def _plain_streams(name):
    """The port's plain engine's greedy streams of PROMPTS, one at a time,
    on main ``name`` (one eager step a tick; each family's test file holds
    these streams to TpuEngine's)."""
    _, tcfg, tree = _main(name)
    engine = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", **{
        **ENGINE, "decode_steps": 1, "decode_pipeline": 1}),
        params=params_from_numpy(tree, tcfg, device="cpu"))

    async def main():
        try:
            return [await _collect(engine, _req(TORCH_REQ, f"r{i}", p), Context())
                    for i, p in enumerate(PROMPTS)]
        finally:
            engine.stop()

    return asyncio.run(main())


def _spec_engine(tcfg, tree, draft, draft_params=None, **kw):
    return TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", spec_draft=draft,
                                         spec_k=SPEC_K, **{**ENGINE, **kw}),
                       params=params_from_numpy(tree, tcfg, device="cpu"),
                       draft_params=draft_params)


def _spec_streams(engine, prompts=PROMPTS):
    """The prompts served together (mixed steps, spec horizons)."""
    async def main():
        try:
            return await asyncio.gather(*(_collect(engine, _req(TORCH_REQ, f"s{i}", p),
                                                   Context())
                                          for i, p in enumerate(prompts)))
        finally:
            engine.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("main,draft", [("gemma3", "llama"), ("gptoss", "llama"),
                                        ("moe", "llama"), ("mla", "llama"),
                                        ("llama", "gemma3"), ("llama", "moe")])
def test_spec_streams_equal_the_plain_greedy_streams(main, draft):
    _, tcfg, tree = _main(main)
    want = _plain_streams(main)
    engine = _spec_engine(tcfg, tree, _draft(draft))
    got = _spec_streams(engine)
    assert got == want
    assert engine.step_counts["spec"] > 0 and engine.spec_stats["rounds"] > 0
    assert 0.0 < engine.spec_acceptance() <= 1.0


@pytest.mark.parametrize("main", ["gemma3", "mla"])
def test_spec_engine_matches_the_reference_spec_engine(main):
    """The reference's _spec_matches_family_main: its spec engine (a dense
    llama draft from its own seed) and the port's with the same draft
    weights stream the same tokens, both through spec rounds."""
    jcfg, tcfg, tree = _main(main)
    jdraft = jllama.LlamaConfig(dtype=jnp.float32, **DRAFT)

    async def reference():
        e = TpuEngine(TpuEngineConfig(model=jcfg, spec_k=SPEC_K, spec_draft=jdraft,
                                      **ENGINE),
                      params=jax.tree.map(jnp.asarray, tree),
                      mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        try:
            toks = await _collect(e, _req(JAX_REQ, "spec", PROMPTS[0]), JContext())
            return toks, e.spec_stats["rounds"], jax.tree.map(np.asarray, e.draft_params)
        finally:
            e.stop()

    want, rounds, draft_tree = asyncio.run(reference())
    dcfg = _draft("llama")
    engine = _spec_engine(tcfg, tree, dcfg,
                          draft_params=params_from_numpy(draft_tree, dcfg, device="cpu"))
    (got,) = _spec_streams(engine, PROMPTS[:1])
    assert rounds > 0 and engine.spec_stats["rounds"] > 0
    assert got == want


def test_perfect_gemma_draft_accepts_everything():
    _, tcfg, tree = _main("gemma3")
    want = _plain_streams("gemma3")
    engine = _spec_engine(tcfg, tree, tcfg)
    engine.draft_params = engine.params
    got = _spec_streams(engine)
    assert got == want
    assert engine.spec_stats["rounds"] > 0
    assert engine.spec_acceptance() == 1.0


# ------------------------------------------------ the body, on the device
def _fill(engine):
    """Random main and draft caches and a spec state with one of two rows
    active."""
    gen = torch.Generator().manual_seed(0)
    for c in engine.k_caches + engine.v_caches + engine.draft_k_caches + engine.draft_v_caches:
        c.copy_(torch.randn(c.shape, generator=gen))
    hs = engine._horizon.state
    lens = torch.tensor([21, 0], dtype=torch.int32)
    hs.seq_lens.copy_(lens)
    hs.tokens.copy_(torch.tensor([5, 0]))
    hs.steps.copy_(torch.tensor([3, 0]))
    hs.tables.zero_()
    hs.tables[0, :9] = torch.arange(3, 12, dtype=torch.int32)
    hs.active.copy_(lens > 0)


def _raise(*a, **k):
    raise AssertionError("host round trip or host-to-device copy in the spec body")


def _memo(fn):
    """``fn`` with its results kept: Gemma's ``_rounded`` turns a Python
    float into the model dtype's nearest value through a CPU scalar, a
    host constant that touches no device; the patched run reads the
    values the unpatched one computed."""
    return functools.lru_cache(maxsize=None)(fn)


@pytest.mark.parametrize("main", ["gemma3", "mla"])
def test_spec_body_is_capture_safe(main, monkeypatch):
    """The spec body of a Gemma main (the verify with each layer's window
    and softcap) and of an MLA main (the latent verify) makes no host read
    and no host-to-device copy, and equals its unpatched run bit for bit."""
    _, tcfg, tree = _main(main)
    monkeypatch.setattr(tgemma, "_rounded", _memo(tgemma._rounded))
    e = _spec_engine(tcfg, tree, _draft("llama"))
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
        adv = int(hs.spec_packed[:, 0, 0].sum())
        assert 1 <= adv <= 6 and hs.seq_lens.tolist() == [21 + adv, 0]
    finally:
        e.stop()
