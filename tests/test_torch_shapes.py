"""The attention shapes of Qwen2.5 and Llama-3.2 in the port: group sizes
(query heads per kv head) 3, 5, 6 and 7 and head_dim 64.

- The plain versions of the three attention kernels (decode, flash-extend,
  unified ragged) at G in {3, 5, 6, 7} x d in {64, 128}, on float32, held
  to ``dynamo_tpu/ops/attention.py`` within REF_TOL, and at G 7 to the
  reference's Pallas kernels in interpret mode within KERNEL_TOL (the
  Pallas kernels run any G; the CUDA kernels' rows past a tile's
  ``64 // G * G`` are the padding these shapes bring, which only the card
  can check: chip_smoke.py phase ``shapes``).
- Greedy streams of ``TorchEngine(device="cpu")`` at tiny widths with G 7
  and with d 64 equal ``TpuEngine``'s on the same weights.
- ``_check_features`` on ``device="cuda"`` accepts the published shapes the
  card's kernels now take and refuses d 16, d 96 and G 9, naming ROADMAP.
"""

import asyncio

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
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import pallas_prefill as pf
from dynamo_tpu.ops import pallas_unified as pun
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
from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified
from dynamo_tpu_torch.runtime import Context

REF_TOL = 2e-5      # float32 plain op vs float32 JAX reference
KERNEL_TOL = 5e-5   # plain version vs Pallas interpret (other summation order)
SHAPES = [(g, d) for g in (3, 5, 6, 7) for d in (64, 128)]
KVH, BS = 2, 16
# the reference's plain ops, jitted (one compile a shape: op-by-op dispatch
# takes several times as long here)
J_DECODE = jax.jit(jatt.paged_decode_attention)
J_EXTEND = jax.jit(jatt.extend_attention)
J_RAGGED = jax.jit(jatt.ragged_paged_attention)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _paged(rng, lens, h, d, num_blocks=24, max_blocks=4):
    """q [B, h, d] and a paged cache with each row on its own scrambled
    pages; table padding points at scratch block 0."""
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    kc = rng.standard_normal((num_blocks, BS, KVH, d)).astype(np.float32)
    vc = rng.standard_normal((num_blocks, BS, KVH, d)).astype(np.float32)
    tables = np.zeros((len(lens), max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for b, n in enumerate(lens):
        for j in range(-(-n // BS)):
            tables[b, j] = free.pop()
    return q, kc, vc, tables, np.asarray(lens, np.int32)


def _decode_args(g, d):
    return _paged(np.random.default_rng(100 * g + d), [1, 17, 40, 64], KVH * g, d)


def _extend_args(g, d):
    """A 20-token chunk at position 30 over a 64-key context of which 50
    are valid: 20 // (64 // G) q tiles with a ragged last one on the card."""
    rng = np.random.default_rng(200 * g + d)
    q = rng.standard_normal((20, KVH * g, d)).astype(np.float32)
    k = rng.standard_normal((64, KVH, d)).astype(np.float32)
    v = rng.standard_normal((64, KVH, d)).astype(np.float32)
    return q, k, v, 30, 50


def _ragged_args(g, d):
    """A 13-token segment over a 40-token context, decode rows, an empty
    row, a one-token context; 3 padding tokens between segments."""
    rows = [(13, 40), (1, 33), (0, 9), (1, 1), (2, 21)]
    rng = np.random.default_rng(300 * g + d)
    _, kc, vc, tables, lens = _paged(rng, [sl for _, sl in rows], KVH * g, d)
    starts, pos = [], 0
    for ql, _ in rows:
        starts.append(pos)
        pos += ql + 3
    q = rng.standard_normal((pos, KVH * g, d)).astype(np.float32)
    return (q, kc, vc, tables, np.asarray(starts, np.int32),
            np.asarray([ql for ql, _ in rows], np.int32), lens)


@pytest.mark.parametrize("g,d", SHAPES)
def test_plain_decode_matches_jax(g, d):
    args = _decode_args(g, d)
    want = J_DECODE(*map(jnp.asarray, args))
    got = cuda_attention.paged_decode_attention(*map(_t, args))
    assert got.shape == (4, KVH * g, d)
    _close(got, want, REF_TOL)


@pytest.mark.parametrize("g,d", SHAPES)
def test_plain_flash_extend_matches_jax(g, d):
    q, k, v, start, total = _extend_args(g, d)
    pos = np.arange(start, start + q.shape[0], dtype=np.int32)
    want = J_EXTEND(*map(jnp.asarray, (q, k, v, pos)), total)
    got = cuda_prefill.flash_extend_attention(_t(q), _t(k), _t(v), start, total)
    _close(got, want, REF_TOL)


@pytest.mark.parametrize("g,d", SHAPES)
def test_plain_ragged_matches_jax(g, d):
    args = _ragged_args(g, d)
    want = J_RAGGED(*map(jnp.asarray, args))
    got = cuda_unified.ragged_paged_attention(*map(_t, args))
    _close(got, want, REF_TOL)
    assert not got[13:16].any(), "padding tokens between segments read back zero"


@pytest.mark.parametrize("d", [64, 128])
def test_plain_versions_match_pallas_interpret_at_group_size_7(d):
    """The three plain versions against the reference's Pallas kernels in
    interpret mode at Qwen2.5's G 7."""
    args = _decode_args(7, d)
    want = pa.paged_decode_attention(*map(jnp.asarray, args), chunk_tokens=16,
                                     interpret=True)
    _close(cuda_attention.paged_decode_attention(*map(_t, args)), want, KERNEL_TOL)
    q, k, v, start, total = _extend_args(7, d)
    qp = np.zeros((64,) + q.shape[1:], np.float32)   # the kernel's q tile multiple
    qp[:q.shape[0]] = q
    want = pf.flash_extend_attention(
        jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v),
        jnp.arange(start, start + 64, dtype=jnp.int32), jnp.int32(total),
        q_tile=64, kv_tile=64, interpret=True)[:q.shape[0]]
    _close(cuda_prefill.flash_extend_attention(_t(q), _t(k), _t(v), start, total), want,
           KERNEL_TOL)
    args = _ragged_args(7, d)
    want = pun.ragged_paged_attention(*map(jnp.asarray, args), q_seg=4, chunk_tokens=16,
                                      interpret=True)
    _close(cuda_unified.ragged_paged_attention(*map(_t, args)), want, KERNEL_TOL)


def test_kernel_forms_the_wrappers_state():
    for g, d in SHAPES + [(1, 64), (8, 128)]:
        assert cuda_attention.supports(KVH * g, KVH, d)
        assert cuda_prefill.supports(KVH * g, KVH, d)
    for h, kvh, d in ((18, 2, 128), (32, 2, 128), (8, 2, 96), (8, 2, 16), (8, 2, 256)):
        assert not cuda_attention.supports(h, kvh, d)
    assert cuda_prefill.supports(64, 1, 128) and not cuda_prefill.supports(65, 1, 128)
    assert not cuda_prefill.supports(8, 2, 256) and not cuda_prefill.supports(7, 2, 64)
    # the unified kernel's split rows at G 7: one tile of 64 // 7 = 9 tokens
    assert cuda_unified.split_shape(14, 2, 5, 4096) == (8, 5)
    assert cuda_unified.split_shape(14, 2, 64, 4096) == (8, 9)


def test_reserves_of_two_shapes_cover_both(monkeypatch):
    """A Qwen3-30B-A3B main (32 heads over 4) and a qwen3-0.6b draft (16
    over 8) reserve the decode scratch in turn before a capture: the
    draft's reserve (more counters, fewer words) keeps the main's words,
    so neither's launch grows the buffer under the capture."""
    monkeypatch.setattr(cuda_attention, "_scratch", {})
    cpu = torch.device("cpu")
    main = cuda_attention.scratch_words(8, 32, 4, 4096, 128)
    draft = cuda_attention.scratch_words(8, 16, 8, 4096, 128)
    assert main[0] < draft[0] and main[1] > draft[1]
    cuda_attention.reserve(cpu, 8, 32, 4, 4096, 128)
    cuda_attention.reserve(cpu, 8, 16, 8, 4096, 128)
    for need in (main, draft):
        cuda_attention._scratch_for(cpu, 0, *need, capturing=True)


# ------------------------------------------------------------ engines
ENGINE = dict(num_blocks=96, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64), seed=0)
ENGINE_SHAPES = {
    # Qwen2.5-0.5B's attention (14 heads over 2, G 7) at d 64, with its bias
    "g7_d64": dict(num_heads=14, num_kv_heads=2, head_dim=64, hidden_size=64,
                   qkv_bias=True),
    # Qwen2.5-7B's G 7 at d 128, cut to 7 over 1
    "g7_d128": dict(num_heads=7, num_kv_heads=1, head_dim=128, hidden_size=64),
}
PROMPTS = {"chunked": ([(i * 29 + 3) % 250 for i in range(70)], 6),
           "a": ([(i * 13 + 5) % 250 for i in range(21)], 10),
           "b": ([(i * 7 + 1) % 250 for i in range(40)], 12)}


async def _serve(engine, cls, ctx):
    """The chunked prompt alone, then two prompts together (mixed steps)."""
    async def one(name):
        tokens, n = PROMPTS[name]
        req = cls[0](request_id=name, model="m", token_ids=list(tokens),
                     stop=cls[2](max_tokens=n, ignore_eos=True),
                     sampling=cls[1](temperature=0.0))
        return [t async for out in engine.generate(req, ctx()) for t in out.token_ids]

    out = {"chunked": await one("chunked")}
    out["a"], out["b"] = await asyncio.gather(one("a"), one("b"))
    return out


@pytest.mark.parametrize("shape", sorted(ENGINE_SHAPES))
def test_engine_streams_equal_tpu_engine(shape):
    fields = dict(vocab_size=256, num_layers=2, intermediate_size=96, **ENGINE_SHAPES[shape])
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **fields)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **fields)
    jparams = jllama.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree.map(np.asarray, jparams)

    async def main():
        jeng = TpuEngine(TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True,
                                         decode_steps=1, decode_pipeline=1, **ENGINE),
                         params=jparams, mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        teng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", decode_steps=4,
                                             decode_pipeline=1, **ENGINE),
                           params=params_from_numpy(tree, tcfg, device="cpu"))
        try:
            want = await _serve(jeng, (JRequest, JSampling, JStop), JContext)
            got = await _serve(teng, (PreprocessedRequest, SamplingOptions, StopConditions),
                               Context)
            return want, got, dict(teng.step_counts)
        finally:
            jeng.stop()
            teng.stop()

    want, got, steps = asyncio.run(main())
    assert {k: len(v) for k, v in got.items()} == {"chunked": 6, "a": 10, "b": 12}
    assert got == want
    assert steps["prefill"] >= 2 and steps["horizon"] > 0, steps


# --------------------------------------------------------- construction
# published config.json values (huggingface.co/<name>): heads, kv heads,
# head_dim (hidden / heads where the config names none)
PUBLISHED = {
    "Qwen2.5-0.5B": (14, 2, 64), "Qwen2.5-1.5B": (12, 2, 128), "Qwen2.5-7B": (28, 4, 128),
    "Qwen2.5-14B": (40, 8, 128), "Qwen3-14B": (40, 8, 128), "Llama-3.2-1B": (32, 8, 64),
    "Llama-3.2-3B": (24, 8, 128),
}


def _cfg(heads, kv_heads, head_dim):
    return tllama.LlamaConfig(vocab_size=256, hidden_size=64, num_layers=1, num_heads=heads,
                              num_kv_heads=kv_heads, head_dim=head_dim, intermediate_size=64)


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_card_takes_the_published_shapes(name):
    cfg = _cfg(*PUBLISHED[name])
    engine_mod._check_features(TorchEngineConfig(model=cfg, device="cuda"))
    # as a draft too (a 1B draft for an 8B main)
    main = _cfg(32, 8, 128)
    engine_mod._check_features(TorchEngineConfig(model=main, spec_draft=cfg, device="cuda"))


@pytest.mark.parametrize("heads,kv_heads,head_dim", [(8, 2, 16), (8, 2, 96), (18, 2, 128)],
                         ids=["d16", "d96", "g9"])
def test_card_refuses_the_shapes_its_kernels_lack(heads, kv_heads, head_dim):
    cfg = _cfg(heads, kv_heads, head_dim)
    for kw in (dict(model=cfg), dict(model=_cfg(32, 8, 128), spec_draft=cfg)):
        with pytest.raises(ValueError, match=r"ROADMAP\.md \(Queue 1\)"):
            engine_mod._check_features(TorchEngineConfig(device="cuda", **kw))
        engine_mod._check_features(TorchEngineConfig(device="cpu", **kw))


def test_card_takes_spec_and_vision_on_every_family_the_reference_runs_them_on():
    """On device="cuda": spec decoding with Gemma, gpt-oss, Qwen3-MoE and
    MLA mains (a d-64 llama draft) and with Gemma and Qwen3-MoE drafts;
    vision on Gemma, gpt-oss and MLA mains. Refused, naming ROADMAP: a
    gpt-oss or MLA draft, vision on Qwen3-MoE, vision with a draft."""
    from dynamo_tpu_torch.models.gemma import GemmaConfig
    from dynamo_tpu_torch.models.gptoss import GptOssConfig
    from dynamo_tpu_torch.models.mla import MlaConfig
    from dynamo_tpu_torch.models.moe import MoeConfig
    from dynamo_tpu_torch.models.vision import VisionConfig

    mains = {"gemma": GemmaConfig.tiny_gemma3(), "gptoss": GptOssConfig.tiny_gptoss(),
             "moe": MoeConfig.tiny_moe(head_dim=64), "mla": MlaConfig.tiny_mla()}
    draft = tllama.LlamaConfig(vocab_size=512, hidden_size=64, num_layers=1, num_heads=8,
                               num_kv_heads=2, head_dim=64, intermediate_size=64)

    def check(**kw):
        engine_mod._check_features(TorchEngineConfig(device="cuda", **kw))

    for cfg in mains.values():
        check(model=cfg, spec_draft=draft)
    for d in (mains["gemma"], mains["moe"]):
        check(model=draft, spec_draft=d)
    for name in ("gemma", "gptoss", "mla"):
        cfg = mains[name]
        check(model=cfg, vision=VisionConfig.tiny(out_hidden_size=cfg.hidden_size))
    for kw in (dict(model=draft, spec_draft=mains["gptoss"]),
               dict(model=draft, spec_draft=mains["mla"]),
               dict(model=mains["moe"], vision=VisionConfig.tiny(out_hidden_size=64)),
               dict(model=draft, spec_draft=draft,
                    vision=VisionConfig.tiny(out_hidden_size=64))):
        with pytest.raises(ValueError, match="ROADMAP"):
            check(**kw)

