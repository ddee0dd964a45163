"""The port's Gemma 2 / Gemma 3 family (dynamo_tpu_torch/models/gemma.py)
against the JAX package's, and TorchEngine serving it against TpuEngine.

Weights come from the JAX package's ``init_params`` (float32) with their
zero-init norms perturbed, go through numpy and
``engine.weights.params_from_numpy``; both models run their package's
causal attention with each layer's window and softcap. Tolerance 1e-4
relative on the float32 logits (matmuls summed in different orders by XLA
and PyTorch). The engines serve tiny_gemma3 (window 16 over prompts of up
to 150 tokens, chunked prefill, staggered requests so mixed steps run)
with greedy streams that must be identical, on a float32 and an int8 cache.
Only tiny_gemma3 is served: the JAX engine's tiny_gemma2 programs take
long to compile (tests/test_gemma.py marks that engine test slow), and
tiny_gemma2's softcaps are held to the reference by the model tests here.
"""

import asyncio
import math

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
from dynamo_tpu.models import gemma as jgemma
from dynamo_tpu.ops import attention as jatt
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
from dynamo_tpu_torch.models import registry
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.runtime import Context

TOL = 1e-4
TINY = ("tiny_gemma2", "tiny_gemma3")


def _configs(name, **kw):
    return (getattr(jgemma.GemmaConfig, name)(**kw),
            getattr(tgemma.GemmaConfig, name)(**kw))


def _numpy_params(jcfg, seed):
    """JAX init, then non-zero norm weights (init leaves them at 0, which
    would not exercise the (1 + w) scaling)."""
    tree = jax.tree.map(np.asarray, jgemma.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["final_norm"] = (0.1 * rng.standard_normal(tree["final_norm"].shape)).astype(np.float32)
    for lp in tree["layers"]:
        for name in lp:
            if "norm" in name:
                lp[name] = (0.1 * rng.standard_normal(lp[name].shape)).astype(np.float32)
    return tree


def _jattend(q, k, v, i, **kw):
    return jatt.causal_attention(q, k, v, **kw)


def _tattend(q, k, v, i, **kw):
    return tatt.causal_attention(q, k, v, **kw)


@pytest.mark.parametrize("name", TINY)
def test_logits_match_jax(name):
    """40 tokens over a 16-token window: sliding and full layers, the
    softcaps (gemma2), q/k norms and the dual RoPE (gemma3)."""
    jcfg, tcfg = _configs(name)
    tree = _numpy_params(jcfg, seed=3)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=40).astype(np.int32)
    positions = np.arange(40, dtype=np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh = jgemma.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), _jattend)
    want = np.asarray(jgemma.lm_logits(jparams, jcfg, jh))
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    th = tgemma.forward(tparams, tcfg, torch.from_numpy(tokens),
                        torch.from_numpy(positions), _tattend)
    got = tgemma.lm_logits(tparams, tcfg, th).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_each_layer_passes_its_window_and_softcap():
    """gemma2 alternates sliding (even) and full (odd) layers, all softcapped;
    gemma3 has five sliding then one full layer and no softcap."""
    seen = []

    def attend(q, k, v, i, **kw):
        seen.append((i, kw))
        return tatt.causal_attention(q, k, v, **kw)

    for name in TINY:
        _, cfg = _configs(name)
        params = tgemma.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tgemma.forward(params, cfg, torch.arange(5), torch.arange(5), attend)
    g2 = [kw for _, kw in seen[:4]]
    assert g2 == [dict(window=16, softcap=50.0), dict(window=None, softcap=50.0)] * 2
    g3 = [kw["window"] for _, kw in seen[4:]]
    assert g3 == [16, 16, None, 16, 16, None]
    assert all(kw["softcap"] is None for _, kw in seen[4:])


def test_bf16_normalizer_is_rounded_to_the_model_dtype():
    """sqrt(3072) = 55.43 is 55.5 in bf16: the port scales the embeddings
    by the rounded value, as the reference (and the HF checkpoints) do."""
    assert tgemma._rounded(math.sqrt(3072), torch.bfloat16) == 55.5
    kw = dict(vocab_size=64, hidden_size=3072, num_layers=0, num_heads=2,
              num_kv_heads=1, head_dim=16, intermediate_size=32)
    jcfg, tcfg = jgemma.GemmaConfig(**kw), tgemma.GemmaConfig(**kw)
    embed = (0.02 * np.random.default_rng(1).standard_normal((64, 3072))).astype(np.float32)
    tree = {"embed": embed, "final_norm": np.zeros(3072, np.float32), "layers": []}
    tokens = np.arange(8, dtype=np.int32)
    want = jgemma.forward(jax.tree.map(jnp.asarray, tree) | {"embed": jnp.asarray(embed, jnp.bfloat16)},
                          jcfg, jnp.asarray(tokens), jnp.asarray(tokens), _jattend)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    got = tgemma.forward(tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(tokens),
                         _tattend)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the unrounded normalizer gives another product on most embeddings
    x = tparams["embed"][:8]
    assert not torch.equal(x * 55.5, x * math.sqrt(3072))


def test_gemma_rms_norm_scales_before_the_downcast():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = (0.5 * rng.standard_normal(64)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jgemma.gemma_rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-6)
        got = tgemma.gemma_rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                                    1e-6)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=1e-5, rtol=1e-5)


def test_presets_match_jax():
    """Each Gemma preset the port names has the reference's numbers."""
    fields = ("vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
              "head_dim", "intermediate_size", "rope_theta", "qk_norm", "tie_embeddings",
              "max_position", "query_pre_attn_scalar", "sliding_window", "layer_types",
              "sliding_pattern", "attn_logit_softcap", "final_logit_softcap",
              "rope_local_theta", "rope_scaling_factor")
    for fn in ("tiny_gemma2", "tiny_gemma3", "gemma2_2b", "gemma3_4b"):
        j, t = getattr(jgemma.GemmaConfig, fn)(), getattr(tgemma.GemmaConfig, fn)()
        for field in fields:
            assert getattr(j, field) == getattr(t, field), (fn, field)
        assert [t.window_for_layer(i) for i in range(t.num_layers)] == [
            j.window_for_layer(i) for i in range(j.num_layers)]
    assert tgemma.GemmaConfig.gemma2_2b().dtype == torch.bfloat16
    for name in ("tiny-gemma2", "tiny-gemma3", "gemma2-2b", "gemma3-4b", "llama3-8b"):
        assert name in registry.PRESETS


def test_registry_picks_the_family():
    _, g = _configs("tiny_gemma3")
    from dynamo_tpu_torch.models import llama as tllama

    assert registry.forward_fn(g) is tgemma.forward
    assert registry.lm_logits_fn(g) is tgemma.lm_logits
    ll = tllama.LlamaConfig()
    assert registry.forward_fn(ll) is tllama.forward
    params = registry.init_params(g, torch.Generator().manual_seed(0), "cpu")
    assert float(params["layers"][0]["post_mlp_norm"].abs().sum()) == 0.0   # zero-init norms
    assert "lm_head" not in params


def test_params_from_numpy_takes_the_family_keys():
    jcfg, tcfg = _configs("tiny_gemma3")
    tree = _numpy_params(jcfg, seed=0)
    params = params_from_numpy(tree, tcfg, device="cpu")
    assert {"post_attn_norm", "pre_mlp_norm", "post_mlp_norm"} <= set(params["layers"][0])
    tree["layers"][1]["mlp_norm"] = np.zeros(64, np.float32)   # a llama key
    with pytest.raises(ValueError, match="mlp_norm"):
        params_from_numpy(tree, tcfg, device="cpu")


# ------------------------------------------------------------ engines
# largest bucket 64: a 150-token prompt prefills in three chunks; window 16
ENGINE = dict(
    num_blocks=160, block_size=4, max_batch_size=4, max_context=256,
    prefill_buckets=(16, 32, 64), seed=0, decode_steps=1, decode_pipeline=1,
)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


async def _scenarios(engine, req_cls, samp_cls, stop_cls, ctx_cls):
    async def run(rid, tokens, max_tokens, on_first=None):
        req = req_cls(request_id=rid, model="m", token_ids=list(tokens),
                      stop=stop_cls(max_tokens=max_tokens),
                      sampling=samp_cls(temperature=0.0))
        toks = []
        async for out in engine.generate(req, ctx_cls()):
            toks.extend(out.token_ids)
            if toks and on_first is not None and not on_first.is_set():
                on_first.set()
        return toks

    out = {"chunked": await run("chunked", _prompt(1, 150), 6)}
    # staggered: a resident decode past the window, then prompts that
    # prefill (in chunks) while it and each other decode: mixed steps
    started = asyncio.Event()
    lead = asyncio.ensure_future(run("lead", _prompt(2, 20), 24, on_first=started))
    await started.wait()
    rest = await asyncio.gather(run("b", _prompt(3, 70), 10), run("c", _prompt(4, 33), 12))
    out["staggered"] = [await lead] + list(rest)
    return out


@pytest.fixture(scope="module", params=["model", "int8"])
def streams(request):
    kv_dtype = request.param
    jcfg, tcfg = _configs("tiny_gemma3")
    tree = _numpy_params(jcfg, seed=5)
    jparams = jax.tree.map(jnp.asarray, tree)

    async def main():
        jeng = TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True,
                            kv_dtype=kv_dtype, **ENGINE),
            params=jparams, mesh=make_mesh(tp=1, devices=jax.devices()[:1]),
        )
        teng = TorchEngine(
            TorchEngineConfig(model=tcfg, device="cpu", kv_dtype=kv_dtype, **ENGINE),
            params=params_from_numpy(tree, tcfg, device="cpu"),
        )
        try:
            want = await _scenarios(jeng, JRequest, JSampling, JStop, JContext)
            got = await _scenarios(teng, PreprocessedRequest, SamplingOptions,
                                   StopConditions, Context)
        finally:
            jeng.stop()
            teng.stop()
        return want, got, dict(teng.step_counts)

    return asyncio.run(main())


def test_chunked_prefill_stream_equals_tpu_engine(streams):
    """150 prompt tokens over a largest bucket of 64 (three chunks) and a
    16-token window."""
    want, got, steps = streams
    assert len(got["chunked"]) == 6
    assert got["chunked"] == want["chunked"]
    assert steps["prefill"] >= 3


def test_staggered_streams_equal_tpu_engine(streams):
    want, got, steps = streams
    assert steps["mixed"] > 0 and steps["decode"] > 0, steps
    assert [len(t) for t in got["staggered"]] == [24, 10, 12]
    assert got["staggered"] == want["staggered"]


def test_run_cli_serves_a_gemma_preset_on_the_cpu():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run", "in=text:hello",
                        "out=tiny-gemma3", "--device", "cpu", "--max-tokens", "4",
                        "--max-context", "256"], cwd=repo, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run", "in=text:hi",
                        "out=tiny-gemma2", "--device", "cpu", "--max-context", "9000"],
                       cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "max_position" in r.stderr
