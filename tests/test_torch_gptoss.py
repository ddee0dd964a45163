"""The port's gpt-oss family (dynamo_tpu_torch/models/gptoss.py) against
the JAX package's, and TorchEngine serving it against TpuEngine.

Weights come from the JAX package's ``init_params`` (tiny_gptoss, float32)
with their zero-init biases and sinks perturbed, through numpy and
``engine.weights.params_from_numpy``; inputs are made with numpy from a
seed. Tolerances: YaRN frequencies 1e-6 relative (float32 powers in two
frameworks); router weights 1e-6 with identical expert ids; the expert FFN
1e-5 (float32 products summed in other orders); layer outputs and logits
1e-4 relative (as tests/test_torch_gemma.py). The engines serve prompts
longer than the 8-token window, chunked past it, a prefix-cache reuse and
staggered requests (mixed steps) with greedy streams that must be
identical: one step per tick and the eager horizon of 4 steps on a float32
cache, and an int8 cache. The horizon body runs with the grouped expert
path under the no-host-sync patch of tests/test_torch_horizon_graphs.py.
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
from dynamo_tpu.models import gptoss as jgptoss
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine import engine as eng
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import gptoss as tgptoss
from dynamo_tpu_torch.models import registry
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.runtime import Context
from test_torch_engine import Side, _prompt
from test_torch_horizon_graphs import _fill_state, _raise, _restore, _snapshot

FREQ_TOL = 1e-6
ROUTE_TOL = 1e-6
EXPERT_TOL = 1e-5
TOL = 1e-4
YARN = dict(rope_scaling_factor=8.0, rope_original_max_position=16)


def _configs(**kw):
    return (jgptoss.GptOssConfig.tiny_gptoss(**kw),
            tgptoss.GptOssConfig.tiny_gptoss(**kw))


def _numpy_params(jcfg, seed):
    """JAX init, then non-zero biases and sinks (init leaves them at 0,
    which would not exercise their mapping)."""
    tree = jax.tree.map(np.asarray, jgptoss.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lp in tree["layers"]:
        for name in ("bq", "bk", "bv", "bo", "sinks", "b_router", "b_gateup", "b_edown"):
            lp[name] = (0.5 * rng.standard_normal(lp[name].shape)).astype(np.float32)
    return tree


def _jattend(q, k, v, i, **kw):
    return jatt.causal_attention(q, k, v, **kw)


def _tattend(q, k, v, i, **kw):
    return tatt.causal_attention(q, k, v, **kw)


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=tol)


# ------------------------------------------------------------ rope, router
@pytest.mark.parametrize("yarn", [False, True], ids=["plain", "yarn"])
def test_yarn_inv_freq_matches_jax(yarn):
    for kw in ([YARN, dict(YARN, rope_truncate=True)] if yarn else [{}]):
        jcfg, tcfg = _configs(**kw)
        jf, jfac = jgptoss.yarn_inv_freq(jcfg)
        tf, tfac = tgptoss.yarn_inv_freq(tcfg)
        assert tf.dtype == torch.float32
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=FREQ_TOL, atol=0)
        assert tfac == pytest.approx(jfac, rel=FREQ_TOL)
        assert (tfac > 1.0) == yarn
        pos = np.array([0, 1, 7, 100, 4095], np.int32)
        jc, js = jgptoss.rope_tables(jcfg, jnp.asarray(pos))
        tc, ts = tgptoss.rope_tables(tcfg, torch.from_numpy(pos))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=FREQ_TOL, atol=5e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=FREQ_TOL, atol=5e-6)


def _layer(tree, i=0):
    return tree["layers"][i]


def test_route_matches_jax():
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=1)
    x = np.random.default_rng(2).standard_normal((33, 64)).astype(np.float32)
    jw, ji = jgptoss.route(jax.tree.map(jnp.asarray, _layer(tree)), jcfg, jnp.asarray(x))
    tp = params_from_numpy(tree, tcfg, device="cpu")["layers"][0]
    tw, ti = tgptoss.route(tp, tcfg, torch.from_numpy(x))
    assert ti.tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_TOL, atol=ROUTE_TOL)


def test_route_breaks_ties_as_jax_top_k():
    """Equal logits go to the lower expert id (jax.lax.top_k's rule): a
    zero router with a bias of repeated values ties every token."""
    jcfg, tcfg = _configs(num_experts=8, num_experts_per_tok=3)
    bias = np.array([0.5, 1.0, 0.5, 1.0, 1.0, -2.0, 0.5, 1.0], np.float32)
    p = {"w_router": np.zeros((64, 8), np.float32), "b_router": bias}
    x = np.random.default_rng(3).standard_normal((5, 64)).astype(np.float32)
    jw, ji = jgptoss.route(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    tw, ti = tgptoss.route({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                           torch.from_numpy(x))
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 3, 4]] * 5
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_TOL, atol=ROUTE_TOL)


# ------------------------------------------------------------- experts
def _routing(kind, T, E, K, rng):
    """(weights [T, K], ids [T, K]): random distinct experts per token;
    'skewed': expert 0 in every token's first slot, expert E - 1 in none."""
    if kind == "skewed":
        ids = np.stack([np.concatenate([[0], 1 + rng.permutation(E - 2)[:K - 1]])
                        for _ in range(T)])
    else:
        ids = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    w = rng.random((T, K)).astype(np.float32)
    return w / w.sum(-1, keepdims=True), ids.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "skewed"])
@pytest.mark.parametrize("form", ["plain", "grouped"])
def test_experts_match_the_reference_gather(form, kind):
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((19, 64)).astype(np.float32)
    w, ids = _routing(kind, 19, jcfg.num_experts, jcfg.num_experts_per_tok, rng)
    if kind == "skewed":
        counts = np.bincount(ids.ravel(), minlength=jcfg.num_experts)
        assert counts[0] == 19 and counts[-1] == 0
    want = jgptoss.experts_gather(jax.tree.map(jnp.asarray, _layer(tree)), jcfg,
                                  jnp.asarray(x), (jnp.asarray(w), jnp.asarray(ids)))
    tp = params_from_numpy(tree, tcfg, device="cpu")["layers"][0]
    fn = getattr(tgptoss, "experts_" + form)
    got = fn(tp, tcfg, torch.from_numpy(x), (torch.from_numpy(w), torch.from_numpy(ids).long()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EXPERT_TOL, rtol=EXPERT_TOL)


def test_expert_offsets_sort_pairs_by_expert_stably():
    ids = torch.tensor([[2, 0], [0, 3], [2, 1]])
    order, experts, offs = tgptoss.expert_offsets(ids, 5)
    assert order.tolist() == [1, 2, 5, 0, 4, 3]
    assert experts.tolist() == [0, 0, 1, 2, 2, 3]
    assert offs.dtype == torch.int32 and offs.tolist() == [2, 3, 5, 6, 6]


# ---------------------------------------------------------------- model
def test_layer_forward_matches_jax():
    jcfg, tcfg = _configs(**YARN)
    tree = _numpy_params(jcfg, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((20, 64)).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)
    jc, js = jgptoss.rope_tables(jcfg, jnp.asarray(pos))
    tc, ts = tgptoss.rope_tables(tcfg, torch.from_numpy(pos))
    tp = params_from_numpy(tree, tcfg, device="cpu")
    for i in (0, 1):   # sliding, full
        want = jgptoss.layer_forward(jax.tree.map(jnp.asarray, _layer(tree, i)), jcfg,
                                     jnp.asarray(x), jc[:, None], js[:, None], _jattend, i)
        got = tgptoss.layer_forward(tp["layers"][i], tcfg, torch.from_numpy(x),
                                    tc[:, None], ts[:, None], _tattend, i)
        _rel_close(got.numpy(), want, TOL)


@pytest.mark.parametrize("yarn", [False, True], ids=["plain", "yarn"])
def test_logits_match_jax(yarn):
    """30 tokens over an 8-token window: sliding and full layers, sinks,
    biases, the router and the experts; the port's grouped and plain
    expert forms."""
    jcfg, tcfg = _configs(num_layers=4, **(YARN if yarn else {}))
    tree = _numpy_params(jcfg, seed=8)
    tokens = np.random.default_rng(9).integers(0, 512, size=30).astype(np.int32)
    positions = np.arange(30, dtype=np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh = jgptoss.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), _jattend)
    want = np.asarray(jgptoss.lm_logits(jparams, jcfg, jh))
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    for fn in (tgptoss.experts_grouped, tgptoss.experts_plain):
        th = tgptoss.forward(tparams, tcfg, torch.from_numpy(tokens),
                             torch.from_numpy(positions), _tattend, expert_fn=fn)
        _rel_close(tgptoss.lm_logits(tparams, tcfg, th).numpy(), want, TOL)
        _rel_close(th.numpy(), np.asarray(jh), TOL)


def test_each_layer_passes_its_window_and_sinks():
    _, cfg = _configs(num_layers=4)
    params = tgptoss.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []

    def attend(q, k, v, i, **kw):
        seen.append((i, kw["window"], kw["sinks"]))
        return tatt.causal_attention(q, k, v, **kw)

    tgptoss.forward(params, cfg, torch.arange(5), torch.arange(5), attend)
    assert [w for _, w, _ in seen] == [8, None, 8, None]
    assert all(s is params["layers"][i]["sinks"] for i, _, s in seen)
    with pytest.raises(NotImplementedError, match="LoRA"):
        tgptoss.forward(params, cfg, torch.arange(5), torch.arange(5), attend,
                        lora=lambda *a: None)


def test_presets_and_registry_match_jax():
    fields = [f.name for f in dataclasses.fields(jgptoss.GptOssConfig) if f.name != "dtype"]
    for fn in ("tiny_gptoss", "gpt_oss_20b"):
        j, t = getattr(jgptoss.GptOssConfig, fn)(), getattr(tgptoss.GptOssConfig, fn)()
        for field in fields:
            assert getattr(j, field) == getattr(t, field), (fn, field)
        assert [t.window_for_layer(i) for i in range(t.num_layers)] == [
            j.window_for_layer(i) for i in range(j.num_layers)]
    assert tgptoss.GptOssConfig.gpt_oss_20b().dtype == torch.bfloat16
    assert "gpt-oss-20b" in registry.PRESETS and "gpt-oss-120b" not in registry.PRESETS
    _, cfg = _configs()
    assert registry.is_gptoss(cfg) and not registry.is_gemma(cfg)
    assert registry.forward_fn(cfg) is tgptoss.forward
    assert registry.lm_logits_fn(cfg) is tgptoss.lm_logits
    assert set(registry.layer_keys(cfg)) == set(
        jgptoss.init_layer_params(jax.random.PRNGKey(0), _configs()[0]))
    params = registry.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["layers"][0]["sinks"].dtype == torch.float32


def test_params_from_numpy_keeps_sinks_float32_and_refuses_unknown_keys():
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=10)
    bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = params_from_numpy(tree, bf16, device="cpu")
    layer = params["layers"][0]
    assert layer["sinks"].dtype == torch.float32
    np.testing.assert_array_equal(layer["sinks"].numpy(), _layer(tree)["sinks"])
    assert layer["w_gateup"].dtype == torch.bfloat16 and layer["bq"].dtype == torch.bfloat16
    tree["layers"][1]["w_gate"] = np.zeros((64, 64), np.float32)   # a llama key
    with pytest.raises(ValueError, match="w_gate"):
        params_from_numpy(tree, tcfg, device="cpu")


# ------------------------------------------------------------ engines
# largest bucket 64: a 150-token prompt prefills in three chunks, each
# crossing the 8-token window
ENGINE = dict(
    num_blocks=160, block_size=4, max_batch_size=4, max_context=256,
    prefill_buckets=(16, 32, 64), seed=0, decode_steps=1, decode_pipeline=1,
)
SHARED = _prompt(31, 44)


async def _scenarios(side: Side):
    out = {"chunked": await side.run("chunked", _prompt(30, 150), max_tokens=6)}
    cold = await side.run("cold", SHARED, max_tokens=9)
    warm = await side.run("warm", SHARED, max_tokens=9)
    out["prefix"] = {"cold": cold, "warm": warm}
    started = asyncio.Event()
    lead = asyncio.ensure_future(side.run("lead", _prompt(32, 20), max_tokens=24,
                                          on_first=started))
    await started.wait()
    rest = await asyncio.gather(side.run("b", _prompt(33, 70), max_tokens=10),
                                side.run("c", _prompt(34, 33), max_tokens=12))
    out["staggered"] = [await lead] + list(rest)
    return out


def _torch_side(tcfg, tree, **cfg):
    engine = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", **{**ENGINE, **cfg}),
                         params=params_from_numpy(tree, tcfg, device="cpu"))
    return Side(engine, PreprocessedRequest, SamplingOptions, StopConditions, Context)


@pytest.fixture(scope="module", params=["model", "int8"])
def streams(request):
    """TpuEngine's streams (one step per tick) and TorchEngine's at one
    step per tick and, on the float32 cache, at horizons of 4."""
    kv_dtype = request.param
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=11)

    async def main():
        jside = Side(TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True,
                            kv_dtype=kv_dtype, **ENGINE),
            params=jax.tree.map(jnp.asarray, tree),
            mesh=make_mesh(tp=1, devices=jax.devices()[:1])), JRequest, JSampling, JStop,
            JContext)
        tsides = {1: _torch_side(tcfg, tree, kv_dtype=kv_dtype)}
        if kv_dtype == "model":
            tsides[4] = _torch_side(tcfg, tree, decode_steps=4)
        try:
            want = await _scenarios(jside)
            got = {n: await _scenarios(side) for n, side in tsides.items()}
        finally:
            for side in (jside, *tsides.values()):
                side.engine.stop()
        return want, got, {n: dict(s.engine.step_counts) for n, s in tsides.items()}

    return asyncio.run(main())


def test_chunked_prefill_past_the_window_streams_tpu_engine_tokens(streams):
    want, got, steps = streams
    for n, g in got.items():
        assert len(g["chunked"]["tokens"]) == 6
        assert g["chunked"] == want["chunked"], n
        assert steps[n]["prefill"] >= 3


def test_prefix_cache_reuse_streams_tpu_engine_tokens(streams):
    want, got, _ = streams
    for n, g in got.items():
        assert g["prefix"] == want["prefix"], n
        assert g["prefix"]["warm"]["cached"] > 0
        assert g["prefix"]["warm"]["tokens"] == g["prefix"]["cold"]["tokens"]


def test_staggered_streams_equal_tpu_engine(streams):
    want, got, steps = streams
    for n, g in got.items():
        assert [len(r["tokens"]) for r in g["staggered"]] == [24, 10, 12]
        assert g["staggered"] == want["staggered"], n
        assert steps[n]["mixed"] > 0
    if 4 in steps:
        assert steps[4]["horizon"] > 0, steps[4]


# --------------------------------------------------- horizon capture safety
PATCHED = ("tolist", "item", "__bool__", "cpu", "numpy")


def test_horizon_body_with_grouped_experts_is_capture_safe(monkeypatch):
    """The gpt-oss horizon body, grouped expert path inside, runs through
    with host round trips and host-to-device copies patched to raise, and
    equals its unpatched run bit for bit. The CPU's plain unified attention
    reads its row arrays on the host (the card's kernel does not), so it
    alone runs unpatched."""
    _, tcfg = _configs(vocab_size=512)
    engine = TorchEngine(TorchEngineConfig(
        model=tcfg, num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
        prefill_buckets=(16, 32, 64), device="cpu", decode_steps=4, decode_pipeline=1))
    real = {n: getattr(torch.Tensor, n) for n in PATCHED}
    real_fns = (torch.tensor, torch.as_tensor)
    plain_attention = eng.cuda_unified.ragged_paged_attention
    grouped = {"calls": 0}
    real_grouped_mm = torch._grouped_mm

    def counted_grouped_mm(*a, **k):
        grouped["calls"] += 1
        return real_grouped_mm(*a, **k)

    def host_allowed_attention(*a, **k):
        patched = {n: getattr(torch.Tensor, n) for n in PATCHED}
        for n, f in real.items():
            setattr(torch.Tensor, n, f)
        torch.tensor, torch.as_tensor = real_fns
        try:
            return plain_attention(*a, **k)
        finally:
            for n, f in patched.items():
                setattr(torch.Tensor, n, f)
            torch.tensor = torch.as_tensor = _raise

    try:
        _fill_state(engine)
        before = _snapshot(engine)
        hs = engine._horizon.state
        engine._decode_multi(hs, 64, True)
        want = _snapshot(engine)
        _restore(engine, before)
        with monkeypatch.context() as m:
            m.setattr(torch, "_grouped_mm", counted_grouped_mm)
            m.setattr(eng.cuda_unified, "ragged_paged_attention", host_allowed_attention)
            for name in PATCHED:
                m.setattr(torch.Tensor, name, _raise)
            m.setattr(torch, "as_tensor", _raise)
            m.setattr(torch, "tensor", _raise)
            engine._decode_multi(hs, 64, True)
        got = _snapshot(engine)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # two grouped products (gate/up, down) per layer and step
        assert grouped["calls"] == 2 * tcfg.num_layers * 4
        assert hs.seq_lens.tolist() == [25, 0, 44, 13]
    finally:
        engine.stop()


def test_run_cli_serves_the_gptoss_preset_on_the_cpu():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run", "in=text:hello",
                        "out=tiny-gptoss", "--device", "cpu", "--max-tokens", "4",
                        "--max-context", "256"], cwd=repo,
                       env={**os.environ, "PYTHONPATH": repo}, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
