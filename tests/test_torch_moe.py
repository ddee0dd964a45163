"""The port's Qwen3-MoE family (dynamo_tpu_torch/models/moe.py) against the
JAX package's, and TorchEngine serving it against TpuEngine.

Weights come from the JAX package's ``init_params`` (tiny_moe, float32)
through numpy and ``engine.weights.params_from_numpy``; inputs are made
with numpy from a seed. Tolerances: router weights 1e-6 with identical
expert ids; the expert FFN forms, a layer and the logits 1e-5 (float32
products summed in other orders). The engines serve a prompt chunked in
three, a prefix-cache reuse and staggered requests (mixed steps) with
greedy streams that must be identical, at one decode step per tick and at
eager horizons of 4. The horizon body runs with the grouped expert path
under the no-host-sync patch of tests/test_torch_horizon_graphs.py.
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
from dynamo_tpu.models import moe as jmoe
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
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.models import registry
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.runtime import Context
from test_torch_engine import Side, _prompt
from test_torch_horizon_graphs import _fill_state, _raise, _restore, _snapshot

ROUTE_TOL = 1e-6
TOL = 1e-5


def _configs(**kw):
    return jmoe.MoeConfig.tiny_moe(**kw), tmoe.MoeConfig.tiny_moe(**kw)


def _numpy_params(jcfg, seed):
    return jax.tree.map(np.asarray, jmoe.init_params(jax.random.PRNGKey(seed), jcfg))


def _jattend(q, k, v, i):
    return jatt.causal_attention(q, k, v)


def _tattend(q, k, v, i):
    return tatt.causal_attention(q, k, v)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("norm", [True, False], ids=["renormalised", "raw"])
def test_route_and_expert_load_match_jax(norm):
    jcfg, tcfg = _configs(norm_topk_prob=norm)
    tree = _numpy_params(jcfg, seed=1)
    x = np.random.default_rng(2).standard_normal((33, 64)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree["layers"][0])
    jw, ji = jmoe.route(jp, jcfg, jnp.asarray(x))
    tp = params_from_numpy(tree, tcfg, device="cpu")["layers"][0]
    tw, ti = tmoe.route(tp, tcfg, torch.from_numpy(x))
    assert ti.tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_TOL, atol=ROUTE_TOL)
    load = tmoe.expert_load(tcfg, ti)
    assert load.dtype == torch.int32
    assert load.tolist() == np.asarray(jmoe.expert_load(jcfg, ji)).tolist()


def test_route_breaks_ties_as_jax_top_k():
    """Equal router probabilities go to the lower expert id
    (jax.lax.top_k's rule): router columns that are multiples of one
    vector tie every token's logits among equal multiples."""
    jcfg, tcfg = _configs(num_experts=8, num_experts_per_tok=3)
    v = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    scale = np.array([0.5, 1.0, 0.5, 1.0, 1.0, -2.0, 0.5, 1.0], np.float32)
    p = {"w_router": np.outer(v, scale)}
    x = np.stack([v * (i + 1) for i in range(5)]).astype(np.float32)
    jw, ji = jmoe.route(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    tw, ti = tmoe.route({k: torch.from_numpy(a) for k, a in p.items()}, tcfg,
                        torch.from_numpy(x))
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 3, 4]] * 5
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_TOL, atol=ROUTE_TOL)


# ------------------------------------------------------------- experts
@pytest.mark.parametrize("form", ["grouped", "plain", "dense"])
def test_expert_forms_match_jax_gather_and_dense(form):
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=4)
    x = np.random.default_rng(5).standard_normal((19, 64)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree["layers"][0])
    want_gather = np.asarray(jmoe.moe_ffn_gather(jp, jcfg, jnp.asarray(x)))
    want_dense = np.asarray(jmoe.moe_ffn(jp, jcfg, jnp.asarray(x)))
    tp = params_from_numpy(tree, tcfg, device="cpu")["layers"][0]
    xt = torch.from_numpy(x)
    if form == "dense":
        got = tmoe.moe_ffn(tp, tcfg, xt)
    else:
        fn = getattr(tmoe, "experts_" + form)
        got = fn(tp, tcfg, xt, tmoe.route(tp, tcfg, xt))
    _close(got.numpy(), want_gather)
    _close(got.numpy(), want_dense)


def test_grouped_experts_read_only_routed_experts_and_skip_empty_ones():
    """A routing that leaves experts without rows (and puts one expert in
    every token's first slot) gives the expert loop's result."""
    _, tcfg = _configs(num_experts=6, num_experts_per_tok=2)
    p = tmoe.init_layer_params(tcfg, torch.Generator().manual_seed(6), "cpu")
    x = torch.randn(11, 64, generator=torch.Generator().manual_seed(7))
    ids = torch.stack([torch.zeros(11, dtype=torch.long), 1 + torch.arange(11) % 2], 1)
    w = torch.rand(11, 2, generator=torch.Generator().manual_seed(8))
    got = tmoe.experts_grouped(p, tcfg, x, (w, ids))
    want = tmoe.experts_plain(p, tcfg, x, (w, ids))
    _close(got.numpy(), want.numpy())


# ---------------------------------------------------------------- model
def test_layer_forward_matches_jax():
    jcfg, tcfg = _configs(qk_norm=True)
    tree = _numpy_params(jcfg, seed=9)
    x = np.random.default_rng(10).standard_normal((20, 64)).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)
    jc, js = jmoe.rope_cos_sin(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta)
    tc, ts = tmoe.rope_cos_sin(torch.from_numpy(pos), tcfg.head_dim, tcfg.rope_theta)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    for i in (0, 1):
        want = jmoe.layer_forward(jax.tree.map(jnp.asarray, tree["layers"][i]), jcfg,
                                  jnp.asarray(x), jc[:, None], js[:, None], _jattend, i,
                                  ffn_fn=jmoe.moe_ffn_gather)
        got = tmoe.layer_forward(tp["layers"][i], tcfg, torch.from_numpy(x),
                                 tc[:, None], ts[:, None], _tattend, i)
        _close(got.numpy(), want)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_logits_match_jax(qk_norm):
    jcfg, tcfg = _configs(num_layers=3, qk_norm=qk_norm)
    tree = _numpy_params(jcfg, seed=11)
    tokens = np.random.default_rng(12).integers(0, 512, size=30).astype(np.int32)
    positions = np.arange(30, dtype=np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh = jmoe.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), _jattend)
    want = np.asarray(jmoe.lm_logits(jparams, jcfg, jh))
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    for fn in (tmoe.experts_grouped, tmoe.experts_plain):
        th = tmoe.forward(tparams, tcfg, torch.from_numpy(tokens),
                          torch.from_numpy(positions), _tattend, expert_fn=fn)
        _close(tmoe.lm_logits(tparams, tcfg, th).numpy(), want)


def test_redundant_experts_are_refused():
    with pytest.raises(ValueError, match="EPLB"):
        tmoe.MoeConfig.tiny_moe(redundant_experts=2)


def test_presets_and_registry_match_jax():
    fields = [f.name for f in dataclasses.fields(jmoe.MoeConfig) if f.name != "dtype"]
    for fn in ("tiny_moe", "qwen3_30b_a3b"):
        j, t = getattr(jmoe.MoeConfig, fn)(), getattr(tmoe.MoeConfig, fn)()
        for field in fields:
            assert getattr(j, field) == getattr(t, field), (fn, field)
    big = tmoe.MoeConfig.qwen3_30b_a3b()
    assert big.dtype == torch.bfloat16 and registry.PRESETS["qwen3-30b-a3b"]() == big
    assert registry.PRESETS["tiny-moe"]() == tmoe.MoeConfig.tiny_moe()
    _, cfg = _configs(qk_norm=True)
    assert registry.is_moe(cfg) and not registry.is_mla(cfg) and not registry.is_gptoss(cfg)
    assert registry.family(cfg) is tmoe
    assert registry.forward_fn(cfg) is tmoe.forward
    assert registry.lm_logits_fn(cfg) is tmoe.lm_logits
    jcfg = jmoe.MoeConfig.tiny_moe(qk_norm=True)
    assert set(registry.layer_keys(cfg)) == set(
        jmoe.init_layer_params(jax.random.PRNGKey(0), jcfg))
    assert registry.float32_keys(cfg) == ()


def test_params_from_numpy_refuses_unknown_keys():
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=13)
    params = params_from_numpy(tree, dataclasses.replace(tcfg, dtype=torch.bfloat16),
                               device="cpu")
    assert params["layers"][0]["w_gate"].dtype == torch.bfloat16
    assert params["layers"][0]["w_gate"].shape == (4, 64, 64)
    tree["layers"][1]["sinks"] = np.zeros(4, np.float32)   # a gpt-oss key
    with pytest.raises(ValueError, match="sinks"):
        params_from_numpy(tree, tcfg, device="cpu")


# ------------------------------------------------------------ engines
# largest bucket 64: a 150-token prompt prefills in three chunks
ENGINE = dict(
    num_blocks=160, block_size=4, max_batch_size=4, max_context=256,
    prefill_buckets=(16, 32, 64), seed=0, decode_steps=1, decode_pipeline=1,
)
SHARED = _prompt(41, 44)


async def _scenarios(side: Side):
    out = {"chunked": await side.run("chunked", _prompt(40, 150), max_tokens=6)}
    cold = await side.run("cold", SHARED, max_tokens=9)
    warm = await side.run("warm", SHARED, max_tokens=9)
    out["prefix"] = {"cold": cold, "warm": warm}
    started = asyncio.Event()
    lead = asyncio.ensure_future(side.run("lead", _prompt(42, 20), max_tokens=24,
                                          on_first=started))
    await started.wait()
    rest = await asyncio.gather(side.run("b", _prompt(43, 70), max_tokens=10),
                                side.run("c", _prompt(44, 33), max_tokens=12))
    out["staggered"] = [await lead] + list(rest)
    return out


def engine_streams(jcfg, tcfg, tree, horizon: bool):
    """TpuEngine's streams (one step per tick) and TorchEngine's at one
    step per tick and, with ``horizon``, at eager horizons of 4; and each
    TorchEngine's step counts."""

    async def main():
        jside = Side(TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True, **ENGINE),
            params=jax.tree.map(jnp.asarray, tree),
            mesh=make_mesh(tp=1, devices=jax.devices()[:1])), JRequest, JSampling, JStop,
            JContext)
        tsides = {}
        for steps in (1, 4) if horizon else (1,):
            engine = TorchEngine(
                TorchEngineConfig(model=tcfg, device="cpu", **{**ENGINE, "decode_steps": steps}),
                params=params_from_numpy(tree, tcfg, device="cpu"))
            tsides[steps] = Side(engine, PreprocessedRequest, SamplingOptions,
                                 StopConditions, Context)
        try:
            want = await _scenarios(jside)
            got = {n: await _scenarios(side) for n, side in tsides.items()}
        finally:
            for side in (jside, *tsides.values()):
                side.engine.stop()
        return want, got, {n: dict(s.engine.step_counts) for n, s in tsides.items()}

    return asyncio.run(main())


def check_streams(want, got, steps):
    """Every TorchEngine streams TpuEngine's tokens: the chunked prompt,
    the prefix-cache hit, the staggered requests through mixed steps."""
    for n, g in got.items():
        assert len(g["chunked"]["tokens"]) == 6 and g["chunked"] == want["chunked"], n
        assert steps[n]["prefill"] >= 3
        assert g["prefix"] == want["prefix"], n
        assert g["prefix"]["warm"]["cached"] > 0
        assert [len(r["tokens"]) for r in g["staggered"]] == [24, 10, 12]
        assert g["staggered"] == want["staggered"], n
        assert steps[n]["mixed"] > 0
    if 4 in steps:
        assert steps[4]["horizon"] > 0, steps[4]


def test_torch_engine_streams_tpu_engine_tokens():
    jcfg, tcfg = _configs(qk_norm=True)
    check_streams(*engine_streams(jcfg, tcfg, _numpy_params(jcfg, seed=14), horizon=True))


# --------------------------------------------------- horizon capture safety
PATCHED = ("tolist", "item", "__bool__", "cpu", "numpy")


def run_capture_safe(engine, monkeypatch, host_allowed=()):
    """Runs the horizon body once unpatched, then again from the same
    state with host round trips and host-to-device copies patched to raise
    (the functions named in ``host_allowed``, (module, name) pairs, run
    unpatched: the CPU's plain attention reads its row arrays on the host,
    the card's kernels do not), and requires the two to be equal bit for
    bit. Returns the calls to torch._grouped_mm in the patched run."""
    real = {n: getattr(torch.Tensor, n) for n in PATCHED}
    real_fns = (torch.tensor, torch.as_tensor)
    grouped = {"calls": 0}
    real_grouped_mm = torch._grouped_mm

    def counted_grouped_mm(*a, **k):
        grouped["calls"] += 1
        return real_grouped_mm(*a, **k)

    def allow_host(fn):
        def call(*a, **k):
            patched = {n: getattr(torch.Tensor, n) for n in PATCHED}
            for n, f in real.items():
                setattr(torch.Tensor, n, f)
            torch.tensor, torch.as_tensor = real_fns
            try:
                return fn(*a, **k)
            finally:
                for n, f in patched.items():
                    setattr(torch.Tensor, n, f)
                torch.tensor = torch.as_tensor = _raise
        return call

    _fill_state(engine)
    before = _snapshot(engine)
    hs = engine._horizon.state
    engine._decode_multi(hs, 64, True)
    want = _snapshot(engine)
    _restore(engine, before)
    with monkeypatch.context() as m:
        m.setattr(torch, "_grouped_mm", counted_grouped_mm)
        for module, name in host_allowed:
            m.setattr(module, name, allow_host(getattr(module, name)))
        for name in PATCHED:
            m.setattr(torch.Tensor, name, _raise)
        m.setattr(torch, "as_tensor", _raise)
        m.setattr(torch, "tensor", _raise)
        engine._decode_multi(hs, 64, True)
    got = _snapshot(engine)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert hs.seq_lens.tolist() == [25, 0, 44, 13]
    return grouped["calls"]


def test_horizon_body_with_grouped_experts_is_capture_safe(monkeypatch):
    """The Qwen3-MoE horizon body (the decode kernel's plain version, the
    grouped experts) runs without a host round trip."""
    _, tcfg = _configs(qk_norm=True)
    engine = TorchEngine(TorchEngineConfig(
        model=tcfg, num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
        prefill_buckets=(16, 32, 64), device="cpu", decode_steps=4, decode_pipeline=1))
    try:
        calls = run_capture_safe(engine, monkeypatch)
        # three grouped products (gate, up, down) per layer and step
        assert calls == 3 * tcfg.num_layers * 4
    finally:
        engine.stop()
