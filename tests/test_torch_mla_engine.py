"""TorchEngine serving the port's MLA family against TpuEngine
(models/mla.py; the model itself: tests/test_torch_mla.py).

Weights come from the JAX package's ``init_params`` (tiny_mla,
tiny_mla_moe; float32) through numpy and ``params_from_numpy``. The
engines serve a prompt chunked in three, a prefix-cache reuse and
staggered requests (mixed steps) with greedy streams that must be
identical, tiny_mla also at eager horizons of 4; every attention call of
an MLA model goes through the latent wrapper (ops/cuda_mla.py), in
prefill chunks, decode steps, mixed steps and horizons; an int8 cache is
refused; the horizon body with DeepSeek's routing and the grouped experts
inside runs without a host round trip.
"""

import asyncio

import pytest

from dynamo_tpu_torch.engine import engine as eng
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context
from test_torch_engine import Side, _prompt
from test_torch_mla import _configs, _numpy_params
from test_torch_moe import ENGINE, check_streams, engine_streams, run_capture_safe


# ------------------------------------------------------------ engines
@pytest.mark.parametrize("name,horizon", [("tiny_mla", True), ("tiny_mla_moe", False)])
def test_torch_engine_streams_tpu_engine_tokens(name, horizon):
    jcfg, tcfg = _configs(name)
    check_streams(*engine_streams(jcfg, tcfg, _numpy_params(jcfg, seed=12), horizon))


def test_every_attention_call_goes_through_the_latent_wrapper(monkeypatch):
    _, tcfg = _configs("tiny_mla")
    calls = []
    latent = eng.cuda_mla.latent_paged_attention

    def spy(q, *a, **k):
        calls.append((tuple(q.shape), k["max_q_len"], k["v_dim"]))
        return latent(q, *a, **k)

    def forbidden(*a, **k):
        raise AssertionError("an MLA layer reached a non-latent attention kernel")

    monkeypatch.setattr(eng.cuda_mla, "latent_paged_attention", spy)
    for mod, name in ((eng.cuda_attention, "paged_decode_attention"),
                      (eng.cuda_prefill, "flash_extend_attention"),
                      (eng.cuda_unified, "ragged_paged_attention")):
        monkeypatch.setattr(mod, name, forbidden)
    engine = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                           **{**ENGINE, "decode_steps": 4}))
    side = Side(engine, PreprocessedRequest, SamplingOptions, StopConditions, Context)

    async def main():
        started = asyncio.Event()
        lead = asyncio.ensure_future(side.run("lead", _prompt(50, 20), max_tokens=20,
                                              on_first=started))
        await started.wait()
        return [await side.run("b", _prompt(51, 100), max_tokens=6), await lead]

    try:
        out = asyncio.run(main())
    finally:
        engine.stop()
    assert [len(r["tokens"]) for r in out] == [6, 20]
    steps = engine.step_counts
    assert steps["prefill"] and steps["mixed"] and steps["horizon"], steps
    # the latent queries; the first kv_lora_rank output lanes
    assert all(shape[1:] == (4, 80) and v_dim == 64 for shape, _, v_dim in calls)
    assert {q for _, q, _ in calls} >= {1, 64}   # decode rows and prefill chunks


def test_an_int8_cache_is_refused_for_mla():
    _, tcfg = _configs("tiny_mla")
    with pytest.raises(ValueError, match="int8"):
        TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", kv_dtype="int8", **ENGINE))


def test_horizon_body_with_latent_attention_and_experts_is_capture_safe(monkeypatch):
    """The MLA horizon body (the latent wrapper, DeepSeek routing, grouped
    routed experts and shared experts) runs without a host round trip;
    the CPU's plain latent attention alone reads its row arrays on the
    host."""
    _, tcfg = _configs("tiny_mla_moe")
    engine = TorchEngine(TorchEngineConfig(
        model=tcfg, num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
        prefill_buckets=(16, 32, 64), device="cpu", decode_steps=4, decode_pipeline=1))
    try:
        calls = run_capture_safe(engine, monkeypatch,
                                 host_allowed=[(eng.cuda_mla, "latent_paged_attention")])
        moe_layers = tcfg.num_layers - tcfg.first_dense_layers
        assert calls == 3 * moe_layers * 4
    finally:
        engine.stop()
