"""Serving HF checkpoints: TorchEngine (on the CPU) on the parameters the
port's loader reads streams the greedy tokens of TpuEngine on the
parameters the reference's loader reads from the same directory
(tests/torch_hf_ckpt.py writes them; float32 models). A Qwen3 checkpoint
runs tests/test_torch_engine.py's scenarios (a 150-token prompt over three
chunks, a prefix-cache hit, staggered requests through mixed steps, a stop
token), on a float and an int8 cache; Gemma 3, gpt-oss in MXFP4 and a
DeepSeek V3 (MLA) checkpoint run the chunked prompt and the prefix hit
(tests/test_torch_checkpoint_families.py).
"""

import asyncio
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import torch_hf_ckpt as ck
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine import weights as tweights
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context
from test_torch_engine import ENGINE, LONG, REPEAT, Side, _scenarios

BUILD = {
    "qwen3": lambda p: ck.llama(p, "qwen3", tie=True),
    "gemma3": lambda p: ck.gemma(p, 3),
    "gpt_oss-mxfp4": lambda p: ck.gptoss(p, dtype="BF16", mxfp4=True),
    "deepseek_v3": lambda p: ck.deepseek(p, 3, q_lora_rank=24),
}


async def _short_scenarios(side: Side):
    out = {"chunked": await side.run("chunked", LONG, max_tokens=6)}
    first = await side.run("repeat-a", REPEAT)
    out["repeat"] = {"first": first, "second": await side.run("repeat-b", REPEAT)}
    return out


def _streams(path, kv_dtype, scenarios):
    jcfg = dataclasses.replace(jweights.config_from_hf(path), dtype=np.float32)
    tcfg = dataclasses.replace(tweights.config_from_hf(path), dtype=torch.float32)

    async def main():
        jeng = TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True,
                            kv_dtype=kv_dtype, **ENGINE),
            params=jweights.load_params(path, jcfg),
            mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        teng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", kv_dtype=kv_dtype,
                                             **ENGINE),
                           params=tweights.load_params(path, tcfg, device="cpu"))
        try:
            want = await scenarios(Side(jeng, JRequest, JSampling, JStop, JContext))
            got = await scenarios(Side(teng, PreprocessedRequest, SamplingOptions,
                                       StopConditions, Context))
        finally:
            jeng.stop()
            teng.stop()
        return want, got

    return asyncio.run(main())


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_qwen3_checkpoint_streams_tpu_engine_tokens(tmp_path, kv_dtype):
    path = BUILD["qwen3"](str(tmp_path / "qwen3"))
    want, got = _streams(path, kv_dtype, _scenarios)
    assert len(got["chunked"]["tokens"]) == 6
    assert got["repeat"]["second"]["cached"] > 0
    assert [len(r["tokens"]) for r in got["staggered"]] == [24, 10, 12, 5]
    assert got == want


def test_run_builds_engines_from_checkpoints(tmp_path, monkeypatch):
    """``run.build_engine``: a checkpoint main through the warm cache (or
    not, ``warm_cache=False``) and a draft from ``spec_draft_path``, each
    bit-equal to the loader's parameters."""
    from dynamo_tpu_torch import run
    from test_torch_checkpoint import assert_bit_identical

    path = BUILD["qwen3"](str(tmp_path / "qwen3"))
    monkeypatch.setenv("DTPU_WARM_CACHE", str(tmp_path / "warm"))
    monkeypatch.setenv("DTPU_HUB_OFFLINE", "1")
    want = tweights.load_params(path, device="cpu")
    cold = run.build_engine(path, "cpu", 256, 0, decode_steps=1, decode_pipeline=1,
                            warm_cache=False)
    assert not (tmp_path / "warm").exists() or not os.listdir(tmp_path / "warm")
    spec = run.build_engine(path, "cpu", 256, 0, decode_steps=2, decode_pipeline=1,
                            spec_draft_path=path, spec_k=2)
    try:
        assert_bit_identical(cold.params, want)
        assert_bit_identical(spec.params, want)
        assert_bit_identical(spec.draft_params, want)
        assert spec.cfg.spec_draft == tweights.config_from_hf(path)
        assert len(os.listdir(tmp_path / "warm")) == 1   # main and draft: one entry
    finally:
        cold.stop()
        spec.stop()
