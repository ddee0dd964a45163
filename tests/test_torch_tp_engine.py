"""A two-process ``TorchEngine(tp=2, device="cpu")`` against the
reference's ``TpuEngine`` at tp=2 and at tp=1 (the reference's
tests/test_engine.py ``test_tp_equivalence``, held across packages), on
the reference's tiny float32 weights exported through numpy: the port's
greedy streams must equal both reference engines' in a prompt of three
prefill chunks, a prefix hit, fused mixed steps while a resident request
decodes, and horizons of 4 steps two in flight; a seeded sampled request
streams the reference's tp=2 tokens; the follower sampled exactly the
tokens its leader did (the digest of every op's samples); both ranks ran
the same steps and collectives, at least two all-reduces a layer per
forward pass. This file: the model-dtype cache; tests/test_torch_tp_int8.py
the int8 cache. Ranks are processes of tests/torch_tp_rank.py.
"""

import asyncio
import json
import os
import sys

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from test_torch_tp import LAYOUTS, MODEL, REPO, _jax_weights, start_ranks

sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_tp_rank import Side, scenarios  # noqa: E402

# largest bucket 64: the 150-token prompt prefills in three chunks
ENGINE = dict(num_blocks=160, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64), seed=0, decode_steps=4, decode_pipeline=2)


def _reference_streams(jcfg, jparams, tp, kv_dtype):
    async def main():
        engine = TpuEngine(
            TpuEngineConfig(model=jcfg, tp=tp, use_pallas=False, mixed_admission=True,
                            kv_dtype=kv_dtype, **ENGINE),
            params=jparams, mesh=make_mesh(tp=tp, devices=jax.devices()[:tp]))
        try:
            return await scenarios(Side(engine, JRequest, JSampling, JStop, JContext))
        finally:
            engine.stop()

    return asyncio.run(main())


def tp_streams(tmp_path, kv_dtype: str):
    """(reference streams at tp=2, at tp=1, the port's two rank reports)."""
    jcfg, jparams, tree = _jax_weights("llama")
    flat = {k: v for k, v in tree.items() if k != "layers"}
    for i, lp in enumerate(tree["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    np.savez(tmp_path / "w.npz", **flat)
    with open(tmp_path / "setup.json", "w") as f:
        json.dump({"model": dict(MODEL, **LAYOUTS["llama"]), "kv_dtype": kv_dtype,
                   "engine": dict(ENGINE, prefill_buckets=list(ENGINE["prefill_buckets"]))},
                  f)
    # the port's ranks run while the reference engines serve here
    wait = start_ranks(lambda spec, out: [spec, str(tmp_path / "setup.json"),
                                          str(tmp_path / "w.npz"), out], tmp_path)
    ref2 = _reference_streams(jcfg, jparams, 2, kv_dtype)
    ref1 = _reference_streams(jcfg, jparams, 1, kv_dtype)
    return ref2, ref1, wait(240.0)


def check_tp_streams(ref2, ref1, ranks) -> None:
    leader, follower = ranks
    got = leader["streams"]
    greedy = [k for k in got if k != "sampled"]
    for name in greedy:
        assert got[name] == ref2[name], name
        assert got[name] == ref1[name], name
    # the follower sampled every token the leader did, eager and horizon
    assert follower["sampled"] == leader["sampled"]
    assert leader["sampled"]["horizon"]["n"] > 0 and leader["sampled"]["eager"]["n"] > 0
    assert len(got["sampled"]["tokens"]) == 12
    assert got["sampled"] == ref2["sampled"]
    # every path ran: chunks, the fused mixed step, horizons
    steps = leader["steps"]
    assert steps["prefill"] > 0 and steps["mixed"] > 0 and steps["horizon"] > 0
    assert follower["steps"] == steps
    # two all-reduces a layer per forward pass (tied logits: one more a
    # sampling), one embedding gather per pass, on both ranks alike
    c = leader["collectives"]
    assert c == follower["collectives"]
    assert c["all_gather"] >= c["forwards"] > 0
    assert c["all_reduce"] >= 2 * MODEL["num_layers"] * c["forwards"]


@pytest.fixture(scope="module")
def model_dtype_streams(tmp_path_factory):
    return tp_streams(tmp_path_factory.mktemp("tp_model"), "model")


def test_tp2_engine_streams_the_references_greedy_tokens_at_tp2_and_tp1(model_dtype_streams):
    check_tp_streams(*model_dtype_streams)


def test_tp2_follower_sampled_what_its_leader_sampled(model_dtype_streams):
    _, _, (leader, follower) = model_dtype_streams
    assert follower["sampled"] == leader["sampled"]
    assert follower["rank"] == 1 and leader["rank"] == 0
