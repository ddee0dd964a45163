"""The port's critical-path attribution against the reference's.

runtime/attribution.py of both packages on the same timelines: a seeded
corpus of flight timelines (known, unknown and out-of-order kinds, merged
frontend + worker timelines) through ``attribute`` and
``attribution_breakdown`` (the phases sum to e2e exactly), the
``AttributionAggregator`` windows and p99 tail on an injected clock with
its phase histograms, ``tail_samples``, and the engine's closed timelines:
TorchEngine feeds the worker's aggregator as TpuEngine does.
"""

import re

import numpy as np
import pytest

from dynamo_tpu.runtime import attribution as jattr
from dynamo_tpu.runtime import flight_recorder as jflight
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.runtime import attribution as tattr
from dynamo_tpu_torch.runtime import flight_recorder as tflight
from dynamo_tpu_torch.runtime import metrics as tmetrics
from torch_feature_engines import Weights

KINDS = ("received", "tokenized", "routed", "fetch_started", "fetch_committed", "queued",
         "admitted", "first_token", "migration", "slo_violation", "finish", "abort",
         "prefill_done", "mystery", "onboard", "transfer")


def flights(seed: int, n: int = 120) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 12))
        t = int(rng.integers(10**18, 2 * 10**18))
        events = []
        for _ in range(k):
            t += int(rng.integers(-10**6, 10**9))   # some out of order
            events.append({"timestamp": t, "event": {"kind": str(rng.choice(KINDS))}})
        out.append({"request_id": f"r{i}", "events": events})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribute_and_breakdown_equal_the_references(seed):
    for flight in flights(seed):
        a, b = jattr.attribute(flight), tattr.attribute(flight)
        assert b == a
        assert tattr.attribution_breakdown(flight) == jattr.attribution_breakdown(flight)
        if b is not None:
            assert sum(b["phases_ns"].values()) == b["e2e_ns"]
            assert set(b["phases_ns"]) == set(tattr.PHASES)


def aggregate(attr, metrics, fls, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = [0.0]
    scope = metrics.MetricsScope()
    agg = attr.AttributionAggregator(clock=lambda: clock[0], metrics=scope)
    seen = []
    for i, flight in enumerate(fls * 6):
        clock[0] += float(rng.exponential(8.0))
        seen.append(agg.observe_flight(str(rng.choice(["m1", "m2"])),
                                       str(rng.choice(["interactive", "unclassified"])),
                                       flight))
        if i % 101 == 0:
            seen.append(agg.snapshot())
    seen.append(agg.snapshot())
    text = re.sub(r"_created(\{[^}]*\})? \S+", r"_created\1 <t>", scope.expose().decode())
    seen.append(sorted(text.splitlines()))
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregator_windows_and_tail_equal_the_references(seed):
    fls = flights(seed)
    assert aggregate(tattr, tmetrics, fls, seed) == aggregate(jattr, jmetrics, fls, seed)


def test_tail_samples_picks_slowest_as_the_reference():
    rng = np.random.default_rng(4)
    for n in (1, 2, 99, 100, 101, 1000):
        samples = [(int(v), {"decode": int(v)}) for v in rng.integers(0, 10**9, n)]
        for q in (0.5, 0.9, 0.99):
            assert tattr.tail_samples(samples, q) == jattr.tail_samples(samples, q)
    assert tattr.tail_samples([(5, {}), (1, {}), (3, {})], 0.5) == [(3, {}), (5, {})]


def test_bucket_sample_cap_counts_the_rest():
    """Past the per-bucket sample cap, counts and sums stay exact and the
    window reports how many samples it left out."""
    out = []
    for attr in (jattr, tattr):
        agg = attr.AttributionAggregator(clock=lambda: 5.0)
        flight = {"events": [{"timestamp": 0, "event": {"kind": "queued"}},
                             {"timestamp": 10, "event": {"kind": "finish"}}]}
        for _ in range(600):
            agg.observe_flight("m", "c", flight)
        out.append(agg.snapshot())
    assert out[1] == out[0]
    total = out[1]["models"]["m"]["c"]["total"]
    assert total["requests"] == 600 and total["sampled_out"] == 88


MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64))


async def engine_attribution(engine, port: bool) -> dict:
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.engine import Context as JContext

    attr, flight, common, ctx = ((tattr, tflight, tcommon, Context) if port
                                 else (jattr, jflight, jcommon, JContext))
    agg = attr.AttributionAggregator()
    attr.set_attribution(agg)
    rec = flight.FlightRecorder(capacity=16)
    flight.set_flight_recorder(rec)
    try:
        for rid in ("a1", "a2"):
            req = common.PreprocessedRequest(
                request_id=rid, model="m", token_ids=list(range(30, 70)),
                stop=common.StopConditions(max_tokens=3, ignore_eos=True),
                sampling=common.SamplingOptions(temperature=0.0))
            async for _ in engine.generate(req, ctx(rid)):
                pass
        agg_doc = agg.snapshot()
        sums = []
        for rid in ("a1", "a2"):
            a = attr.attribute(rec.timeline(rid))
            sums.append((sum(a["phases_ns"].values()) == a["e2e_ns"],
                         sorted(p for p, ns in a["phases_ns"].items() if ns > 0)))
        total = agg_doc["models"]["m"]["unclassified"]["total"]
        return {"requests": total["requests"], "phases": sorted(total["mean_share"]),
                "sums": sums}
    finally:
        engine.stop()
        attr.set_attribution(None)
        flight.set_flight_recorder(None)


async def test_engine_timelines_fold_into_the_aggregator_as_the_reference():
    w = Weights(MODEL)
    ref = await engine_attribution(w.jax_engine(ENGINE), False)
    port = await engine_attribution(w.torch_engine(ENGINE, decode_steps=1), True)
    assert port == ref
    assert port["requests"] == 2
    assert all(ok and phases == ["decode", "prefill_compute", "prefill_queue"]
               for ok, phases in port["sums"])
