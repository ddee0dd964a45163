"""The port's degradation detectors and step-cost floor against the reference's.

Both packages' ``HealthMonitor`` get the same seeded feed on an injected
clock (runtime/health.py: cost-model drift, wire collapse, hit-rate drop and
burn-rate acceleration, one hysteresis / rate-limit core): every emitted
event, the active set, the counts, the snapshot, the synthetic flight
timelines (timestamps masked) and the events counter in /metrics must be
equal. The port's ``ops/costs.predict_step_seconds`` and
``unified_attention_bytes`` must equal the reference's on the same rows and
constants; the worker's predictor prices a horizon of N steps as N passes.
"""

import dataclasses

import numpy as np
import pytest

from dynamo_tpu.ops import costs as jcosts
from dynamo_tpu.runtime import flight_recorder as jflight
from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu.runtime import slo as jslo
from dynamo_tpu_torch.ops import costs as tcosts
from dynamo_tpu_torch.runtime import flight_recorder as tflight
from dynamo_tpu_torch.runtime import health as thealth
from dynamo_tpu_torch.runtime import metrics as tmetrics
from dynamo_tpu_torch.runtime import slo as tslo


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def feed(seed: int, n: int = 400) -> list:
    """A seeded mix of detector observations; regimes change every ~40, so
    each detector trips, re-emits past the rate limit and recovers."""
    rng = np.random.default_rng(seed)
    obs = []
    drift = 1.0
    bw = 1e9
    hit = 0.6
    for i in range(n):
        if i % 40 == 0:
            drift = float(rng.choice([1.0, 3.0, 1.7]))
            bw = float(rng.choice([1e9, 1e8, 5e8]))
            hit = float(rng.choice([0.6, 0.1, 0.02]))
        dt = float(rng.uniform(0.1, 4.0))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            pred = float(rng.uniform(0.001, 0.05))
            obs.append((dt, "step", f"worker/{int(rng.integers(0, 2))}",
                        pred * drift * float(rng.uniform(0.9, 1.1)), pred,
                        str(rng.choice(["decode", "prefill"]))))
        elif kind == 1:
            obs.append((dt, "wire", str(rng.choice(["tcp", "inline"])),
                        bw * float(rng.uniform(0.8, 1.2))))
        elif kind == 2:
            obs.append((dt, "hit", f"radix/w{int(rng.integers(0, 2))}",
                        min(1.0, hit * float(rng.uniform(0.8, 1.2)))))
        else:
            short = None if rng.random() < 0.1 else float(rng.uniform(0, 12))
            long = None if rng.random() < 0.2 else float(rng.uniform(0, 3))
            obs.append((dt, "burn", "m", str(rng.choice(["interactive", "batch"])),
                        short, long))
    return obs


def run(health, flight, metrics, obs, min_interval_s=20.0) -> dict:
    clock = Clock()
    scope = metrics.MetricsScope()
    rec = flight.FlightRecorder(capacity=64)
    mon = health.HealthMonitor(clock=clock, min_interval_s=min_interval_s, drift_ratio=2.0,
                               metrics=scope, flight_recorder=rec)
    seen = []
    sub = mon.subscribe(lambda ev: seen.append(ev.to_dict()))
    returned = []
    for o in obs:
        clock.t += o[0]
        if o[1] == "step":
            ev = mon.observe_step(o[2], o[3], o[4], phase=o[5])
        elif o[1] == "wire":
            ev = mon.observe_wire(o[2], o[3])
        elif o[1] == "hit":
            ev = mon.observe_hit_rate(o[2], o[3])
        else:
            ev = mon.observe_burn(o[2], o[3], o[4], o[5])
        returned.append(None if ev is None else ev.to_dict())
    sub.close()
    timelines = {}
    for flight_doc in rec.snapshot(limit=64)["requests"]:
        timelines[flight_doc["request_id"]] = [e["event"] for e in flight_doc["events"]]
    text = scope.expose().decode()
    counter = sorted(ln for ln in text.splitlines()
                     if ln.startswith("dtpu_health_events_total{"))
    return {"returned": returned, "subscribed": seen, "active": mon.active(),
            "counts": mon.counts, "snapshot": mon.snapshot(), "timelines": timelines,
            "counter": counter}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_detectors_emit_the_references_events_on_one_feed(seed):
    obs = feed(seed)
    ref = run(jhealth, jflight, jmetrics, obs)
    port = run(thealth, tflight, tmetrics, obs)
    assert port == ref
    # the feed reaches trips and recoveries on several detectors
    kinds = {(e["detector"], e["kind"]) for e in port["subscribed"]}
    assert ("cost_model_drift", "degraded") in kinds
    assert ("cost_model_drift", "recovered") in kinds
    assert len({d for d, _ in kinds}) >= 3


@pytest.mark.parametrize("interval", [0.0, 5.0, 1e9])
def test_rate_limit_spacing_matches(interval):
    """A steady over-threshold drift stream: re-emission only past the
    per-subject interval (never with an infinite one), in both packages."""
    obs = [(1.0, "step", "worker/1", 0.05, 0.01, "decode")] * 60
    ref = run(jhealth, jflight, jmetrics, obs, min_interval_s=interval)
    port = run(thealth, tflight, tmetrics, obs, min_interval_s=interval)
    assert port == ref
    n = len(port["subscribed"])
    assert n == (58 if interval == 0.0 else 12 if interval == 5.0 else 1)


def test_check_burn_sweeps_the_accountant_as_the_reference():
    """check_burn over an SloAccountant fed the same misses on one clock."""
    out = []
    for health, slo in ((jhealth, jslo), (thealth, tslo)):
        clock = Clock()
        acct = slo.SloAccountant(clock=clock, objective=0.9)
        spec = slo.SlaSpec("interactive", 0.5, 0.05)
        mon = health.HealthMonitor(clock=clock, min_interval_s=0.0,
                                   flight_recorder=(jflight if health is jhealth
                                                    else tflight).FlightRecorder())
        events = []
        for i in range(900):
            clock.t += 5.0
            # an hour of mostly met requests, then a minute of misses
            ttft = 0.1 if i < 880 else 3.0
            acct.record("m", spec, ttft_s=ttft, itl_s=0.01, output_tokens=4, e2e_s=1.0)
            events += [e.to_dict() for e in mon.check_burn(acct)]
        out.append((events, mon.snapshot()))
    assert out[1] == out[0]
    assert any(e["detector"] == "burn_rate_accel" for e in out[1][0])


def test_broken_subscriber_and_close_as_the_reference():
    got = []
    for health, flight in ((jhealth, jflight), (thealth, tflight)):
        clock = Clock()
        mon = health.HealthMonitor(clock=clock, flight_recorder=flight.FlightRecorder())
        seen = []

        def broken(ev):
            raise RuntimeError("event plane hiccup")

        bad = mon.subscribe(broken)
        good = mon.subscribe(lambda ev: seen.append(ev.kind))
        for _ in range(3):
            clock.t += 1
            mon.observe_step("w", 1.0, 0.1)
        good.close()
        bad.close()
        for _ in range(40):
            clock.t += 1
            mon.observe_step("w", 0.01, 0.1)
        got.append((seen, mon.counts, mon.active()))
    assert got[1] == got[0] == (["degraded"], {"cost_model_drift": 2}, [])


def rows_of(seed: int) -> list:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(int(rng.integers(1, 12))):
        q = int(rng.choice([0, 1, 1, 5, 64, 2048]))
        s = int(rng.integers(0, 9000))
        w = int(rng.choice([0, 0, 128, 1024]))
        rows.append((q, max(s, q), w) if w else (q, max(s, q)))
    return rows


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("quantized", [False, True])
def test_step_floor_equals_the_references(seed, quantized):
    rows = rows_of(seed)
    geo = dict(block_size=16, kv_heads=8, num_heads=32, head_dim=128,
               kv_itemsize=1 if quantized else 2, quantized=quantized)
    assert (tcosts.unified_attention_bytes(rows, **geo)
            == jcosts.unified_attention_bytes(rows, **geo))
    for consts in (dict(hbm_bytes_s=3.35e12, dispatch_s=2e-5, weight_bytes=16_060_522_496,
                        layers=32),
                   dict(hbm_bytes_s=8.0e11, dispatch_s=5e-3, layers=32),
                   dict(hbm_bytes_s=0.0, weight_bytes=-5)):
        assert (tcosts.predict_step_seconds(rows, **geo, **consts)
                == jcosts.predict_step_seconds(rows, **geo, **consts))


def test_the_workers_predictor_prices_the_card_and_n_passes():
    """engine/__main__.step_predictor: one pass of a decode step is the
    model's weight stream over the card's rate plus its pages and the
    measured dispatch; a horizon of N steps is N of them."""
    from types import SimpleNamespace

    import torch

    from dynamo_tpu_torch.engine.__main__ import HBM_BYTES_S, step_predictor
    from dynamo_tpu_torch.engine.telemetry import StepStats
    from dynamo_tpu_torch.models.llama import LlamaConfig

    m = LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=16, intermediate_size=128)
    params = {"w": torch.zeros(1000, dtype=torch.bfloat16)}
    engine = SimpleNamespace(mcfg=m, params=params, schedule={"rtt_s": 1e-4},
                             kv_quantized=False)
    predict = step_predictor(engine, SimpleNamespace(block_size=4))
    stats = StepStats(phase="decode", duration_s=0.01, batch_occupancy=2, batch_size=4,
                      tokens=8, queue_depth=0, kv_active_blocks=10, kv_free_blocks=50,
                      kv_total_blocks=64)
    one = jcosts.predict_step_seconds(
        [(1, 20)] * 2, block_size=4, kv_heads=2, num_heads=4, head_dim=16, layers=2,
        hbm_bytes_s=3.35e12, dispatch_s=1e-4, weight_bytes=2000)
    assert HBM_BYTES_S == 3.35e12
    assert predict(stats) == one
    assert predict(dataclasses.replace(stats, passes=8)) == 8 * one
