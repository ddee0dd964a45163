"""The port's fault-injection plane (dynamo_tpu_torch/runtime/faults.py)
against the reference's (dynamo_tpu/runtime/faults.py).

Each case of tests/test_faults.py runs on the port's registry: spec
parsing, call-indexed and seeded schedules, the sync / async / corrupt
surfaces, disarming, the unarmed fast path and the env reload. Then both
packages' registries are armed with the same specs and called the same
number of times: their ``plan`` and ``fired`` logs must be equal, for fixed
specs and for hypothesis-drawn seeds, probabilities and call counts.
"""

import asyncio
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu_torch.runtime import faults as faults_mod
from dynamo_tpu_torch.runtime.faults import (
    FAULT_POINTS,
    FaultInjected,
    FaultRegistry,
    FaultRule,
    InjectedDrop,
    parse_faults,
    reload_from_env,
)


# -- parsing (tests/test_faults.py) ------------------------------------------

def test_parse_the_docstring_example():
    rules = parse_faults("transfer.pull:drop@2;etcd.watch:delay=0.5@seed=7")
    assert len(rules) == 2
    r0, r1 = rules
    assert (r0.point, r0.action, r0.nth, r0.from_nth) == ("transfer.pull", "drop", 2, False)
    assert (r1.point, r1.action, r1.value, r1.seed) == ("etcd.watch", "delay", 0.5, 7)
    assert r1.prob == 0.5  # a bare seed implies a coin-flip schedule


def test_parse_qualifiers():
    (r,) = parse_faults("a.b:fail@3+")
    assert r.nth == 3 and r.from_nth
    (r,) = parse_faults("a.b:drop@p=0.25@seed=11")
    assert r.prob == 0.25 and r.seed == 11
    (r,) = parse_faults("a.b:hang=2.5")
    assert r.action == "hang" and r.value == 2.5


@pytest.mark.parametrize("bad", [
    "no-colon", "p:unknownaction", "a.b:delay",  # delay without a value
    "a.b:fail@wat", "a.b:drop@p=x",
])
def test_parse_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        parse_faults(bad)
    with pytest.raises(ValueError):
        jfaults.parse_faults(bad)


# -- schedules ---------------------------------------------------------------

def test_nth_call_schedule():
    reg = FaultRegistry()
    reg.arm("p:fail@3")
    reg.inject("p")
    reg.inject("p")
    with pytest.raises(FaultInjected):
        reg.inject("p")
    reg.inject("p")  # only the 3rd call fires
    assert reg.fired == [("p", "fail", 3)]


def test_from_nth_schedule():
    reg = FaultRegistry()
    reg.arm("p:drop@2+")
    reg.inject("p")
    for _ in range(3):
        with pytest.raises(InjectedDrop):
            reg.inject("p")
    assert [i for _, _, i in reg.fired] == [2, 3, 4]


def test_seeded_schedule_is_reproducible():
    def run(seed):
        reg = FaultRegistry()
        reg.arm(f"p:drop@p=0.5@seed={seed}")
        outcomes = []
        for _ in range(40):
            try:
                reg.inject("p")
                outcomes.append(False)
            except InjectedDrop:
                outcomes.append(True)
        return outcomes, reg.fired

    a_out, a_fired = run(7)
    b_out, b_fired = run(7)
    c_out, _ = run(8)
    assert a_out == b_out and a_fired == b_fired  # same seed => same schedule
    assert a_out != c_out                          # another seed differs
    assert any(a_out) and not all(a_out)           # an actual mix


def test_plan_matches_live_fired_log():
    reg = FaultRegistry()
    reg.arm("p:drop@p=0.3@seed=5")
    plan = reg.plan("p", 25)
    for _ in range(25):
        try:
            reg.inject("p")
        except InjectedDrop:
            pass
    assert [(i, a) for _, a, i in reg.fired] == plan


def test_delay_action_sleeps():
    reg = FaultRegistry()
    reg.arm("p:delay=0.05")
    t0 = time.monotonic()
    reg.inject("p")
    assert time.monotonic() - t0 >= 0.04


async def test_async_inject_and_delay():
    reg = FaultRegistry()
    reg.arm("p:delay=0.02;p:drop@2")
    t0 = time.monotonic()
    await reg.ainject("p")
    assert time.monotonic() - t0 >= 0.015
    with pytest.raises(InjectedDrop):
        await reg.ainject("p")


def test_corrupt_uses_its_own_counter():
    reg = FaultRegistry()
    reg.arm("p:corrupt@2;p:drop@1")
    with pytest.raises(InjectedDrop):
        reg.inject("p")           # drop rule: inject counter call 1
    assert reg.mangle("p", b"abc") == b"abc"      # corrupt call 1: no fire
    assert reg.mangle("p", b"abc") != b"abc"      # corrupt call 2: flipped
    assert reg.mangle("p", b"") == b""            # an empty payload unharmed
    assert reg.calls("p") == 1 and reg.calls("p#corrupt") == 3


def test_disarm_clears_everything():
    reg = FaultRegistry()
    reg.arm("p:fail")
    assert reg.armed
    reg.disarm()
    assert not reg.armed
    reg.inject("p")  # no-op
    assert reg.fired == []


def test_disarm_one_point_keeps_the_others():
    reg = FaultRegistry()
    reg.arm("p:fail;q:drop")
    reg.disarm("p")
    reg.inject("p")
    with pytest.raises(InjectedDrop):
        reg.inject("q")
    assert reg.calls("p") == 0 and reg.calls("q") == 1


def test_unarmed_fast_path_costs_nothing():
    reg = FaultRegistry()
    reg.inject("anything")
    assert reg.calls("anything") == 0  # counters untouched when unarmed
    assert reg.mangle("anything", b"x") == b"x"


def test_typed_error_codes():
    assert FaultInjected.code == "fault_injected"
    assert InjectedDrop.code == "fault_drop"
    assert issubclass(InjectedDrop, ConnectionError)  # migration-retryable
    assert FAULT_POINTS == jfaults.FAULT_POINTS


def test_reload_from_env(monkeypatch):
    monkeypatch.setenv("DTPU_FAULTS", "env.point:fail@1")
    reload_from_env()
    try:
        with pytest.raises(FaultInjected):
            faults_mod.FAULTS.inject("env.point")
    finally:
        monkeypatch.delenv("DTPU_FAULTS")
        reload_from_env()
    assert not faults_mod.FAULTS.armed


def test_reload_survives_bad_env_spec(monkeypatch):
    monkeypatch.setenv("DTPU_FAULTS", "not a valid spec !!!")
    reload_from_env()  # must not raise
    assert not faults_mod.FAULTS.armed
    monkeypatch.delenv("DTPU_FAULTS")
    reload_from_env()


def test_rule_fires_at_is_pure():
    r = FaultRule(point="p", action="drop", prob=0.4, seed=9)
    first = [r.fires_at(i) for i in range(1, 30)]
    again = [r.fires_at(i) for i in range(1, 30)]
    assert first == again  # memoised decisions never change


# -- the port's logs against the reference's ----------------------------------

def _drive(mod, spec: str, points: dict) -> tuple:
    """Arm ``spec`` on a fresh registry of ``mod``, call each point its
    count of times through inject, ainject and mangle in turn; (plans,
    fired, outcomes)."""
    reg = mod.FaultRegistry()
    reg.arm(spec)
    plans = {p: reg.plan(p, n) for p, n in points.items()}
    outcomes = []

    async def run():
        for p, n in points.items():
            for i in range(n):
                try:
                    if i % 3 == 0:
                        reg.inject(p)
                    elif i % 3 == 1:
                        await reg.ainject(p)
                    outcomes.append((p, reg.mangle(p, b"\x01payload")))
                except (mod.InjectedDrop, mod.FaultInjected) as e:
                    outcomes.append((p, e.code))

    asyncio.run(run())
    return plans, reg.fired, outcomes


SPECS = [
    "request_plane.send:drop@p=0.3@seed=11",
    "request_plane.send:drop@1;request_plane.send:drop@2;request_plane.send:fail@5+",
    "event_plane.publish:corrupt@p=0.4@seed=2;event_plane.publish:drop@3",
    "discovery.call:drop@seed=9;engine.step:fail@4;request_plane.connect:delay=0@2+",
]
POINTS = {"request_plane.send": 30, "event_plane.publish": 20, "discovery.call": 15,
          "engine.step": 6, "request_plane.connect": 4}


@pytest.mark.parametrize("spec", SPECS)
def test_plans_and_fired_logs_equal_the_reference(spec):
    port = _drive(faults_mod, spec, POINTS)
    ref = _drive(jfaults, spec, POINTS)
    assert port == ref
    assert port[1], "the spec never fired"


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), prob=st.floats(0.0, 1.0),
       calls=st.integers(1, 60), nth=st.integers(1, 20), from_nth=st.booleans())
def test_drawn_schedules_equal_the_reference(seed, prob, calls, nth, from_nth):
    spec = (f"p:drop@p={prob!r}@seed={seed};q:fail@{nth}{'+' if from_nth else ''};"
            f"q:corrupt@seed={seed}")
    assert (_drive(faults_mod, spec, {"p": calls, "q": calls})
            == _drive(jfaults, spec, {"p": calls, "q": calls}))
    reg = FaultRegistry()
    reg.arm(spec)
    ref = jfaults.FaultRegistry()
    ref.arm(spec)
    assert reg.plan("p", calls) == ref.plan("p", calls)
    # plan interrogates clones: the live schedule is untouched
    assert reg.calls("p") == 0 and reg.fired == []
