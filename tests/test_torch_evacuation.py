"""Evacuation plans in the port (``TorchEngine._evacuation_plan``, the
evacuation replay of llm/migration.py, ``_evacuation_costs`` of
llm/discovery.py) against the reference's, on the CPU.

- An ``engine.step`` fault mid-decode: every error frame carries the plan
  (the transfer address, the request's full-block hashes, their tokens,
  ``tier``, the block bytes), and the plan is the one the reference's
  ``_evacuation_plan`` gives for the same request state; no plan without
  a transfer server, for a ``no_cache`` request or without a full block.
- ``_evacuation_costs`` equals the reference's on the same bandwidth state
  and recompute prior.
- Two port engines with a G2 tier: the first crashes mid-decode, and the
  Migration's replay sends the request to the second with the plan as its
  ``kv_transfer``; the second pulls the first's host tier (a tier pull),
  the flight record says ``evacuated=True``, and the stream is the JAX
  engine's greedy one.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest

from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm import discovery as jdiscovery
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.runtime import bandwidth as jbandwidth
from dynamo_tpu.tokens import TokenBlockSequence as JTokenBlockSequence
from dynamo_tpu_torch.kvbm.pool import KvbmTiers
from dynamo_tpu_torch.llm import discovery as tdiscovery
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.runtime import bandwidth as tbandwidth
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.flight_recorder import get_flight_recorder
from dynamo_tpu_torch.tokens import TokenBlockSequence, compute_sequence_hashes
from torch_feature_engines import Weights, collect, request, tokens
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
BS = 4
ENGINE = dict(num_blocks=128, block_size=BS, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64))
PROMPT = tokens(31, 50, 256)   # 12 full blocks and 2 tokens
N_OUT = 40


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("DTPU_ICI_TRANSFER", "0")
    monkeypatch.setenv("DTPU_DEVICE_TRANSFER", "0")
    FAULTS.disarm()
    yield
    FAULTS.disarm()


@pytest.fixture(scope="module")
def weights():
    return Weights(MODEL)


def _port_engine(weights, g2: bool = False):
    e = weights.torch_engine(ENGINE, decode_steps=1, decode_pipeline=1)
    if g2:
        e.kvbm = KvbmTiers(e.kv_bytes_per_block, host_capacity_bytes=1 << 22)
    return e


async def _crash_after(engine, req, n_tokens: int):
    """Stream ``req``; after ``n_tokens`` tokens arm an ``engine.step``
    fault on the next tick. Returns (tokens before the error, the error
    frame)."""
    got = []
    async for out in engine.generate(req, Context()):
        got += out.token_ids
        if out.finish_reason is not None:
            return got, out
        if len(got) >= n_tokens and not FAULTS.armed:
            FAULTS.arm("engine.step:fail@1")
    raise AssertionError("the stream ended without a finish")


def test_an_engine_step_fault_carries_the_references_plan(weights):
    async def main():
        eng = _port_engine(weights)
        ref = weights.jax_engine(ENGINE)
        try:
            addr = await eng.serve_transfer()
            got, frame = await _crash_after(eng, request(False, "e", PROMPT, N_OUT), 5)
            assert frame.finish_reason == "error" and 5 <= len(got) < N_OUT
            plan = frame.annotations["evacuation"]
            # the reference's plan for the same request state
            ref.transfer_address = addr
            st = SimpleNamespace(seq=JTokenBlockSequence(PROMPT + got, BS),
                                 req=SimpleNamespace(token_ids=PROMPT), produced=len(got),
                                 no_cache=False)
            assert plan == TpuEngine._evacuation_plan(ref, st)
            blocks = (len(PROMPT) + len(got)) // BS
            assert plan == {"address": addr, "num_tokens": blocks * BS, "tier": True,
                            "hashes": [int(h) for h in compute_sequence_hashes(
                                PROMPT + got, BS)][:blocks],
                            "bytes_per_block": eng.kv_bytes_per_block}
            # and the reference engine's own crash carries the same shape
            from dynamo_tpu.runtime import Context as JContext
            from dynamo_tpu.runtime.faults import FAULTS as JFAULTS

            jaddr = await ref.serve_transfer()
            jgot = []
            try:
                async for out in ref.generate(request(True, "j", PROMPT, N_OUT), JContext()):
                    jgot += out.token_ids
                    if out.finish_reason is not None:
                        jframe = out
                        break
                    if len(jgot) >= 5 and not JFAULTS.armed:
                        JFAULTS.arm("engine.step:fail@1")
            finally:
                JFAULTS.disarm()
            jplan = jframe.annotations["evacuation"]
            jblocks = (len(PROMPT) + len(jgot)) // BS
            assert jplan["address"] == jaddr and jplan["num_tokens"] == jblocks * BS
            assert jplan["hashes"] == [int(h) for h in compute_sequence_hashes(
                PROMPT + jgot, BS)][:jblocks]
            assert jplan["bytes_per_block"] == plan["bytes_per_block"]
        finally:
            eng.stop()
            ref.stop()

    asyncio.run(main())


@pytest.mark.parametrize("case", ["no_transfer_server", "no_cache", "no_full_block"])
def test_no_plan_when_nothing_is_fetchable(weights, case):
    async def main():
        eng = _port_engine(weights)
        try:
            if case != "no_transfer_server":
                await eng.serve_transfer()
            prompt = PROMPT[:2] if case == "no_full_block" else PROMPT
            st = SimpleNamespace(seq=TokenBlockSequence(prompt, BS),
                                 req=request(False, "n", prompt, 1), produced=0,
                                 no_cache=case == "no_cache")
            return eng._evacuation_plan(st)
        finally:
            eng.stop()

    assert asyncio.run(main()) is None


def test_evacuation_costs_equal_the_references(monkeypatch):
    """The same instances (wire classes, dp ranks), bandwidth observations
    and recompute prior: the same costs a candidate."""
    monkeypatch.setenv("DTPU_PREFILL_BLOCK_MS", "10")
    obs = [("native", 40_000_000, 0.02), ("native", 60_000_000, 0.02),
           ("inline", 5_000_000, 0.5)]
    meta = {1: {"kv_wire": "native"}, 2: {"kv_wire": "inline", "data_parallel_size": 2},
            3: {}, 4: {"kv_wire": "tcp"}}
    plan = {"address": "x", "hashes": list(range(37)), "tier": True,
            "bytes_per_block": 2 * 1024 * 1024}
    costs = {}
    for name, discovery, card, common, bw in (
            ("port", tdiscovery, tcard, tcommon, tbandwidth),
            ("reference", jdiscovery, jcard, jcommon, jbandwidth)):
        est = bw.WireBandwidthEstimator()
        for w, b, s in obs:
            est.observe(w, b, s)
        monkeypatch.setattr(bw, "_estimator", est)
        p = discovery.ModelPipeline(None, card.ModelDeploymentCard(name="m"))
        inst = {i: SimpleNamespace(metadata=dict(m)) for i, m in meta.items()}
        req = common.PreprocessedRequest(request_id="c", model="m", token_ids=[1],
                                         kv_transfer=dict(plan))
        got = p._evacuation_costs(req, inst, [3])
        costs[name] = {(w.worker_id, w.dp_rank): c for w, c in got.items()}
        assert p._evacuation_costs(common.PreprocessedRequest(
            request_id="c", model="m", token_ids=[1]), inst, []) is None
    assert costs["port"] == costs["reference"]
    assert sorted(costs["port"]) == [(1, 0), (2, 0), (2, 1), (4, 0)]


def test_a_crashed_workers_request_finishes_elsewhere_through_a_tier_pull(weights):
    async def main():
        a, b = _port_engine(weights, g2=True), _port_engine(weights, g2=True)
        ref = weights.jax_engine(ENGINE)
        try:
            want = (await collect(ref, request(True, "g", PROMPT, N_OUT)))["tokens"]
            a_addr = await a.serve_transfer()
            await b.serve_transfer()
            prompt_hashes = [int(h) for h in compute_sequence_hashes(PROMPT, BS)]
            sent = []

            class _Direct:
                """One engine's stream as the request plane hands it over."""

                def __init__(self, engine, req, iid):
                    self.instance_id, self._engine, self._req = iid, engine, req

                async def _items(self):
                    got = 0
                    async for out in self._engine.generate(self._req, Context()):
                        got += len(out.token_ids)
                        yield out
                        if self._engine is a and got >= 3 and not FAULTS.armed:
                            # the prompt's blocks in A's host tier first
                            for _ in range(2000):
                                if all(a.kvbm.get_block(h) is not None
                                       for h in prompt_hashes):
                                    break
                                await asyncio.sleep(0.001)
                            FAULTS.arm("engine.step:fail@1")

                def __aiter__(self):
                    return self._items()

            async def send(req, context, excluded):
                sent.append((req.kv_transfer, list(req.prior_token_ids)))
                return _Direct(*((a, req, 1) if 1 not in excluded else (b, req, 2)))

            req = request(False, "evac", PROMPT, N_OUT)
            out = []
            async for item in Migration(send, migration_limit=1).generate(req, Context()):
                out += item.token_ids
            pulls = b._get_transfer_client().pulls
            return want, out, sent, list(pulls), a_addr
        finally:
            for e in (a, b, ref):
                e.stop()

    want, got, sent, pulls, a_addr = asyncio.run(main())
    assert got == want
    (first_plan, _), (plan, prior) = sent
    assert first_plan is None and plan["tier"] and plan["address"] == a_addr
    assert 3 <= len(prior) < N_OUT and plan["num_tokens"] >= 12 * BS
    (pull,) = pulls
    assert pull["tier"] and pull["wire"] == "tier" and pull["address"] == a_addr
    assert pull["tokens"] >= 12 * BS   # at least the prompt's full blocks
    events = get_flight_recorder().timeline("evac")["events"]
    migration = [e["event"] for e in events if e["event"]["kind"] == "migration"]
    assert migration and migration[0]["evacuated"] is True
    assert np.all(np.asarray(got) == np.asarray(want))


def test_the_fault_admin_endpoint_arms_points_anew():
    """``POST /debug/faults`` (the worker's status port with
    ``DTPU_FAULTS_ADMIN=1``): the spec's points are disarmed and armed
    again, their call counts from 0; a bad spec is a 400."""
    from dynamo_tpu_torch.engine.__main__ import arm_faults

    async def post(spec):
        return await arm_faults(SimpleNamespace(json=lambda: {"spec": spec}))

    FAULTS.arm("engine.step:fail@5")
    asyncio.run(FAULTS.ainject("engine.step"))   # call 1 of the old rule
    resp = asyncio.run(post("engine.step:fail@1"))
    assert resp.status == 200
    with pytest.raises(Exception, match="injected failure at engine.step"):
        asyncio.run(FAULTS.ainject("engine.step"))   # call 1 of the new rule
    assert asyncio.run(post("engine.step:explode")).status == 400


def _wait_line(proc, prefix, timeout=90.0):
    import time

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"exited ({proc.poll()}) before {prefix}")
        if line.startswith(prefix):
            return line.strip()
    raise AssertionError(f"no {prefix} in {timeout} s")


def test_a_dead_workers_host_tier_serves_its_evacuation_across_processes(tmp_path):
    """Two worker processes with G2 tiers: A's loop dies mid-decode (armed
    over its status port); the Migration's retry on B pulls A's host tier,
    which A serves until its transfer endpoint is idle, then exits 0."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request

    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "DTPU_GLOBAL_KV": "1"}
    procs = []

    def start(*args, extra=None):
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=str(tmp_path),
                             env={**env, **(extra or {})}, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    worker = ("dynamo_tpu_torch.engine", "--preset", "tiny", "--device", "cpu",
              "--max-context", "512", "--num-blocks", "128", "--block-size", "4",
              "--kvbm-host-gb", "0.01", "--system-port", "0")
    prompt = tokens(41, 90, 256)
    try:
        store = start("dynamo_tpu_torch.runtime.discovery.netstore", "--host", "127.0.0.1",
                      "--port", "0")
        addr = _wait_line(store, "KVSTORE_READY").split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        a = start(*worker, *common, "--model", "m", extra={"DTPU_FAULTS_ADMIN": "1"})
        b = start(*worker, *common, "--model", "m-b", "--component", "backend_b")
        a_transfer = _wait_line(a, "KV_TRANSFER at").split()[-1]
        a_status = int(_wait_line(a, "TORCH_STATUS_ADDRESS").rsplit(":", 1)[1])
        _wait_line(a, "TORCH_ENGINE_READY")
        _wait_line(b, "TORCH_ENGINE_READY")

        async def main():
            rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                        event_plane="inproc")).start()
            try:
                ns = rt.namespace("dynamo")
                ca = await ns.component("backend").endpoint("generate").client()
                cb = await ns.component("backend_b").endpoint("generate").client()
                await ca.wait_for_instances(1)
                await cb.wait_for_instances(1)
                a_id = ca.instance_ids()[0]
                clean = []
                async for it in await ca.generate(
                        request(False, "clean", prompt, N_OUT, ignore_eos=True).to_obj()):
                    clean += it.get("token_ids", [])
                await asyncio.sleep(0.5)   # A's offloads into its host tier

                async def send(r, ctx, excluded):
                    if a_id in excluded:
                        return await cb.generate(r.to_obj(), ctx)
                    stream = await ca.generate(r.to_obj(), ctx, a_id)

                    class Arming:
                        instance_id = stream.instance_id

                        def __aiter__(self):
                            return self._items()

                        async def _items(self):
                            armed = False
                            async for item in stream:
                                yield item
                                if not armed and item.get("token_ids"):
                                    armed = True
                                    body = json.dumps({"spec": "engine.step:fail@1"}).encode()
                                    await asyncio.to_thread(urllib.request.urlopen, (
                                        urllib.request.Request(
                                            f"http://127.0.0.1:{a_status}/debug/faults",
                                            data=body, method="POST")))

                    return Arming()

                got = []
                req = request(False, "evac-procs", prompt, N_OUT, ignore_eos=True)
                async for out in Migration(send, migration_limit=1).generate(req, Context()):
                    got += out.token_ids
                return clean, got
            finally:
                await rt.shutdown()

        clean, got = asyncio.run(main())
        assert got == clean and len(got) == N_OUT
        assert a.wait(30) == 0   # A left on its own once its endpoint went idle
        events = [e["event"] for e in get_flight_recorder().timeline("evac-procs")["events"]]
        assert [e["evacuated"] for e in events if e["kind"] == "migration"] == [True]
        b.send_signal(signal.SIGTERM)
        report = json.loads(_wait_line(b, "TORCH_ENGINE_EXIT").split(" ", 1)[1])
        (pull,) = report["transfer"]["client"]["pulls"]
        assert pull["tier"] and pull["address"] == a_transfer and pull["tokens"] >= 88
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
