"""Disaggregated prefill/decode in the port against the reference, on the
CPU (the reference's tests/test_disagg.py and the planning half of
tests/test_streamed_transfer.py, for both packages).

- Disagg = aggregated = JAX: a port prefill engine and a port decode
  engine behind the port's discovery and PrefillRouter give the greedy
  stream of an aggregated port engine, and of the reference's
  disaggregated pair on the same weights (its engines, discovery and
  router), sequential and streamed, for llama bf16, llama on an int8 cache
  and gpt-oss. The sequential runs take the in-process mover, the
  streamed ones the wire. The decode engine imported the prompt's blocks
  (its prefix cache holds them and the request reports them cached).
- Deflection and routing: a short prompt deflects (no transfer; the
  prefill engine never saw it); with no prefill pool the request takes
  the aggregated path; a prefill pool card that appears and goes attaches
  and detaches the router; ``plan`` on the reference's inputs gives the
  reference's decisions; a terminal prefill error reaches the caller.
- The decode side's events: after an import through a KV-routed frontend,
  the router's view of the decode worker equals its prefix cache, and the
  prefill pool's events and load reports (its component extends the
  decode pool's) stay out of it.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm import ModelDeploymentCard as JCard
from dynamo_tpu.llm import ModelManager as JManager
from dynamo_tpu.llm import ModelWatcher as JWatcher
from dynamo_tpu.llm import register_llm as jregister
from dynamo_tpu.llm.model_card import MODEL_TYPE_PREFILL as J_PREFILL
from dynamo_tpu.llm.prefill_router import DisaggConfig as JDisaggConfig
from dynamo_tpu.llm.prefill_router import PrefillRouter as JPrefillRouter
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols.common import StopConditions as JStop
from dynamo_tpu.models import gptoss as jgptoss
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu.runtime import DistributedRuntime as JRuntime
from dynamo_tpu.runtime import InProcEventPlane as JPlane
from dynamo_tpu.runtime import MemKVStore as JStore
from dynamo_tpu.runtime import RouterMode as JRouterMode
from dynamo_tpu.runtime import RuntimeConfig as JRuntimeConfig
from dynamo_tpu.runtime.bandwidth import WireBandwidthEstimator as JEstimator
from dynamo_tpu_torch import kv_router as T
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kv_router import KvRouterConfig, WorkerWithDpRank
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.model_card import MODEL_TYPE_PREFILL, ModelDeploymentCard
from dynamo_tpu_torch.llm.prefill_router import DisaggConfig, PrefillRouter
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.models import gptoss as tgptoss
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.runtime import (
    Context,
    DistributedRuntime,
    InProcEventPlane,
    MemKVStore,
    RouterMode,
    RuntimeConfig,
)
from dynamo_tpu_torch.runtime.bandwidth import WireBandwidthEstimator
from dynamo_tpu_torch.runtime.flight_recorder import get_flight_recorder
from dynamo_tpu_torch.runtime.request_plane.tcp import RequestPlaneError
from dynamo_tpu_torch.tokens import compute_sequence_hashes
from torch_feature_engines import tokens
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

M = "disagg-model"
BS = 4
LLAMA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=64, block_size=BS, max_batch_size=4, max_context=128,
              decode_steps=1, decode_pipeline=1)
PROMPT = tokens(21, 42, 256)     # 10 full blocks and a partial one, two prefill chunks
N_TOKENS = 8


class Model:
    """One tiny model's weights in both packages."""

    def __init__(self, family: str):
        self.family = family
        if family == "gptoss":
            jf32 = jgptoss.GptOssConfig.tiny_gptoss(vocab_size=256)
            self.jcfg, self.tcfg = jf32, tgptoss.GptOssConfig.tiny_gptoss(vocab_size=256)
            f32 = jgptoss.init_params(jax.random.PRNGKey(7), jf32)
            self.jparams = f32
        else:
            jdt, tdt = (jnp.bfloat16, torch.bfloat16) if family == "bf16" else (
                jnp.float32, torch.float32)
            self.jcfg = jllama.LlamaConfig(dtype=jdt, **LLAMA)
            self.tcfg = tllama.LlamaConfig(dtype=tdt, **LLAMA)
            f32 = jllama.init_params(jax.random.PRNGKey(5),
                                     jllama.LlamaConfig(dtype=jnp.float32, **LLAMA))
            self.jparams = jax.tree.map(lambda x: jnp.asarray(x, jdt), f32)
        self.tree = jax.tree.map(np.asarray, f32)
        self.kv = "int8" if family == "int8" else "model"

    def engine(self, jax_side: bool):
        if jax_side:
            cfg = TpuEngineConfig(model=self.jcfg, use_pallas=False, kv_dtype=self.kv,
                                  prefill_buckets=(32, 64, 128), **ENGINE)
            return TpuEngine(cfg, params=self.jparams,
                             mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        cfg = TorchEngineConfig(model=self.tcfg, device="cpu", kv_dtype=self.kv,
                                prefill_buckets=(32, 64, 128), seed=0, **ENGINE)
        return TorchEngine(cfg, params=params_from_numpy(self.tree, self.tcfg, device="cpu"))


def preq(jax_side: bool, rid: str, prompt, n: int = N_TOKENS):
    req, samp, stop = ((JRequest, JSampling, JStop) if jax_side
                       else (PreprocessedRequest, SamplingOptions, StopConditions))
    return req(request_id=rid, model=M, token_ids=list(prompt),
               stop=stop(max_tokens=n, ignore_eos=True), sampling=samp(temperature=0.0))


async def aggregated(model: Model, prompt=PROMPT) -> list:
    engine = model.engine(False)
    try:
        got = []
        async for out in engine.generate(preq(False, "agg", prompt), Context()):
            got.extend(out.token_ids)
        return got
    finally:
        engine.stop()


class Stack:
    """A prefill worker, a decode worker and a frontend of one package, on
    one store and event plane, in this process."""

    def __init__(self, jax_side: bool, model: Model, router_mode=None, prefill_pool=True,
                 kv_events=False):
        self.jax_side, self.model = jax_side, model
        self.router_mode = router_mode
        self.prefill_pool = prefill_pool
        self.kv_events = kv_events

    async def __aenter__(self):
        j = self.jax_side
        store, plane = (JStore(), JPlane()) if j else (MemKVStore(), InProcEventPlane())
        cfg = (JRuntimeConfig if j else RuntimeConfig)(store="mem", event_plane="inproc",
                                                       lease_ttl_s=2.0)
        Runtime = JRuntime if j else DistributedRuntime
        self.rts = [await Runtime(cfg, store=store, event_plane=plane).start()
                    for _ in range(3)]
        prefill_rt, decode_rt, front = self.rts
        Card = JCard if j else ModelDeploymentCard
        register = jregister if j else register_llm
        self.prefill = self.model.engine(j)
        self.decode = self.model.engine(j)
        self.served = []
        if self.kv_events:
            # both pools publish, each under its own component: the decode
            # pool's router must take its own pool's events only
            for engine, rt, comp, wid in ((self.decode, decode_rt, "backend", 2000),
                                          (self.prefill, prefill_rt, "backend_prefill", 2001)):
                engine.kv_publisher = T.KvEventPublisher(rt.event_plane, "dynamo", comp,
                                                         worker_id=wid, block_size=BS)
                engine.metrics_publisher = T.WorkerMetricsPublisher(rt.event_plane, "dynamo",
                                                                    comp, worker_id=wid)
        if self.prefill_pool:
            await self.prefill.serve_transfer()
            self.served.append(await register(prefill_rt, self.prefill, Card(
                name=M, component="backend_prefill",
                model_type=[J_PREFILL if j else MODEL_TYPE_PREFILL], tokenizer="byte",
                kv_block_size=BS, context_length=128), **({} if j else {"instance_id": 2001})))
        self.served.append(await register(decode_rt, self.decode, Card(
            name=M, component="backend", tokenizer="byte", kv_block_size=BS,
            context_length=128), **({} if j else {"instance_id": 2000})))
        self.manager = JManager() if j else ModelManager()
        mode = self.router_mode or (JRouterMode.ROUND_ROBIN if j else RouterMode.ROUND_ROBIN)
        extra = [] if self.router_mode is None else [KvRouterConfig()]
        self.watcher = await (JWatcher if j else ModelWatcher)(front, self.manager, mode,
                                                               *extra).start()
        for _ in range(200):
            pipe = self.manager.get(M)
            if (pipe is not None and pipe.client.instances and (
                    not self.prefill_pool or (pipe.prefill_router is not None
                                              and pipe.prefill_router.has_workers))):
                break
            await asyncio.sleep(0.02)
        self.pipe = self.manager.get(M)
        return self

    async def generate(self, rid: str, prompt=PROMPT) -> dict:
        ctx = JContext() if self.jax_side else Context()
        out = {"tokens": [], "cached": None, "texts": []}
        async for item in self.pipe.generate_tokens(preq(self.jax_side, rid, prompt), ctx):
            out["tokens"].extend(item.token_ids)
            out["texts"].append(item.text)
            ann = item.annotations or {}
            if "cached_tokens" in ann:   # the decode engine's report comes last
                out["cached"] = ann["cached_tokens"]
        return out

    async def __aexit__(self, *exc):
        await self.watcher.stop()
        for s in self.served:
            await s.stop()
        self.prefill.stop()
        self.decode.stop()
        for rt in self.rts:
            await rt.shutdown()


@pytest.fixture(scope="module", params=["bf16", "int8", "gptoss"])
def model(request):
    return Model(request.param)


@pytest.mark.parametrize("mode", ["sequential", "streamed"])
def test_disagg_equals_aggregated_and_the_reference(model, mode, monkeypatch):
    monkeypatch.setenv("DTPU_DEFLECT", "0")
    monkeypatch.setenv("DTPU_STREAM_KV", "1" if mode == "streamed" else "0")
    # sequential: the in-process mover; streamed: the wire
    monkeypatch.setenv("DTPU_ICI_TRANSFER", "1" if mode == "sequential" else "0")
    monkeypatch.setenv("DTPU_DEVICE_TRANSFER", "0")

    async def main():
        gold = await aggregated(model)
        assert len(gold) == N_TOKENS
        async with Stack(False, model) as port:
            got = await port.generate("disagg")
            hashes = compute_sequence_hashes(PROMPT, BS)[: len(PROMPT) // BS]
            # the decode engine imported the prompt's full blocks
            assert len(port.decode.allocator.match_prefix(hashes)) == len(hashes)
            assert got["cached"] == len(hashes) * BS
        async with Stack(True, model) as ref:
            ref_got = await ref.generate("disagg-ref")
        return gold, got, ref_got

    gold, got, ref_got = asyncio.run(main())
    assert got["tokens"] == gold
    assert ref_got["tokens"] == gold
    # every output carries its text; the reference's sequential hop drops
    # the first token's (ROADMAP Queue 3)
    assert all(t is not None for t in got["texts"])
    if mode == "sequential":
        assert ref_got["texts"][0] is None and all(t is not None for t in ref_got["texts"][1:])


def test_a_short_prompt_deflects(monkeypatch):
    monkeypatch.setenv("DTPU_DEFLECT", "1")
    monkeypatch.setenv("DTPU_DEFLECT_MAX_TOKENS", "64")
    model = Model("f32")
    prompt = PROMPT[:30]

    async def main():
        gold = await aggregated(model, prompt)
        async with Stack(False, model) as port:
            got = await port.generate("defl", prompt)
            assert not port.prefill.allocator.match_prefix(
                compute_sequence_hashes(prompt, BS)[:7])   # never prefilled there
            assert got["cached"] == 0                       # nothing transferred
        return gold, got

    gold, got = asyncio.run(main())
    assert got["tokens"] == gold
    kinds = [e["event"]["kind"] for e in get_flight_recorder().timeline("defl")["events"]]
    assert "prefill_deflected" in kinds


def test_no_prefill_pool_takes_the_aggregated_path():
    model = Model("f32")

    async def main():
        gold = await aggregated(model)
        async with Stack(False, model, prefill_pool=False) as port:
            assert port.pipe.prefill_router is None
            got = await port.generate("agg-only")
        return gold, got

    gold, got = asyncio.run(main())
    assert got["tokens"] == gold


def test_the_router_attaches_and_detaches_with_the_prefill_pool():
    model = Model("f32")

    async def main():
        async with Stack(False, model, prefill_pool=False) as port:
            assert port.pipe.prefill_router is None
            await port.prefill.serve_transfer()
            served = await register_llm(port.rts[0], port.prefill, ModelDeploymentCard(
                name=M, component="backend_prefill", model_type=[MODEL_TYPE_PREFILL],
                tokenizer="byte", kv_block_size=BS, context_length=128))
            for _ in range(200):
                if port.pipe.prefill_router is not None and port.pipe.prefill_router.has_workers:
                    break
                await asyncio.sleep(0.02)
            router = port.pipe.prefill_router
            assert router is not None and router.has_workers
            inst = next(iter(router.client.instances.values()))
            assert inst.metadata["transfer_address"] == port.prefill.transfer_address
            assert inst.metadata["kv_wire"] == "inline"
            assert router.card.runtime_config.kv_bytes_per_block == (
                port.prefill.kv_bytes_per_block)
            await served.stop()
            for _ in range(200):
                if port.pipe.prefill_router is None:
                    break
                await asyncio.sleep(0.02)
            assert port.pipe.prefill_router is None

    asyncio.run(main())


def test_plan_gives_the_reference_decisions():
    """The reference's planning cases (deflections, the fast wire winning,
    the load-skew valve) on both routers, plan for plan."""

    class Inst:
        def __init__(self, wire):
            self.metadata = {"data_parallel_size": 1, "transfer_address": f"tcp://stub/{wire}",
                             "kv_wire": wire}

    class Client:
        instances = {1: Inst("inline"), 2: Inst("native")}

    def routers(priors):
        dcfg = dict(streamed=True, deflect=True, deflect_max_tokens=16,
                    deflect_overlap_frac=0.5, deflect_margin=1.0,
                    prefill_block_time_s=0.01, kv_bytes_per_block=1 << 20)
        port = PrefillRouter(runtime=None, card=ModelDeploymentCard(name="m", kv_block_size=4),
                             disagg=DisaggConfig(**dcfg))
        ref = JPrefillRouter(runtime=None, card=JCard(name="m", kv_block_size=4),
                             disagg=JDisaggConfig(**dcfg))
        port.client, ref.client = Client(), Client()
        port.bandwidth = WireBandwidthEstimator(priors=priors)
        ref.bandwidth = JEstimator(priors=priors)
        return port, ref

    fields = ("deflect_reason", "worker_id", "dp_rank", "overlap_blocks", "query_blocks",
              "transfer_address", "wire", "streamed", "est_transfer_s", "hashes")
    long_prompt = list(range(100))
    cases = [({"native": 1e9, "inline": 1e6}, list(range(8)), 0),
             ({"native": 1e9, "inline": 1e6}, long_prompt, 20),
             ({"native": 1e9, "inline": 1e6}, long_prompt, 0),
             ({"native": 1e5, "inline": 1e5}, long_prompt, 0)]
    plans = []
    for priors, prompt, overlap in cases:
        port, ref = routers(priors)
        p = port.plan(preq(False, "r", prompt), decode_overlap_blocks=overlap)
        r = ref.plan(preq(True, "r", prompt), decode_overlap_blocks=overlap)
        assert [getattr(p, f) for f in fields] == [getattr(r, f) for f in fields]
        plans.append(p)
    assert [p.deflect_reason for p in plans] == ["short_prompt", "radix_hit", None, "load_skew"]
    assert plans[2].worker_id == 2 and plans[2].wire == "native" and plans[2].streamed
    assert len(plans[2].hashes) == 25


def test_a_terminal_prefill_error_surfaces_instead_of_a_fallback():
    class StubClient:
        def __init__(self, exc):
            self.exc = exc
            self.instances = {1: object()}

        async def generate(self, obj, context, instance_id=None):
            raise self.exc

        async def stop(self):
            pass

    router = PrefillRouter(runtime=None, card=ModelDeploymentCard(
        name=M, component="prefill", tokenizer="byte", kv_block_size=4, context_length=128))

    async def main():
        router.client = StubClient(RequestPlaneError("prompt exceeds model context",
                                                     code="context_length"))
        with pytest.raises(RequestPlaneError, match="context"):
            await router.run_prefill(preq(False, "terminal", list(range(8))), Context())
        router.client = StubClient(RuntimeError("socket exploded"))
        assert await router.run_prefill(preq(False, "transient", list(range(8))),
                                        Context()) is None

    asyncio.run(main())


def test_the_routers_view_of_the_decode_worker_equals_its_cache(monkeypatch):
    """Imported blocks are committed and published as the decode engine's
    own: through a KV-routed frontend, the router's view of the decode
    worker ends equal to its prefix cache."""
    monkeypatch.setenv("DTPU_DEFLECT", "0")
    monkeypatch.setenv("DTPU_ICI_TRANSFER", "0")
    model = Model("f32")

    async def main():
        async with Stack(False, model, router_mode=RouterMode.KV, kv_events=True) as port:
            for i in range(3):
                await port.generate(f"ev{i}", tokens(30 + i, 38 + 5 * i, 256))
            for _ in range(100):
                if not port.decode._waiting and all(s is None for s in port.decode._slots):
                    break
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.3)
            tree = port.pipe.kv_router.indexer.tree
            view = tree.worker_hashes(WorkerWithDpRank(2000))
            assert view and view == set(port.decode.allocator._by_hash)
            assert port.decode.kv_publisher.counts["stored"] > 0
            # the prefill worker published too, on its own pool's topics
            assert port.prefill.kv_publisher.counts["stored"] > 0
            assert {w.worker_id for w in tree.workers()} == {2000}
            assert {w.worker_id for w in port.pipe.kv_router.scheduler.known_workers()} == {
                2000}

    asyncio.run(main())
