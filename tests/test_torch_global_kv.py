"""Fleet-wide KV reuse in the port (kvbm/directory.py, the tier stream of
engine/transfer.py, the engine's tier plan and directory upkeep,
llm/prefill_router.GlobalKvFetchPlanner) against the reference's, on the
CPU.

- The directory on a MemKVStore, the port's copy of every non-sim test of
  the reference's tests/test_global_kv.py: publish and lookup, dedupe, TTL
  and refresh on an injected clock, unpublish and the lease-less close,
  lease revoke, ``lookup_run`` with exclusion, the fetch-lease lifecycle.
  Entries one package writes, the other reads (the same keys, the same
  codec bytes).
- ``fetch_vs_recompute`` and ``streamed_transfer_model`` equal to the
  reference's on a grid, with the reference's grid gate and shape checks.
- The planner's fetch, recompute and blank-address paths, with the plan
  and the ``global_kv_plan`` flight event the reference's gives; the
  scheduler's ``fetchable`` discount.
- Peer-tier fetches between TorchEngines on the tiny llama (JAX
  ``init_params`` through ``params_from_numpy``): float (with the
  holder's blocks half on its G3 disk tier) and int8, bit-exact pages and
  a greedy stream equal to the JAX TpuEngine's; a float holder feeding an
  int8 cache quantises on the way in; a port client pulls from a
  reference holder's tiers and the reference's client from a port
  holder's. A stream dropped mid-way resumes; a plan naming a dead holder
  recomputes with its lease aborted and no request stuck; a plan naming
  the worker itself is dropped.
- The fault points: an armed ``directory.publish`` leaves the engine loop
  serving, an armed ``directory.lookup`` means no plan, an armed
  ``fetch.peer_tier`` ends in a recompute with the lease aborted.
- The engine's directory upkeep: the blocks a served prompt offloaded are
  advertised (while the loop is parked too) and withdrawn once a tier
  clear drops them.
"""

import asyncio

import pytest
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.kv_router.protocols import OverlapScores as JOverlap
from dynamo_tpu.kv_router.protocols import WorkerWithDpRank as JWorker
from dynamo_tpu.kv_router.scheduler import KvScheduler as JScheduler
from dynamo_tpu.kvbm import directory as jdirectory
from dynamo_tpu.kvbm.pool import KvbmTiers as JKvbmTiers
from dynamo_tpu.llm.prefill_router import GlobalKvFetchPlanner as JPlanner
from dynamo_tpu.ops import costs as jcosts
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu.runtime.bandwidth import WireBandwidthEstimator as JBandwidth
from dynamo_tpu.runtime.discovery.store import MemKVStore as JMemKVStore
from dynamo_tpu_torch.engine import transfer as ttransfer
from dynamo_tpu_torch.kv_router.protocols import OverlapScores, WorkerWithDpRank
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler
from dynamo_tpu_torch.kvbm import directory as tdirectory
from dynamo_tpu_torch.kvbm.pool import KvbmTiers
from dynamo_tpu_torch.llm.prefill_router import GlobalKvFetchPlanner
from dynamo_tpu_torch.ops import costs as tcosts
from dynamo_tpu_torch.runtime import Context, MemKVStore
from dynamo_tpu_torch.runtime.bandwidth import WireBandwidthEstimator
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.flight_recorder import get_flight_recorder
from dynamo_tpu_torch.tokens import compute_sequence_hashes
from test_torch_transfer import port_pages, ref_pages
from torch_feature_engines import Weights, collect, request, tokens
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def mkdir(store, holder, clock, mod=tdirectory, **kw):
    kw.setdefault("ttl_s", 60.0)
    kw.setdefault("dedupe_replicas", 2)
    return mod.GlobalKvDirectory(store, holder, clock=clock, **kw)


def run(coro):
    return asyncio.run(coro)


def _events(rid: str) -> list:
    return [e["event"] for e in get_flight_recorder().timeline(rid)["events"]]


@pytest.fixture(autouse=True)
def _wire_only(monkeypatch):
    """Engines of one process would take the in-process mover; the tier
    stream is a wire of its own, and the reference's device path is off."""
    monkeypatch.setenv("DTPU_ICI_TRANSFER", "0")
    monkeypatch.setenv("DTPU_DEVICE_TRANSFER", "0")
    FAULTS.disarm()
    yield
    FAULTS.disarm()


# ---------------------------------------------------------------------------
# the directory on a MemKVStore
# ---------------------------------------------------------------------------


def test_publish_lookup_roundtrip():
    async def main():
        store, clock = MemKVStore(), FakeClock()
        d = mkdir(store, "w1", clock, address="w1:7070")
        assert await d.publish([10, 11, 12], "g2") == 3
        assert d.published_count == 3
        assert await d.publish([10, 11], "g2") == 0   # the same tier: a no-op
        assert await d.publish([10], "g3") == 1       # a tier change re-writes
        (e,) = await d.lookup(10)
        assert (e.holder, e.tier, e.fmt, e.address) == ("w1", "g3", "model", "w1:7070")
        assert await d.lookup(999) == []

    run(main())


def test_dedupe_bounds_holders():
    async def main():
        store, clock = MemKVStore(), FakeClock()
        ds = [mkdir(store, f"w{i}", clock, dedupe_replicas=2) for i in range(3)]
        for d in ds:
            await d.publish([42], "g2")
        assert [d.published_count for d in ds] == [1, 1, 0]
        assert ds[2].dedupe_skipped == 1
        assert len(await ds[0].lookup(42)) == 2

    run(main())


def test_ttl_ages_out_entries_and_refresh_restamps():
    async def main():
        store, clock = MemKVStore(), FakeClock()
        d = mkdir(store, "w1", clock, ttl_s=30.0)
        await d.publish([7], "g2")
        clock.t = 29.0
        assert len(await d.lookup(7)) == 1
        clock.t = 31.0
        assert await d.lookup(7) == []
        assert await d.refresh() == 1
        assert len(await d.lookup(7)) == 1

    run(main())


def test_unpublish_withdraw_and_leaseless_close():
    async def main():
        store, clock = MemKVStore(), FakeClock()
        d = mkdir(store, "w1", clock)
        await d.publish([1, 2, 3], "g2")
        assert await d.unpublish([2, 99]) == 1
        assert d.published_count == 2
        assert await d.withdraw_all() == 2
        assert d.published_count == 0 and await d.lookup(1) == []
        await d.publish([4], "g2")
        await d.close()
        assert await d.lookup(4) == []

    run(main())


def test_lease_revoke_deletes_advertisements():
    async def main():
        store, clock = MemKVStore(), FakeClock()
        d = await mkdir(store, "w1", clock).start()
        await d.publish([5, 6], "g2")
        assert len(await d.lookup(5)) == 1 and await d.keep_alive()
        await d.close()
        assert await d.lookup(5) == [] and await d.lookup(6) == []
        assert not await d.keep_alive()

    run(main())


def test_lookup_run_longest_single_holder_and_exclusion():
    async def main():
        store, clock = MemKVStore(), FakeClock()
        a = mkdir(store, "wa", clock, dedupe_replicas=99)
        b = mkdir(store, "wb", clock, dedupe_replicas=99)
        await a.publish([1, 2], "g2")
        await b.publish([1, 2, 3], "g3")
        probe = mkdir(store, "me", clock)
        got = await probe.lookup_run([1, 2, 3, 4])
        assert [e.hash for e in got] == [1, 2, 3] and {e.holder for e in got} == {"wb"}
        got2 = await b.lookup_run([1, 2, 3], exclude_holder="wb")
        assert [e.hash for e in got2] == [1, 2] and got2[0].holder == "wa"
        await a.publish([3], "g2")
        assert {e.holder for e in await probe.lookup_run([1, 2, 3])} == {"wa"}
        assert await probe.lookup_run([]) == []

    run(main())


def test_fetch_lease_lifecycle():
    store, clock = MemKVStore(), FakeClock()
    d = mkdir(store, "w1", clock)
    l1 = d.begin_fetch("peer", [1, 2])
    l2 = d.begin_fetch("peer", [3])
    assert isinstance(l1, tdirectory.FetchLease) and l1.token != l2.token
    assert l1.hashes == [1, 2] and l1.holder == "peer"
    assert d.inflight_fetches == 2
    d.commit_fetch(l1, 2)
    d.abort_fetch(l2)
    assert d.inflight_fetches == 0
    d.abort_fetch(l1)   # discharge is idempotent
    assert d.inflight_fetches == 0


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_entries_one_package_writes_the_other_reads(writer):
    """The same keys and the same codec bytes: a reference directory reads
    a port directory's entries and back, lookups and runs alike."""
    async def main():
        tstore, jstore = MemKVStore(), JMemKVStore()
        clock = FakeClock(5.0)
        wmod, rmod = ((tdirectory, jdirectory) if writer == "port"
                      else (jdirectory, tdirectory))
        wstore, rstore = (tstore, jstore) if writer == "port" else (jstore, tstore)
        w = mkdir(wstore, "worker/7", clock, wmod, address="10.0.0.7:7070")
        await w.publish([2**64 - 1, 5, 6], "g2", "int8")
        # carry the raw bytes across, as one store would hold them
        for k, v in (await wstore.list_prefix("kvdir/")).items():
            await rstore.put(k, v)
        r = mkdir(rstore, "me", clock, rmod)
        (e,) = await r.lookup(2**64 - 1)
        got = await r.lookup_run([5, 6, 8])
        keys = sorted((await rstore.list_prefix("kvdir/")))
        return e, got, keys

    e, got, keys = run(main())
    assert (e.hash, e.holder, e.tier, e.fmt, e.address, e.ts) == (
        2**64 - 1, "worker/7", "g2", "int8", "10.0.0.7:7070", 5.0)
    assert [x.hash for x in got] == [5, 6]
    assert keys == ["kvdir/0000000000000005/worker/7", "kvdir/0000000000000006/worker/7",
                    "kvdir/ffffffffffffffff/worker/7"]


def test_env_switches_are_the_references(monkeypatch):
    for name in ("DTPU_GLOBAL_KV", "DTPU_GLOBAL_KV_TTL_S", "DTPU_GLOBAL_KV_DEDUPE",
                 "DTPU_GLOBAL_KV_FETCH_MARGIN"):
        monkeypatch.delenv(name, raising=False)
    fns = ("directory_enabled", "directory_ttl_s", "directory_dedupe_replicas",
           "fetch_margin")
    assert [getattr(tdirectory, f)() for f in fns] == [getattr(jdirectory, f)() for f in fns]
    monkeypatch.setenv("DTPU_GLOBAL_KV", "1")
    monkeypatch.setenv("DTPU_GLOBAL_KV_TTL_S", "600")
    monkeypatch.setenv("DTPU_GLOBAL_KV_DEDUPE", "0")
    monkeypatch.setenv("DTPU_GLOBAL_KV_FETCH_MARGIN", "1000")
    got = [getattr(tdirectory, f)() for f in fns]
    assert got == [getattr(jdirectory, f)() for f in fns] == [True, 600.0, 1, 1000.0]


# ---------------------------------------------------------------------------
# the cost models
# ---------------------------------------------------------------------------

GRID = [(bw, tier, n, margin) for bw in (2.5e7, 5e8, 2e9, 4e10) for tier in ("g2", "g3")
        for n in (0, 1, 4, 12, 64, 512) for margin in (0.8, 1.0)]


@pytest.mark.parametrize("read_s", [None, 2e-4, 5e-3], ids=["tier-prior", "fast", "slow"])
def test_fetch_vs_recompute_equals_the_reference_on_the_grid(read_s):
    """Explicit tier read priors give the reference's outputs exactly; the
    port's own G2 prior (None for g2) only moves the read term. Wherever
    the port's model fetches, the fetch is within the margin of the
    recompute (the reference's grid gate)."""
    for bw, tier, n, margin in GRID:
        kw = dict(block_size=16, kv_bytes_per_block=2 << 20, bandwidth_bytes_s=bw,
                  prefill_base_s=0.2, prefill_per_token_s=2e-4, tier=tier, margin=margin)
        explicit = read_s if read_s is not None else jcosts.TIER_READ_S_PER_BLOCK[tier]
        t = tcosts.fetch_vs_recompute(n, tier_read_s_per_block=explicit, **kw)
        assert t == jcosts.fetch_vs_recompute(n, tier_read_s_per_block=explicit, **kw)
        v = tcosts.fetch_vs_recompute(n, tier_read_s_per_block=read_s, **kw)
        if v["fetch_wins"]:
            assert v["fetch_s"] <= margin * v["recompute_s"] and n > 0
        if n == 0:
            assert not v["fetch_wins"] and v["fetch_s"] == 0.0


def test_fetch_vs_recompute_shape():
    kw = dict(block_size=16, kv_bytes_per_block=2 << 20, prefill_base_s=0.2,
              prefill_per_token_s=2e-4)
    prev = 0.0
    for n in (1, 2, 8, 32, 128):
        f = tcosts.fetch_vs_recompute(n, bandwidth_bytes_s=2e9, **kw)["fetch_s"]
        assert f >= prev
        prev = f
    g2 = tcosts.fetch_vs_recompute(16, bandwidth_bytes_s=2e9, tier="g2", **kw)
    g3 = tcosts.fetch_vs_recompute(16, bandwidth_bytes_s=2e9, tier="g3", **kw)
    assert g3["fetch_s"] >= g2["fetch_s"] and g2["fetch_wins"]
    slow = tcosts.fetch_vs_recompute(16, bandwidth_bytes_s=1e4, **kw)
    assert not slow["fetch_wins"] and slow["recompute_s"] < slow["fetch_s"]
    # an unknown tier prices as g3, as the reference's
    assert tcosts.fetch_vs_recompute(4, bandwidth_bytes_s=2e9, tier="g9", **kw)["fetch_s"] == \
        tcosts.fetch_vs_recompute(4, bandwidth_bytes_s=2e9, tier="g3", **kw)["fetch_s"]


@pytest.mark.parametrize("prompt", [0, 1, 100, 2048, 6000])
def test_streamed_transfer_model_equals_the_reference(prompt):
    for bw in (5e8, 2e10):
        for window in (1, 8):
            kw = dict(block_size=16, prefill_chunk=2048, kv_bytes_per_block=2 << 20,
                      bandwidth_bytes_s=bw, prefill_chunk_s=0.06, window_blocks=window,
                      handshake_s=0.01, decode_step_s=0.011)
            t = tcosts.streamed_transfer_model(prompt, **kw)
            assert t == jcosts.streamed_transfer_model(prompt, **kw)
            assert t["streamed_ttft_s"] <= t["blocking_ttft_s"]


# ---------------------------------------------------------------------------
# the frontend fetch planner and the scheduler's discount
# ---------------------------------------------------------------------------


def _preq(rid="r1", toks=(1, 2, 3)):
    return request(False, rid, toks, 4, ignore_eos=True)


def _planners(store, jstore, clock, bw, **kw):
    t = GlobalKvFetchPlanner(mkdir(store, "me", clock), bandwidth=WireBandwidthEstimator(
        priors={"tier": bw}), **kw)
    j = JPlanner(mkdir(jstore, "me", clock, jdirectory),
                 bandwidth=JBandwidth(priors={"tier": bw}), **kw)
    return t, j


def test_planner_fetch_plan_and_recompute_paths():
    async def main():
        store, jstore, clock = MemKVStore(), JMemKVStore(), FakeClock()
        hashes = [101, 102, 103, 104]
        for s, mod in ((store, tdirectory), (jstore, jdirectory)):
            await mkdir(s, "peer-1", clock, mod, address="peer:7070").publish(hashes, "g2")
        kw = dict(block_size=16, kv_bytes_per_block=2 << 20, prefill_block_time_s=0.05,
                  prefill_base_s=0.2, margin=1.0)
        planner, ref = _planners(store, jstore, clock, 2e9, **kw)
        req = _preq("plan-1")
        plan = await planner.plan_fetch(req, hashes, overlap_blocks=1)
        want = await ref.plan_fetch(request(True, "plan-1", (1, 2, 3), 4), hashes, 1)
        # the priced fetch differs only by the port's own G2 read prior
        for got, mod in ((plan, tcosts), (want, jcosts)):
            assert got.pop("est_fetch_s") == mod.fetch_vs_recompute(
                3, block_size=16, kv_bytes_per_block=2 << 20, bandwidth_bytes_s=2e9,
                prefill_base_s=0.2, prefill_per_token_s=0.05 / 16)["fetch_s"]
        assert plan == want
        assert plan["hashes"] == hashes[1:] and plan["tier"] is True
        assert (plan["holder"], plan["address"], plan["num_tokens"]) == (
            "peer-1", "peer:7070", 48)
        (ev,) = [e for e in _events("plan-1") if e["kind"] == "global_kv_plan"]
        assert ev["holder"] == "peer-1" and ev["fetch_wins"] and ev["blocks"] == 3
        assert await planner.plan_fetch(req, hashes, 4) is None
        assert await planner.plan_fetch(req, [777, 778], 0) is None
        planner.min_run_blocks = 8
        assert await planner.plan_fetch(req, hashes, 0) is None

    run(main())


def test_planner_declines_on_slow_wire_and_blank_address():
    async def main():
        store, jstore, clock = MemKVStore(), JMemKVStore(), FakeClock()
        for s, mod in ((store, tdirectory), (jstore, jdirectory)):
            await mkdir(s, "peer-1", clock, mod, address="peer:7070").publish(
                [201, 202, 203], "g2")
            await mkdir(s, "peer-2", clock, mod, dedupe_replicas=99).publish([301, 302], "g2")
        slow, jslow = _planners(store, jstore, clock, 1e3, block_size=16,
                                kv_bytes_per_block=2 << 20, prefill_block_time_s=0.05)
        assert await slow.plan_fetch(_preq(), [201, 202, 203], 0) is None
        assert await jslow.plan_fetch(request(True, "r", (1,), 4), [201, 202, 203], 0) is None
        fast, _ = _planners(store, jstore, clock, 2e9, block_size=16,
                            kv_bytes_per_block=2 << 20, prefill_block_time_s=0.05,
                            prefill_base_s=0.2)
        assert await fast.plan_fetch(_preq(), [301, 302], 0) is None

    run(main())


def test_planner_verdicts_follow_the_priors_as_the_references():
    """The same verdict as the reference's planner over a bandwidth and
    per-block prefill grid (explicit priors), and the price's inputs: the
    EWMA of the ``tier`` wire and ``prefill_block_time_s / block_size``."""
    store, jstore, clock = MemKVStore(), JMemKVStore(), FakeClock()
    for bw in (1e8, 5e8, 2e9, 2e10):
        for blk_s in (2e-4, 1e-3, 1e-2):
            kw = dict(block_size=16, kv_bytes_per_block=2 << 20, prefill_block_time_s=blk_s)
            t, j = _planners(store, jstore, clock, bw, **kw)
            for n in (1, 8, 100):
                for tier in ("g2", "g3"):
                    want = j.price(n, tier)
                    got = tcosts.fetch_vs_recompute(
                        n, block_size=16, kv_bytes_per_block=2 << 20, bandwidth_bytes_s=bw,
                        prefill_base_s=0.0, prefill_per_token_s=blk_s / 16, tier=tier,
                        tier_read_s_per_block=jcosts.TIER_READ_S_PER_BLOCK[tier],
                        margin=t.margin)
                    assert got == want
                    assert t.price(n, tier)["recompute_s"] == want["recompute_s"]


def test_the_ports_default_priors_are_the_cards(monkeypatch):
    """The port's recompute and G2 read priors are its measurements on the
    H100 (llama3-8b, 2 MiB bf16 blocks), not the reference's: with them a
    frontend that has not seen the tier wire (the inline prior) recomputes
    a llama3-8b prefix of any length, where the reference's priors fetch
    it; with explicit priors both packages price alike (above)."""
    from dynamo_tpu.llm.prefill_router import DisaggConfig as JDisagg
    from dynamo_tpu_torch.llm.prefill_router import PREFILL_BLOCK_MS, DisaggConfig

    monkeypatch.delenv("DTPU_PREFILL_BLOCK_MS", raising=False)
    assert DisaggConfig.from_env().prefill_block_time_s == PREFILL_BLOCK_MS / 1e3 == 0.0009
    assert JDisagg.from_env().prefill_block_time_s == 0.010
    assert tcosts.TIER_READ_S_PER_BLOCK == {"g2": 1.32e-3, "g3": 2e-3}
    store, jstore, clock = MemKVStore(), JMemKVStore(), FakeClock()
    t, j = _planners(store, jstore, clock, 5e8, block_size=16, kv_bytes_per_block=2 << 20)
    j.prefill_block_time_s = JDisagg.from_env().prefill_block_time_s
    for n in (8, 64, 376):
        assert not t.price(n)["fetch_wins"] and j.price(n)["fetch_wins"]
    # a lone block's handshake and full-window price lose under both
    assert not t.price(1)["fetch_wins"] and not j.price(1)["fetch_wins"]
    monkeypatch.setenv("DTPU_PREFILL_BLOCK_MS", "10")
    assert DisaggConfig.from_env().prefill_block_time_s == 0.010


def test_scheduler_fetchable_discount():
    out = []
    for sched, W, O in ((KvScheduler(), WorkerWithDpRank, OverlapScores),
                        (JScheduler(), JWorker, JOverlap)):
        a, b = W(1, 0), W(2, 0)
        d0 = sched.select_worker([a, b], O({}), query_blocks=10)
        d1 = sched.select_worker([a, b], O({}), query_blocks=10, fetchable={b: 6.0})
        d2 = sched.select_worker([a, b], O({a: 10}), query_blocks=10, fetchable={b: 500.0})
        out.append((d0.worker.worker_id, d1.worker.worker_id, d2.worker.worker_id))
    assert out[0] == out[1] == (1, 2, 1)


# ---------------------------------------------------------------------------
# peer-tier pulls on real engines
# ---------------------------------------------------------------------------

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
BS = 4
ENGINE = dict(num_blocks=96, block_size=BS, max_batch_size=4, max_context=128,
              prefill_buckets=(16, 32), decode_steps=1, decode_pipeline=1)
PROMPT = tokens(31, 96, 256)            # 24 blocks
HASHES = [int(h) for h in compute_sequence_hashes(PROMPT, BS)]
NB = len(PROMPT) // BS
# float32 tiny engine: 4 B x 2 layers x K, V x bs 4 x 2 kv heads x d 16
FLOAT_BLOCK = 2048
INT8_BLOCK = 2 * 2 * BS * 2 * 16 + 2 * 2 * 2 * 4


@pytest.fixture(scope="module")
def weights():
    return Weights(MODEL)


@pytest.fixture(scope="module")
def golden(weights):
    """The JAX TpuEngine's greedy streams of PROMPT (float and int8 caches)."""
    out = {}
    for kv in ("model", "int8"):
        e = weights.jax_engine(ENGINE, kv_dtype=kv)
        try:
            out[kv] = run(collect(e, request(True, "golden", PROMPT, 8, ignore_eos=True)))
        finally:
            e.stop()
    return {k: v["tokens"] for k, v in out.items()}


async def _holder(weights, kv="model", **tiers):
    """A port engine whose KVBM tiers hold PROMPT's sealed blocks, serving
    its transfer endpoint; returns (engine, address)."""
    nbytes = INT8_BLOCK if kv == "int8" else FLOAT_BLOCK
    kvbm = KvbmTiers(nbytes, **{"host_capacity_bytes": 1 << 20, **tiers})
    e = weights.torch_engine(ENGINE, kv_dtype=kv)
    e.kvbm = kvbm
    await collect(e, request(False, "warm", PROMPT, 1, ignore_eos=True))
    await e.flush_offload()
    return e, await e.serve_transfer()


@pytest.mark.parametrize("kv,g3", [("model", False), ("model", True), ("int8", False)],
                         ids=["float", "float-g3", "int8"])
def test_tier_fetch_bit_exact_and_equal_to_jax(weights, golden, kv, g3, tmp_path):
    """A port engine onboards PROMPT's 24 blocks from a port holder's
    tiers (with ``g3``, a host tier of 12 blocks: half on disk), one
    import a window; its pages equal the holder's bit for bit and its
    greedy stream is the JAX engine's."""
    async def main():
        tiers = dict(host_capacity_bytes=12 * FLOAT_BLOCK, disk_capacity_bytes=1 << 20,
                     disk_path=str(tmp_path)) if g3 else {}
        holder, addr = await _holder(weights, kv, **tiers)
        if g3:
            assert len(holder.kvbm.disk) > 0 and len(holder.kvbm.host) > 0
        dst = weights.torch_engine(ENGINE, kv_dtype=kv)
        scatters = []
        real = dst._scatter_blocks
        dst._scatter_blocks = lambda ids, arr, *a, **k: (scatters.append(len(ids)),
                                                          real(ids, arr, *a, **k))[1]
        try:
            client = dst._get_transfer_client()
            got = await client.fetch_and_import(addr, HASHES[:NB], tier=True)
            assert got == NB * BS
            assert port_pages(dst, HASHES[:NB]) == port_pages(holder, HASHES[:NB])
            (pull,) = client.pulls
            assert pull["wire"] == "tier" and pull["windows"] == len(scatters) == 3
            assert scatters == [8, 8, 8] and pull["tier"]
            out = await collect(dst, request(False, "d1", PROMPT, 8, ignore_eos=True))
            return out["tokens"]
        finally:
            dst.stop()
            holder.stop()

    assert run(main()) == golden[kv]


def test_a_float_tier_window_quantises_into_an_int8_cache(weights):
    """Float storage-format blocks into an int8 cache: quantised on the way
    in, the pages equal those of the holder's pages quantised."""
    from dynamo_tpu_torch.ops.quant import quantize_blocks

    async def main():
        holder, addr = await _holder(weights, "model")
        dst = weights.torch_engine(ENGINE, kv_dtype="int8")
        try:
            got = await dst._get_transfer_client().fetch_and_import(addr, HASHES[:NB],
                                                                     tier=True)
            ids = dst.allocator.acquire_prefix(HASHES[:NB])
            src = holder.allocator.acquire_prefix(HASHES[:NB])
            idx, sidx = torch.tensor(ids), torch.tensor(src)
            for layer in range(MODEL["num_layers"]):
                for cache, scache in ((dst.k_caches[layer], holder.k_caches[layer]),
                                      (dst.v_caches[layer], holder.v_caches[layer])):
                    want_q, want_s = quantize_blocks(scache[sidx].float())
                    assert torch.equal(cache.data[idx], want_q)
                    assert torch.equal(cache.scale[idx], want_s)
            return got
        finally:
            dst.stop()
            holder.stop()

    assert run(main()) == NB * BS


@pytest.mark.parametrize("direction", ["port-from-ref", "ref-from-port"])
def test_the_tier_stream_between_packages(weights, direction):
    """The tier stream's frames are the reference's: a port client onboards
    from a reference holder's G2 and the reference's client from a port
    holder's, bit for bit (bf16 storage, as the reference's bf16 blocks)."""
    import jax

    from test_torch_transfer import Pair

    pair = Pair("bf16")
    bf16_block = FLOAT_BLOCK // 2

    async def main():
        if direction == "port-from-ref":
            src = TpuEngine(TpuEngineConfig(model=pair.jcfg, use_pallas=False, **ENGINE),
                            params=pair.jparams,
                            mesh=make_mesh(tp=1, devices=jax.devices()[:1]),
                            kvbm=JKvbmTiers(bf16_block, host_capacity_bytes=1 << 20))
            dst = pair.torch_engine("model")
        else:
            src = pair.torch_engine("model")
            src.kvbm = KvbmTiers(bf16_block, host_capacity_bytes=1 << 20)
            dst = pair.jax_engine("model")
        jax_side = isinstance(src, TpuEngine)
        try:
            req = request(jax_side, "warm", PROMPT, 1, ignore_eos=True)
            async for _ in src.generate(req, JContext() if jax_side else Context()):
                pass
            if jax_side:
                src.kvbm.flush()
                await asyncio.sleep(0.2)
                src.kvbm.flush()
            else:
                await src.flush_offload()
            addr = await src.serve_transfer()
            got = await dst._get_transfer_client().fetch_and_import(addr, HASHES[:NB],
                                                                     tier=True)
            assert got == NB * BS
            if jax_side:
                return port_pages(dst, HASHES[:NB]), ref_pages(src, HASHES[:NB])
            return ref_pages(dst, HASHES[:NB]), port_pages(src, HASHES[:NB])
        finally:
            dst.stop()
            src.stop()

    a, b = run(main())
    assert a == b


def test_a_stream_dropped_mid_way_resumes(weights, golden):
    """An armed ``fetch.peer_tier`` drop on the second call (the first
    window's) kills the stream; the client resumes from its first
    un-imported block and lands every block; the fired schedule is the
    armed one; the stream is still the JAX engine's."""
    async def main():
        holder, addr = await _holder(weights)
        FAULTS.arm("fetch.peer_tier:drop@2")
        plan = FAULTS.plan("fetch.peer_tier", 4)
        dst = weights.torch_engine(ENGINE)
        try:
            n_fired = len(FAULTS.fired)
            got = await dst._get_transfer_client().fetch_and_import(addr, HASHES[:NB],
                                                                     tier=True)
            assert got == NB * BS
            assert len(dst.allocator.match_prefix(HASHES[:NB])) == NB
            assert FAULTS.fired[n_fired:] == [("fetch.peer_tier", "drop", 2)]
            assert (2, "drop") in plan
            FAULTS.disarm()
            out = await collect(dst, request(False, "d1", PROMPT, 8, ignore_eos=True))
            return out["tokens"]
        finally:
            dst.stop()
            holder.stop()

    assert run(main()) == golden["model"]


def _plan(address, holder="worker/1"):
    return {"address": address, "hashes": HASHES[:NB], "num_tokens": NB * BS, "tier": True,
            "holder": holder}


@pytest.mark.parametrize("cause", ["dead-holder", "armed-fetch-fault"])
def test_a_failed_tier_plan_recomputes_with_the_lease_aborted(weights, golden, cause):
    """A plan naming a dead holder (an entry inside its TTL), or one whose
    fetch an armed ``fetch.peer_tier`` fails on every attempt: the engine
    aborts the fetch lease, recomputes the prefill, and the request ends
    in bounded time with the JAX engine's stream; the flight events name
    the holder and the tier."""
    async def main():
        holder = None
        addr = "127.0.0.1:9"
        if cause == "armed-fetch-fault":
            holder, addr = await _holder(weights)
            FAULTS.arm("fetch.peer_tier:fail")
        dst = weights.torch_engine(ENGINE)
        directory = mkdir(MemKVStore(), "me", FakeClock())
        aborted = []
        real = directory.abort_fetch
        directory.abort_fetch = lambda lease: (aborted.append(lease.holder), real(lease))[1]
        dst.kv_directory = directory
        before = ttransfer.transfer_stats.snapshot()["counts"]["recompute"]
        try:
            req = request(False, f"gone-{cause}", PROMPT, 8, ignore_eos=True)
            req.kv_transfer = _plan(addr, "ghost")
            out = await asyncio.wait_for(collect(dst, req), timeout=60)
            assert directory.inflight_fetches == 0 and aborted == ["ghost"]
            assert ttransfer.transfer_stats.snapshot()["counts"]["recompute"] == before + 1
            kinds = {e["kind"]: e for e in _events(req.request_id)}
            assert kinds["fetch_started"]["tier"] is True
            assert kinds["fetch_started"]["holder"] == "ghost"
            assert "fetch_aborted" in kinds
            return out["tokens"]
        finally:
            FAULTS.disarm()
            dst.stop()
            if holder is not None:
                holder.stop()

    assert run(main()) == golden["model"]


def test_a_committed_tier_plan_and_a_plan_naming_itself(weights, golden):
    """Through ``generate``: a tier plan naming a live holder commits its
    lease and serves the prompt from the fetched blocks (the JAX stream); a
    plan whose holder is the worker itself is dropped (no fetch, no
    lease), and its own KVBM tiers onboard the prefix."""
    async def main():
        holder, addr = await _holder(weights)
        dst = weights.torch_engine(ENGINE)
        directory = mkdir(MemKVStore(), "worker/2", FakeClock())
        committed = []
        real = directory.commit_fetch
        directory.commit_fetch = lambda lease, n: (committed.append(n), real(lease, n))[1]
        dst.kv_directory = directory
        try:
            req = request(False, "fetched", PROMPT, 8, ignore_eos=True)
            req.kv_transfer = _plan(addr)
            out = await collect(dst, req)
            assert committed == [NB * BS] and directory.inflight_fetches == 0
            assert out["tokens"] == golden["model"]
            (pull,) = dst._get_transfer_client().pulls
            assert pull["wire"] == "tier" and pull["tokens"] == NB * BS
            # the holder names itself: dropped before any fetch
            holder.kv_directory = mkdir(MemKVStore(), "worker/1", FakeClock())
            req2 = request(False, "self", PROMPT, 8, ignore_eos=True)
            req2.kv_transfer = _plan(addr)
            out2 = await collect(holder, req2)
            events = [e["kind"] for e in _events("self")]
            assert "fetch_started" not in events and out2["tokens"] == golden["model"]
            assert holder._transfer_client is None   # it never pulled
        finally:
            dst.stop()
            holder.stop()

    run(main())


# ---------------------------------------------------------------------------
# the engine's directory upkeep and the directory fault points
# ---------------------------------------------------------------------------


def test_the_upkeep_advertises_offloads_and_withdraws_cleared_blocks(weights):
    """A served prompt's offloaded blocks are advertised (by the parked
    loop too: the offload lands after the last tick) under their tier and
    format at the worker's transfer address; a G1 + G2 clear withdraws
    them."""
    async def main():
        store = MemKVStore()
        e = weights.torch_engine(ENGINE)
        e.kvbm = KvbmTiers(FLOAT_BLOCK, host_capacity_bytes=1 << 20)
        addr = await e.serve_transfer()
        e.kv_directory = tdirectory.GlobalKvDirectory(store, "worker/9", address=addr)
        probe = tdirectory.GlobalKvDirectory(store, "frontend/m")
        try:
            await collect(e, request(False, "p", PROMPT, 1, ignore_eos=True))
            await e.flush_offload()
            for _ in range(100):
                if e.kv_directory.published_count >= NB:
                    break
                await asyncio.sleep(0.05)
            got = await probe.lookup_run(HASHES[:NB])
            assert len(got) == NB and {(x.holder, x.tier, x.fmt, x.address)
                                       for x in got} == {("worker/9", "g2", "model", addr)}
            await e.clear_kv_blocks(["g1", "g2"])
            await asyncio.sleep(1.2)   # a parked upkeep tick withdraws them
            return await probe.lookup_run(HASHES[:NB]), e.kv_directory.published_count
        finally:
            e.stop()

    left, published = run(main())
    assert left == [] and published == 0


def test_an_armed_directory_publish_leaves_the_loop_serving(weights, golden):
    async def main():
        e = weights.torch_engine(ENGINE)
        e.kvbm = KvbmTiers(FLOAT_BLOCK, host_capacity_bytes=1 << 20)
        e.kv_directory = tdirectory.GlobalKvDirectory(MemKVStore(), "worker/3")
        FAULTS.arm("directory.publish:fail")
        try:
            outs = []
            for i in range(2):
                outs.append(await collect(e, request(False, f"a{i}", PROMPT, 8,
                                                     ignore_eos=True)))
                await e.flush_offload()
                await asyncio.sleep(0.6)
            fired = [f for f in FAULTS.fired if f[0] == "directory.publish"]
            return outs, fired, e.kv_directory.published_count, e.healthy
        finally:
            FAULTS.disarm()
            e.stop()

    outs, fired, published, healthy = run(main())
    assert fired and published == 0 and healthy
    assert [o["tokens"] for o in outs] == [golden["model"]] * 2


def test_an_armed_directory_lookup_means_no_plan():
    """In the planner and on the frontend's aggregated path (ModelPipeline:
    a failure in planning means no plan, and the request goes on)."""
    from dynamo_tpu_torch.llm.discovery import ModelPipeline
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.common import BackendOutput

    async def main():
        store, clock = MemKVStore(), FakeClock()
        await mkdir(store, "peer", clock, address="peer:1").publish([1, 2, 3], "g2")
        planner = GlobalKvFetchPlanner(mkdir(store, "me", clock), block_size=16,
                                       kv_bytes_per_block=2 << 20, margin=1e9,
                                       bandwidth=WireBandwidthEstimator())
        assert (await planner.plan_fetch(_preq(), [1, 2, 3], 0))["holder"] == "peer"
        FAULTS.arm("directory.lookup:fail")
        try:
            with pytest.raises(Exception):
                await planner.plan_fetch(_preq(), [1, 2, 3], 0)
            # the pipeline's guard: the request goes out with no plan
            pipe = ModelPipeline.__new__(ModelPipeline)
            pipe.global_kv, pipe.kv_router, pipe.prefill_router = planner, None, None
            pipe.client = None
            pipe.card = ModelDeploymentCard(name="m", kv_block_size=16)
            sent = []

            async def fake_generate(req, context):
                sent.append(req)
                yield BackendOutput(token_ids=[7], finish_reason="stop")

            pipe.migration = type("M", (), {"generate": staticmethod(fake_generate)})()
            req = _preq("lookup-fault", toks=tuple(range(48)))
            got = [x async for x in pipe.generate_tokens(req, Context())]
            assert [o.token_ids for o in got] == [[7]] and sent[0].kv_transfer is None
            assert any(f[0] == "directory.lookup" for f in FAULTS.fired)
        finally:
            FAULTS.disarm()

    run(main())
